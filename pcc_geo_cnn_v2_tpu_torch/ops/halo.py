"""Halo-volume D1 partial sums around kernel K2.

Port of ``pcc_geo_cnn_v2_tpu/ops/pallas_halo.py``. For a batch of blocks,
given the query cloud's core grids ``[bs, size, size, size]`` and the
target cloud's 27-neighbourhood halo volumes ``[bs, H, H, H]`` (H = size +
2·halo): the squared EDT of the target, bounded per block by a coarse-grid
shift bound ``kmax``, evaluated at the core query voxels — sum of
dt ≤ halo², query count, outlier count and the packed outlier mask
(:func:`halo_d1_dir`). Only the target needs the halo: the TPU kernel's
query volume carried it as zeros for its fixed tiling.

Bound validity (as in the JAX package): with kmax ≥ every core query
voxel's true in-halo NN distance (clipped to halo), every dt ≤ halo² is
exact and larger values can only be overestimates, which are flagged. The
outputs therefore do not depend on how tight the bound is, only on its
validity — the port computes it on the unpadded H (the TPU padded H to a
multiple of 16 for its lane tiling).

CUDA tensors launch ``csrc/halo_edt.cu``; CPU tensors take
:func:`halo_edt_plain`, the same passes in plain torch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pcc_geo_cnn_v2_tpu_torch.ops import kernels
from pcc_geo_cnn_v2_tpu_torch.ops.edt import banded_squared_edt
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import packbits

__all__ = ["halo_kmax", "halo_edt", "halo_edt_plain", "halo_d1_dir"]

_NONE = 255       # no target within kmax along a column
_INF_I = 1 << 24  # squared distance of _NONE


def halo_kmax(qry, tgt_vol, halo):
    """[bs] int32 per-block shift bound from a coarse-grid EDT: cells of g³
    voxels, nearest target cell at index distance D ⇒ any query in the
    cell is within g·D + (g-1)·√3 of a target.

    :param qry: [bs, size, size, size] core query grids (at offset halo
        inside the [bs, H, H, H] target halo volumes ``tgt_vol``).
    """
    bs, size, H = qry.shape[0], qry.shape[1], tgt_vol.shape[1]
    # largest divisor of H with cells no finer than ~32³
    g = next(d for d in range(max(H // 32, 1), 0, -1) if H % d == 0)
    cs = H // g

    def cell(v):
        c = v.shape[1] // g
        return v.reshape(bs, c, g, c, g, c, g).amax(dim=(2, 4, 6)) > 0

    # the core's cells, placed in the halo volume's cell grid
    lo, c0 = halo % g, halo // g
    hi = -(lo + size) % g
    q = cell(F.pad(qry, (lo, hi) * 3) if lo or hi else qry)
    nq = q.shape[1]
    qcell = torch.zeros(bs, cs, cs, cs, dtype=torch.bool, device=qry.device)
    qcell[:, c0:c0 + nq, c0:c0 + nq, c0:c0 + nq] = q
    edt2c = banded_squared_edt(cell(tgt_vol), min(-(-halo // g) + 1, cs - 1))
    d2max = torch.where(qcell, edt2c, 0.0).amax(dim=(1, 2, 3))
    kmax = torch.ceil(g * torch.sqrt(d2max) + (g - 1) * math.sqrt(3.0))
    return torch.clamp(kmax, 0, halo).to(torch.int32)


def halo_edt_plain(qry, tgt, kmax, size, halo):
    """Plain-torch K2: (sum int64, n int32, unres_cnt int32, unres uint8
    [bs, size³/8]) — the kernel's passes, vectorised over the batch.

    :param qry: [bs, size, size, size] core query grids.
    :param tgt: [bs, H, H, H] target halo volumes.
    """
    bs, H = tgt.shape[0], tgt.shape[1]
    core = slice(halo, halo + size)
    km = kmax.view(bs, 1, 1, 1)
    kk = int(kmax.max()) if bs else 0
    # z pass: 1-D distance to the nearest target within kmax (axis 1)
    t = tgt > 0
    d = torch.where(t, 0, _NONE).to(torch.int32)
    for k in range(1, kk + 1):
        hit = torch.zeros_like(t)
        hit[:, :-k] |= t[:, k:]
        hit[:, k:] |= t[:, :-k]
        d = torch.where(hit & (d == _NONE) & (k <= km), k, d)
    d = d[:, core]
    g = torch.where(d == _NONE, _INF_I, d * d)

    def minplus(g, axis):
        out = g.clone()
        L = g.shape[axis]
        for k in range(1, kk + 1):
            ok = k <= km
            lo = g.narrow(axis, k, L - k) + k * k   # g[i + k] → out[i]
            hi = g.narrow(axis, 0, L - k) + k * k   # g[i - k] → out[i]
            o_lo = out.narrow(axis, 0, L - k)
            o_lo.copy_(torch.where(ok, torch.minimum(o_lo, lo), o_lo))
            o_hi = out.narrow(axis, k, L - k)
            o_hi.copy_(torch.where(ok, torch.minimum(o_hi, hi), o_hi))
        return out

    dt = minplus(g, 2)[:, :, core]
    dt = minplus(dt, 3)[:, :, :, core]
    q = qry > 0
    ok = dt <= halo * halo
    unres = q & ~ok
    return (torch.where(q & ok, dt, 0).sum(dim=(1, 2, 3)),
            q.sum(dim=(1, 2, 3)).to(torch.int32),
            unres.sum(dim=(1, 2, 3)).to(torch.int32),
            packbits(unres.reshape(bs, -1)))


def halo_edt(qry, tgt, kmax, size, halo):
    """K2 wrapper: same outputs as :func:`halo_edt_plain`."""
    if tgt.device.type == "cpu":
        return halo_edt_plain(qry, tgt, kmax, size, halo)
    bs, H = tgt.shape[0], tgt.shape[1]
    if H != size + 2 * halo or size % 8:
        raise ValueError(f"halo volumes of {H}³ do not fit size {size}, "
                         f"halo {halo} (size must be a multiple of 8)")
    kernels.check_cuda_tensor(qry, "qry", torch.uint8, (bs,) + (size,) * 3)
    kernels.check_cuda_tensor(tgt, "tgt", torch.uint8, (bs, H, H, H))
    kernels.check_cuda_tensor(kmax, "kmax", torch.int32, (bs,))
    lib = kernels.load("halo_edt")
    dev = tgt.device
    scratch = torch.empty(bs, size, H, H, dtype=torch.uint8, device=dev)
    s = torch.zeros(bs, dtype=torch.int64, device=dev)
    n = torch.zeros(bs, dtype=torch.int32, device=dev)
    cnt = torch.zeros(bs, dtype=torch.int32, device=dev)
    unres = torch.empty(bs, size ** 3 // 8, dtype=torch.uint8, device=dev)
    err = lib.pcc_halo_edt(
        qry.data_ptr(), tgt.data_ptr(), kmax.data_ptr(), scratch.data_ptr(),
        s.data_ptr(), n.data_ptr(), cnt.data_ptr(), unres.data_ptr(), bs, H,
        size, halo, kernels.stream_ptr(dev))
    kernels.check_launch(err, "halo_edt")
    kernels.launches["halo_edt"] += 1
    return s, n, cnt, unres


def halo_d1_dir(qry, tgt_vol, *, size, halo):
    """One-direction D1 partial sums over assembled halo volumes.

    :param qry: [bs, size, size, size] uint8 core query occupancy.
    :param tgt_vol: [bs, H, H, H] uint8 target occupancy (full halo).
    :return: dict(sum [bs] int64, n, unres_cnt [bs] int32, unres
        [bs, size³/8] uint8 packed core outlier masks).
    """
    kmax = halo_kmax(qry, tgt_vol, halo)
    s, n, cnt, unres = halo_edt(qry.contiguous(), tgt_vol.contiguous(),
                                kmax, size, halo)
    return {"sum": s, "n": n, "unres_cnt": cnt, "unres": unres}

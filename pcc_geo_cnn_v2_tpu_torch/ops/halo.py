"""Halo D1 partial sums around kernel K2.

Port of ``pcc_geo_cnn_v2_tpu/ops/pallas_halo.py`` with the volume assembly
around it (``_halo_dir_chunk_pallas`` of the JAX ``ops/cloud_metrics.py``).
For each block of a cloud and both directions (AB: queries are cloud A's
voxels, targets cloud B's; BA: the reverse): the squared distance D from
each query voxel to its nearest target voxel of the block's
27-neighbourhood, exact where D ≤ halo² — sum of those D, query count,
outlier count (D > halo²) and the packed outlier mask.

:func:`halo_d1_packed` takes the packed grids and the neighbour table.
CUDA tensors launch ``csrc/halo_edt.cu`` (two kernels, one call for the
whole cloud, nothing assembled); CPU tensors take
:func:`halo_d1_packed_plain`, the JAX package's chain per batch of blocks:
gather the neighbours, unpack the query core (:func:`query_core`),
assemble the [H, H, H] halo volume of the target (:func:`assemble_halo`,
H = size + 2·halo), bound each block's passes by a coarse-grid EDT
(:func:`halo_kmax`) and run the separable bounded passes
(:func:`halo_edt_plain`).

Bound validity (as in the JAX package): with kmax ≥ every core query
voxel's true in-halo NN distance (clipped to halo), every dt ≤ halo² is
exact and larger values can only be overestimates, which are flagged. The
outputs therefore do not depend on how tight the bound is, only on its
validity — the port computes it on the unpadded H (the TPU padded H to a
multiple of 16 for its lane tiling). The kernel needs no bound: its row
search stops by itself (``csrc/halo_edt.cu``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from pcc_geo_cnn_v2_tpu_torch.ops import kernels
from pcc_geo_cnn_v2_tpu_torch.ops.edt import banded_squared_edt
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import packbits, unpackbits

__all__ = ["assemble_halo", "query_core", "halo_kmax", "halo_edt",
           "halo_edt_plain", "halo_d1_dir", "halo_spiral_table",
           "check_k2_limits", "halo_d1_packed_plain", "halo_d1_packed"]

_NONE = 255       # no target within kmax along a column
_INF_I = 1 << 24  # squared distance of _NONE
# The kernel's limits and launch geometry (csrc/halo_edt.cu)
K2_SIZE_MAX = 64     # a block row is one 64-bit word
K2_ROW_BITS = 128    # a halo row (size + 2 halo bits) is one 128-bit word
K2_SLAB = 16         # core x-planes a CTA
K2_THREADS = 512     # threads a CTA
SMEM_MAX = 232448    # shared memory a CTA can use on Hopper (227 KB)


def assemble_halo(p_nb, size, halo):
    """Packed ``[bs, 27, B³/8]`` neighbour grids → ``[bs, H, H, H]`` uint8
    halo volumes, H = B + 2·halo; only the bytes each neighbour contributes
    are unpacked."""
    bs = p_nb.shape[0]
    B, H = size, size + 2 * halo
    pv = p_nb.reshape(bs, 27, B, B, B // 8)
    vol = torch.zeros(bs, H, H, H, dtype=torch.uint8, device=p_nb.device)

    def rng(d):
        # source voxel window in the neighbour / dest window in the halo
        if d < 0:
            return (B - halo, B), (0, halo)
        if d > 0:
            return (0, halo), (B + halo, H)
        return (0, B), (halo, B + halo)

    j = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                (sx0, sx1), (tx0, tx1) = rng(dx)
                (sy0, sy1), (ty0, ty1) = rng(dy)
                (sz0, sz1), (tz0, tz1) = rng(dz)
                zb0 = sz0 // 8  # byte-aligned z cut, trimmed after unpack
                sub = pv[:, j, sx0:sx1, sy0:sy1, zb0:(sz1 + 7) // 8]
                bits = unpackbits(sub)
                vol[:, tx0:tx1, ty0:ty1, tz0:tz1] = \
                    bits[..., sz0 - zb0 * 8: sz1 - zb0 * 8]
                j += 1
    return vol


def query_core(p_nb, size):
    """``[bs, size, size, size]`` uint8 query grids of the centre blocks."""
    return unpackbits(p_nb[:, 13]).view(p_nb.shape[0], size, size, size)


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
    """Plain-torch bounded halo EDT: (sum int64, n int32, unres_cnt int32,
    unres uint8 [bs, size³/8]) — the TPU kernel's passes, vectorised over
    the batch.

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
    """The assembled-volume entry: :func:`halo_edt_plain` on CPU tensors.
    No kernel takes assembled halo volumes: on the card the D1 sums go
    through :func:`halo_d1_packed`, which assembles nothing."""
    if tgt.device.type != "cpu":
        raise ValueError(f"halo_edt: got a {tgt.device} tensor, not a CPU "
                         "one; on a CUDA tensor the D1 sums take "
                         "halo_d1_packed (kernel K2)")
    return halo_edt_plain(qry, tgt, kmax, size, halo)


def halo_d1_dir(qry, tgt_vol, *, size, halo):
    """One-direction D1 partial sums over assembled halo volumes (CPU).

    :param qry: [bs, size, size, size] uint8 core query occupancy.
    :param tgt_vol: [bs, H, H, H] uint8 target occupancy (full halo).
    :return: dict(sum [bs] int64, n, unres_cnt [bs] int32, unres
        [bs, size³/8] uint8 packed core outlier masks).
    """
    kmax = halo_kmax(qry, tgt_vol, halo)
    s, n, cnt, unres = halo_edt(qry.contiguous(), tgt_vol.contiguous(),
                                kmax, size, halo)
    return {"sum": s, "n": n, "unres_cnt": cnt, "unres": unres}


def halo_spiral_table(halo):
    """The kernel's search order: every (|dx|, |dy|) with dx² + dy² ≤
    halo², packed as ``dx² + dy² << 14 | |dx| << 7 | |dy|`` and sorted, so
    rows come in order of their distance from the query's row and a search
    stops at the first entry whose dx² + dy² is not below its best value.

    :return: [entries] int32 numpy array.
    """
    d = np.arange(halo + 1)
    dx, dy = (a.ravel() for a in np.meshgrid(d, d, indexing="ij"))
    r2 = dx * dx + dy * dy
    keep = r2 <= halo * halo
    return np.sort((r2[keep] << 14) | (dx[keep] << 7) | dy[keep]).astype(
        np.int32)


@functools.lru_cache(maxsize=8)
def _spiral_on(halo, device):
    return kernels.device_table(halo_spiral_table(halo), device)


def check_k2_limits(size, halo):
    """Raise ``ValueError``, with the reason, where K2's kernel does not
    take (size, halo). The plain version takes any size that is a multiple
    of 8 and any halo ≤ size.

    :return: (slabs — CTAs a block and direction, shared bytes a CTA
        beside a few hundred bytes of scalars).
    """
    if size % 8 or not 8 <= size <= K2_SIZE_MAX:
        raise ValueError(f"block size {size}: K2 keeps a block row in one "
                         f"64-bit word (a multiple of 8, ≤ {K2_SIZE_MAX})")
    if not 1 <= halo <= size or size + 2 * halo > K2_ROW_BITS:
        raise ValueError(f"halo {halo} at block size {size}: K2 needs "
                         f"1 ≤ halo ≤ size and a halo row of size + 2·halo ≤ "
                         f"{K2_ROW_BITS} bits")
    # the halo rows, and a round's query rows, first voxels and flags
    smem = (min(K2_SLAB, size) + 2 * halo) * (size + 2 * halo) * 16 \
        + K2_THREADS * 20
    assert smem <= SMEM_MAX  # 80 × 128 rows of 16 bytes at most
    return -(-size // K2_SLAB), smem


def halo_d1_packed_plain(a_ext, b_ext, idx, *, size, halo, batch=64):
    """Plain-torch K2 (any device): the JAX package's chain, ``batch``
    blocks at a time — gather, :func:`query_core`, :func:`assemble_halo`,
    :func:`halo_kmax`, :func:`halo_edt_plain`. Arguments and outputs as
    :func:`halo_d1_packed`."""
    m, dev = idx.shape[0], a_ext.device
    nbytes = size ** 3 // 8
    stats = torch.zeros(2, 3, m, dtype=torch.int64, device=dev)
    unres = torch.zeros(2, m, nbytes, dtype=torch.uint8, device=dev)
    idx = idx.to(torch.int64)
    for lo in range(0, m, batch):
        ix = idx[lo:lo + batch]
        hi = lo + len(ix)
        a_nb, b_nb = a_ext[ix], b_ext[ix]
        for d, (q_nb, t_nb) in enumerate(((a_nb, b_nb), (b_nb, a_nb))):
            qry = query_core(q_nb, size)
            tgt = assemble_halo(t_nb, size, halo)
            kmax = halo_kmax(qry, tgt, halo)
            for k, v in enumerate(halo_edt_plain(qry, tgt, kmax, size,
                                                 halo)):
                if k < 3:
                    stats[d, k, lo:hi] = v
                else:
                    unres[d, lo:hi] = v
    return stats, unres


def halo_d1_packed(a_ext, b_ext, idx, *, size, halo, batch=64):
    """K2: both directions' D1 partial sums of a cloud's blocks.

    :param a_ext: [rows, size³/8] uint8 packed grids of cloud A whose last
        row is zero (the absent neighbour).
    :param b_ext: same for cloud B.
    :param idx: [n, 27] int32 neighbour table (``neighbor_table`` with -1
        mapped to ``rows - 1``); block i's query grid is row ``idx[i, 13]``.
    :param batch: blocks a step of the plain version (CPU tensors); the
        kernel takes the whole cloud in one call.
    :return: (stats [2, 3, n] int64 — (sum, n, unres_cnt) per direction
        AB, BA and block; unres [2, n, size³/8] uint8 packed outlier
        masks, big bit order).
    """
    if a_ext.device.type == "cpu":
        return halo_d1_packed_plain(a_ext, b_ext, idx, size=size, halo=halo,
                                    batch=batch)
    rows, n = a_ext.shape[0], idx.shape[0]
    nbytes = size ** 3 // 8
    kernels.check_cuda_tensor(a_ext, "a_ext", torch.uint8, (rows, nbytes))
    kernels.check_cuda_tensor(b_ext, "b_ext", torch.uint8, (rows, nbytes))
    kernels.check_cuda_tensor(idx, "idx", torch.int32, (n, 27))
    slabs, _ = check_k2_limits(size, halo)
    if a_ext.data_ptr() % 16 or b_ext.data_ptr() % 16:
        raise ValueError("a_ext / b_ext must be 16-byte aligned")
    if n * slabs >= 1 << 31:
        raise ValueError(f"{n} blocks: K2 takes fewer than 2^31 / {slabs} "
                         "a call")
    dev = a_ext.device
    spiral = _spiral_on(halo, dev)
    part = torch.empty(2, n, slabs, 3, dtype=torch.int64, device=dev)
    stats = torch.empty(2, 3, n, dtype=torch.int64, device=dev)
    unres = torch.empty(2, n, nbytes, dtype=torch.uint8, device=dev)
    lib = kernels.load("halo_edt")
    kernels.launch(
        "halo_edt", lib.pcc_halo_edt, dev, a_ext.data_ptr(), b_ext.data_ptr(),
        rows, idx.data_ptr(), spiral.data_ptr(), len(spiral), part.data_ptr(),
        stats.data_ptr(), unres.data_ptr(), n, size, halo)
    return stats, unres

"""Exact-EDT adaptive-threshold D1 sweep sums around kernel K5.

Port of ``pcc_geo_cnn_v2_tpu/ops/pallas_sweep.py``. Per block and
threshold t, with the candidate set S_t = {x_hat > thresholds[t]}:

- ``count(t)``  = |S_t|
- ``ba_sum(t)`` = Σ_{v ∈ S_t} dt_orig(v)        (dt_orig = squared EDT of the
  original occupancy)
- ``ab_sum(t)`` = Σ_{v occupied} EDT²_{S_t}(v)

and ``(0, 0, INF)`` from the first empty candidate set on. CUDA tensors
launch ``csrc/edt_sweep.cu`` (:func:`edt_sweep_sums`, three kernels a call
whatever T: threshold bins with cnt / BA histograms, their suffix sums,
and the EDTs on bit rows in shared memory; :func:`edt_sweep_plan` checks
its limits); CPU tensors take :func:`d1_sweep_sums_plain`: per threshold
one mask, one :func:`~pcc_geo_cnn_v2_tpu_torch.ops.edt.squared_edt` and
masked sums.

With the encoder's point lists (``pts``), thresholds whose candidate set
has at most ``sparse_k`` voxels take :func:`_sparse_ab_sums` — a
points × candidates prefix-min in plain torch, outside the kernel as in
the JAX package — because a sparse set sits far from the surface and
makes every EDT search long. Both ways are exact, so the sums do not
depend on where the split falls.

All sums are exact integers (squared distances ≤ 3(B-1)², dt_orig taken as
an integer capped at 2^24) rounded to f32 once. dt_orig of a block without
occupied voxels (a padding row) is capped at 2^24 instead of the EDT's
1e12.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pcc_geo_cnn_v2_tpu_torch.ops import kernels
from pcc_geo_cnn_v2_tpu_torch.ops.edt import INF, squared_edt

__all__ = ["sweep_bounds", "d1_sweep_sums_plain", "edt_sweep_plan",
           "spiral_table", "edt_sweep_sums", "d1_sweep_sums"]

DT_CAP = 1 << 24  # integer stand-in for the EDT's INF (blocks without points)
# The kernel's limits and launch geometry (csrc/edt_sweep.cu)
K5_T_MAX = 2048        # thresholds: shared histograms of passes 1 and 2
K5_SIZE_MAX = 128      # a bit row is at most two 64-bit words
K5_SEG = 16384         # voxels of a pass-1 CTA
K5_AB_THREADS = 512    # threads of a pass-3 CTA
K5_BRUTE_MAX = 2048    # candidates a pass-3 CTA lists for brute force
SMEM_MAX = 232448      # shared memory a CTA can use on Hopper (227 KB)


def sweep_bounds(x_hat, thresholds, k):
    """Per-block threshold bounds from the nested candidate sets.

    :return: (first_empty [N] int32 — #thresholds with a non-empty set,
        i.e. below the block maximum; t_small [N] int32 — #thresholds
        whose set has more than ``k`` voxels, i.e. below the (k+1)-th
        largest value; cand_idx [N, k] flat positions of the ``k`` largest
        values, descending).
    """
    n = x_hat.shape[0]
    flat = x_hat.reshape(n, -1).to(torch.float32)
    vals, idx = torch.topk(flat, min(k + 1, flat.shape[1]), dim=1)
    below = lambda v: (v[:, None] > thresholds[None, :]).sum(1).to(
        torch.int32)
    first_empty = below(vals[:, 0])
    if k < flat.shape[1]:
        t_small = below(vals[:, k])
    else:  # the whole volume fits the sparse path
        t_small = torch.zeros_like(first_empty)
    return first_empty, t_small, idx[:, :k]


def _dt_int(dt_orig):
    return torch.clamp_max(dt_orig, float(DT_CAP)).to(torch.int32)


def _finish(ab, ba, cnt, t_end):
    """Integer sums → the f32 outputs: INF where AB was not computed."""
    tidx = torch.arange(ab.shape[1], device=ab.device)[None, :]
    inf = torch.tensor(INF, dtype=torch.float32, device=ab.device)
    ab = torch.where(tidx < t_end[:, None], ab.to(torch.float32), inf)
    return ab, ba.to(torch.float32), cnt.to(torch.float32)


def d1_sweep_sums_plain(x_hat, occ, dt_orig, thresholds, t_end=None):
    """Plain-torch K5: (ab, ba, count) [N, T] f32.

    :param x_hat: [N, B, B, B] decoded probabilities (f32).
    :param occ: [N, B, B, B] original occupancy.
    :param dt_orig: [N, B, B, B] squared EDT of ``occ``.
    :param thresholds: [T] ascending f32 tensor.
    :param t_end: optional [N] int32 ≤ first_empty: AB is computed for
        t < t_end only (INF from there on); default first_empty.
    """
    n, T = x_hat.shape[0], thresholds.shape[0]
    dev = x_hat.device
    first_empty = sweep_bounds(x_hat, thresholds, 0)[0]
    t_end = first_empty if t_end is None else \
        torch.minimum(t_end.to(torch.int32), first_empty)
    occ_b = occ > 0
    dt_i = _dt_int(dt_orig).to(torch.int64)
    ab = torch.zeros(n, T, dtype=torch.int64, device=dev)
    ba = torch.zeros_like(ab)
    cnt = torch.zeros_like(ab)
    fe_h, te_h = first_empty.tolist(), t_end.tolist()
    for t in range(max(fe_h, default=0)):
        rows = [i for i in range(n) if fe_h[i] > t]
        mask = x_hat[rows] > thresholds[t]
        cnt[rows, t] = mask.sum(dim=(1, 2, 3))
        ba[rows, t] = torch.where(mask, dt_i[rows], 0).sum(dim=(1, 2, 3))
        sel = [j for j, i in enumerate(rows) if te_h[i] > t]
        if sel:
            rows_ab = [rows[j] for j in sel]
            dt_c = squared_edt(mask[sel]).to(torch.int64)
            ab[rows_ab, t] = torch.where(occ_b[rows_ab], dt_c, 0).sum(
                dim=(1, 2, 3))
    return _finish(ab, ba, cnt, t_end)


def edt_sweep_plan(n, size, T):
    """K5's pass-1 segments for ``n`` blocks of ``size``³ and ``T``
    thresholds; raises ``ValueError``, with the reason, on what the kernel
    does not take.

    :return: (seg — voxels a pass-1 CTA, segments — pass-1 CTAs a block).
    """
    if not 1 <= n <= 65535:
        raise ValueError(f"{n} blocks: the kernel takes 1..65535 a call")
    if not 1 <= T <= K5_T_MAX:
        raise ValueError(f"{T} thresholds: pass 1 keeps a histogram of T + 1 "
                         f"bins in shared memory (T ≤ {K5_T_MAX})")
    if not 1 <= size <= K5_SIZE_MAX:
        raise ValueError(f"block size {size}: a bit row is at most two "
                         f"64-bit words (size ≤ {K5_SIZE_MAX})")
    words = 1 if size <= 64 else 2
    vol = size ** 3
    seg = min(K5_SEG, vol)
    segments = -(-vol // seg)
    # pass 3: bit rows, three projections, the candidate list, segment
    # offsets, and its static arrays
    smem = (size + 3) * size * words * 8 + K5_BRUTE_MAX * 8 \
        + (segments + 1) * 4 + (K5_AB_THREADS // 32) * 8 + 8
    if smem > SMEM_MAX:
        raise ValueError(f"block size {size}: a threshold's bit rows, "
                         f"projections and candidate list take {smem} bytes "
                         f"of shared memory, more than a CTA has "
                         f"({SMEM_MAX})")
    # the 64-bit sums: AB ≤ size³ · 3 (size-1)², BA ≤ size³ · 2^24
    assert vol * max(3 * (size - 1) ** 2, DT_CAP) < 1 << 63
    return seg, segments


def spiral_table(size):
    """Pass 3's search order: every (dz, dy) in [0, size)², packed as
    ``dz² + dy² << 14 | dz << 7 | dy`` and sorted, so rows come in order of
    their distance from the voxel's row and a search stops at the first
    entry whose dz² + dy² is not below its best value; then, for r in
    0 .. 2 (size-1)² + 1, the first entry with dz² + dy² ≥ r (where a search
    starts once the row projection shows no row nearer than r).

    :return: [size² + 2 (size-1)² + 2] int32 numpy array.
    """
    dz, dy = (a.ravel() for a in np.meshgrid(np.arange(size),
                                             np.arange(size), indexing="ij"))
    table = np.sort(((dz * dz + dy * dy) << 14) | (dz << 7) | dy)
    start = np.searchsorted(table >> 14, np.arange(2 * (size - 1) ** 2 + 2))
    return np.concatenate([table, start]).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _spiral_on(size, device):
    return kernels.device_table(spiral_table(size), device)


def edt_sweep_sums(x_hat, occ, dt_orig, thresholds, t_end=None):
    """K5 wrapper: same outputs as :func:`d1_sweep_sums_plain`.

    ``thresholds`` must be ascending (the kernel bins by binary search).
    """
    if x_hat.device.type == "cpu":
        return d1_sweep_sums_plain(x_hat, occ, dt_orig, thresholds, t_end)
    n, size, T = x_hat.shape[0], x_hat.shape[-1], thresholds.shape[0]
    seg, S = edt_sweep_plan(n, size, T)
    shape = (n, size, size, size)
    kernels.check_cuda_tensor(x_hat, "x_hat", torch.float32, shape)
    kernels.check_cuda_tensor(dt_orig, "dt_orig", torch.float32, shape)
    kernels.check_cuda_tensor(thresholds, "thresholds", torch.float32, (T,))
    if tuple(occ.shape) != shape:
        raise ValueError("occ must have x_hat's shape")
    dev = x_hat.device
    occ_u8 = (occ if occ.dtype == torch.uint8 else occ > 0).to(
        torch.uint8).contiguous()
    t_end = torch.full((n,), T, dtype=torch.int32, device=dev) \
        if t_end is None else t_end.to(torch.int32).contiguous()
    kernels.check_cuda_tensor(t_end, "t_end", torch.int32, (n,))
    i32 = dict(dtype=torch.int32, device=dev)
    bins = torch.empty(n, size ** 3, dtype=torch.int16, device=dev)
    hcnt = torch.empty(n, S, T + 1, **i32)
    hba = torch.empty(n, S, T + 1, dtype=torch.int64, device=dev)
    seg_max, occ_cnt = torch.empty(n, S, **i32), torch.empty(n, S, **i32)
    occ_list = torch.empty(n, S * seg, **i32)
    occ_off = torch.empty(n, S + 1, **i32)
    te, items = torch.empty(n, **i32), torch.empty(1 + n * T, **i32)
    cnt, ba, ab = (torch.empty(n, T, dtype=torch.float32, device=dev)
                   for _ in range(3))
    lib = kernels.load("edt_sweep")
    kernels.launch(
        "edt_sweep", lib.pcc_edt_sweep, dev, x_hat.data_ptr(),
        occ_u8.data_ptr(), dt_orig.data_ptr(), thresholds.data_ptr(),
        t_end.data_ptr(), bins.data_ptr(), hcnt.data_ptr(), hba.data_ptr(),
        seg_max.data_ptr(), occ_list.data_ptr(), occ_cnt.data_ptr(),
        occ_off.data_ptr(), te.data_ptr(), items.data_ptr(),
        _spiral_on(size, dev).data_ptr(), cnt.data_ptr(), ba.data_ptr(),
        ab.data_ptr(), INF, n, size, T, seg)
    return ab, ba, cnt


def _sparse_ab_sums(pts, cand_idx, cnt, size):
    """AB sums of the sparse thresholds via a points × candidates
    prefix-min: for a threshold with count c ≤ K the candidate set is
    exactly the first c entries of the top-K-by-value list, so
    d_t(p) = prefix-min over them — one [P, K] distance matrix and one
    prefix-min scan per block serve all sparse thresholds through a gather
    at c - 1.

    :param pts: [N, P, 3] int occupied voxels, -1 rows = padding.
    :param cand_idx: [N, K] flat positions of the top-K voxels, descending.
    :param cnt: [N, T] per-threshold candidate counts.
    :return: [N, T] f32 AB sums, valid wherever 0 < count ≤ K.
    """
    cand = torch.stack([cand_idx // (size * size), (cand_idx // size) % size,
                        cand_idx % size], dim=-1).to(torch.int64)  # [N, K, 3]
    K = cand.shape[1]
    idx = torch.clamp(cnt.to(torch.int64) - 1, 0, K - 1)  # [N, T]
    out = torch.zeros(idx.shape, dtype=torch.int64, device=pts.device)
    for lo in range(0, pts.shape[1], 512):
        p = pts[:, lo:lo + 512].to(torch.int64)
        valid = (p >= 0).all(-1)  # [N, pc]
        d2 = ((p[:, :, None, :] - cand[:, None, :, :]) ** 2).sum(-1)
        pm = torch.cummin(d2, dim=2).values
        picked = torch.gather(pm, 2, idx[:, None, :].expand(-1, p.shape[1],
                                                            -1))
        out += torch.where(valid[:, :, None], picked, 0).sum(1)
    return out.to(torch.float32)


def d1_sweep_sums(x_hat, occ, thresholds, pts=None, sparse_k=256):
    """Batched exact-EDT sweep sums on kernel K5.

    :param x_hat: [N, B, B, B] decoded probabilities.
    :param occ: [N, B, B, B] original occupancy.
    :param thresholds: [T] ascending f32 tensor.
    :param pts: optional [N, P, 3] int occupied-voxel coordinates (-1 rows
        = padding; exactly the occupied voxels of ``occ``). When given,
        thresholds whose candidate set has ≤ ``sparse_k`` voxels are
        computed by :func:`_sparse_ab_sums` and the kernel runs its EDT on
        the denser sets only.
    :return: (ab_sum, ba_sum, count [N, T] f32, dt_orig [N, B, B, B]).
    """
    size = x_hat.shape[-1]
    x_hat = x_hat.to(torch.float32).contiguous()
    dt_orig = squared_edt(occ > 0)
    if pts is None:
        ab, ba, cnt = edt_sweep_sums(x_hat, occ, dt_orig, thresholds)
        return ab, ba, cnt, dt_orig
    first_empty, t_small, cand_idx = sweep_bounds(x_hat, thresholds,
                                                  sparse_k)
    ab, ba, cnt = edt_sweep_sums(x_hat, occ, dt_orig, thresholds,
                                 t_end=torch.minimum(first_empty, t_small))
    tidx = torch.arange(thresholds.shape[0], device=x_hat.device)[None, :]
    sparse = (tidx >= t_small[:, None]) & (tidx < first_empty[:, None])
    ab = torch.where(sparse, _sparse_ab_sums(pts, cand_idx, cnt, size), ab)
    return ab, ba, cnt, dt_orig

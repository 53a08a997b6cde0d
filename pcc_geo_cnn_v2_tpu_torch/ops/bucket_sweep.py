"""Bucket-ordered adaptive-threshold D1 / D2 sweep around kernels K1, K3.

Port of ``pcc_geo_cnn_v2_tpu/ops/bucket_sweep.py``. Candidate
sets of the 256 thresholds are nested: sort the voxels with
``x_hat > thresholds[0]`` once by descending probability and every
threshold's candidate set is a prefix of that order. Then

- ``count(t)``  = #sorted values > t                (``searchsorted``)
- ``ba_sum(t)`` = Σ_{k < count(t)} min_p d²(p, c_k)   (prefix sum of candmin)
- ``ab_sum(t)`` = Σ_p min_{k < count(t)} d²(p, c_k)   (colsum at count(t)-1)

and ``colsum`` / ``candmin`` come from K1 (:func:`bucket_colsums`, CUDA
kernel ``csrc/bucket_colsums.cu``) or, for CPU tensors, from its plain
version :func:`bucket_colsums_plain`.

With per-point normals the d2 (point-to-plane) sums ride the same prefix
structure (K3, :func:`bucket_colsums_d2`, ``csrc/bucket_colsums_d2.cu``):

- ``ba2_sum(t)`` = prefix sum of ``candplane[k]``, the plane² from
  candidate k to its nearest original with that original's normal — at the
  LOWEST point row among distance-tied originals;
- ``ab2_sum(t)`` = ``colplane`` at count(t)-1, Σ_p plane²(p → its prefix-NN
  candidate) with p's own normal — the EARLIER candidate wins distance
  ties.

Blocks with more than ``K`` candidates are flagged in ``overflow``; the
codec re-runs them through the same kernel at ``K = B³``, where overflow
cannot happen (the ``bucket_exact`` backend of the JAX codec).
"""

from __future__ import annotations

import numpy as np
import torch

from pcc_geo_cnn_v2_tpu_torch.ops import kernels
from pcc_geo_cnn_v2_tpu_torch.ops.edt import INF
from pcc_geo_cnn_v2_tpu_torch.ops.threshold_sweep import (
    D1_METRICS,
    D2_METRICS,
    metrics_from_sums,
    select_from_sweep,
)

__all__ = ["bucket_colsums", "bucket_colsums_plain", "bucket_plan",
           "check_k1_limits", "check_k3_limits", "bucket_colsums_d2",
           "bucket_colsums_d2_plain", "check_normals", "sorted_candidates",
           "bucket_sweep_sums", "select_thresholds_d1_bucket"]

BIG = 1_000_000_000  # > any real d² (≤ 3·(B-1)²): "no point" minimum
_CHUNK_ELEMS = 1 << 24  # point × candidate tile of the plain version
# K3 packs (d², point row) into one 32-bit key and sums plane² in 64-bit
# fixed point: limits on d², the point budget and the normals' magnitude
_ROW_BITS = 18
MAX_NORMAL = 32.0
# threads of a K1 and a K3 sweep CTA (NT of csrc/bucket_colsums.cu and
# csrc/bucket_colsums_d2.cu)
K1_THREADS = 128


def _cand_coords(pos, size):
    return torch.stack([pos // (size * size), (pos // size) % size,
                        pos % size], dim=-1)


def bucket_colsums_plain(pts, pos, cnt0, npts, size):
    """Plain-torch K1: (colsum int64 [N, K], candmin int64 [N, K]).

    :param pts: [N, P, 3] int32 points (x < 0 = padding; valid rows first).
    :param pos: [N, K] int32 flat candidate positions, descending x_hat.
    :param cnt0: [N] int32 active candidate counts (≤ K).
    :param npts: [N] int32 valid point counts.
    Columns at or past cnt0 hold 0 / BIG.
    """
    n_blocks, K = pos.shape
    colsum = torch.zeros(n_blocks, K, dtype=torch.int64, device=pos.device)
    candmin = torch.full((n_blocks, K), BIG, dtype=torch.int64,
                         device=pos.device)
    cnt0_h, npts_h = cnt0.tolist(), npts.tolist()
    for n in range(n_blocks):
        c, m = int(cnt0_h[n]), int(npts_h[n])
        p = pts[n, :m].to(torch.int64)
        p = p[p[:, 0] >= 0]
        if c == 0 or len(p) == 0:
            continue
        cc = _cand_coords(pos[n, :c].to(torch.int64), size)
        rows = max(1, _CHUNK_ELEMS // c)
        for lo in range(0, len(p), rows):
            d2 = ((p[lo:lo + rows, None, :] - cc[None]) ** 2).sum(-1)
            colsum[n, :c] += torch.cummin(d2, dim=1).values.sum(0)
            candmin[n, :c] = torch.minimum(candmin[n, :c], d2.min(0).values)
    return colsum, candmin


def bucket_plan(n_blocks, n_points):
    """Launch plan of K1 and of K3 for ``n_blocks`` blocks of ``n_points``
    point rows: dict(threads, grid=(point tiles, n_blocks)).

    Thread t of point tile i takes point row ``i · threads + t`` of its
    block and sweeps every candidate of it. The grid follows the batch's
    shape, not its point counts (CTAs past a block's points return at
    once), so a block's outputs do not depend on the batch around it.
    """
    return dict(threads=K1_THREADS,
                grid=(-(-n_points // K1_THREADS), n_blocks))


def check_k1_limits(n_points, size):
    """Raise where K1's kernel would not be exact: its column sums wrap in
    32 bits (``n_points · 3 (size-1)² < 2^32``) and its distances are f32
    (``6 (size-1)² < 2^24``). The plain version is exact at any size."""
    if (n_points * 3 * (size - 1) ** 2 >= 1 << 32
            or 6 * (size - 1) ** 2 >= 1 << 24):
        raise ValueError(f"block size {size} / point budget {n_points}: "
                         "K1's 32-bit column sums or f32 distances not exact")


def bucket_colsums(pts, pos, cnt0, npts, size):
    """K1: prefix-min column sums and column minima of the sorted
    candidates. CUDA tensors launch ``csrc/bucket_colsums.cu`` under
    :func:`bucket_plan` (within :func:`check_k1_limits`); CPU tensors take
    :func:`bucket_colsums_plain`. Same outputs either way."""
    if pos.device.type == "cpu":
        return bucket_colsums_plain(pts, pos, cnt0, npts, size)
    n_blocks, K = pos.shape
    P = pts.shape[1]
    kernels.check_cuda_tensor(pts, "pts", torch.int32, (n_blocks, P, 3))
    kernels.check_cuda_tensor(pos, "pos", torch.int32)
    kernels.check_cuda_tensor(cnt0, "cnt0", torch.int32, (n_blocks,))
    kernels.check_cuda_tensor(npts, "npts", torch.int32, (n_blocks,))
    check_k1_limits(P, size)
    plan = bucket_plan(n_blocks, P)
    lib = kernels.load("bucket_colsums")
    dev = pos.device
    colsum = torch.empty(n_blocks, K, dtype=torch.int64, device=dev)
    candmin = torch.empty(n_blocks, K, dtype=torch.int64, device=dev)
    work = torch.empty(lib.pcc_bucket_colsums_work_ints(n_blocks, K),
                       dtype=torch.int32, device=dev)
    kernels.launch(
        "bucket_colsums", lib.pcc_bucket_colsums, dev, pts.data_ptr(),
        pos.data_ptr(), cnt0.data_ptr(), npts.data_ptr(), colsum.data_ptr(),
        candmin.data_ptr(), work.data_ptr(), n_blocks, P, K, size,
        plan["threads"], plan["grid"][0])
    return colsum, candmin


def _plane2(diff, nrm):
    """((p - c) · n)² in f32 with every product and sum rounded, left to
    right — the arithmetic of K3's ``plane2``."""
    d = diff.to(torch.float32)
    dot = d[..., 0] * nrm[..., 0]
    dot = dot + d[..., 1] * nrm[..., 1]
    dot = dot + d[..., 2] * nrm[..., 2]
    return dot * dot


def bucket_colsums_d2_plain(pts, nrm, pos, cnt0, npts, size):
    """Plain-torch K3: (colsum int64, candmin int64, colplane f32,
    candplane f32), each [N, K]; arguments as :func:`bucket_colsums_plain`
    plus ``nrm`` [N, P, 3] f32 per-point normals.

    Tie rules: the prefix argmin keeps the earliest candidate, the column
    argmin the lowest point row — both through integer keys
    ``d² · 2^18 + index``, whose minimum is unique. Plane sums are taken in
    f64 and rounded to f32 once. Columns at or past cnt0 hold
    0 / BIG / 0 / 0.
    """
    n_blocks, K = pos.shape
    dev = pos.device
    colsum = torch.zeros(n_blocks, K, dtype=torch.int64, device=dev)
    candmin = torch.full((n_blocks, K), BIG, dtype=torch.int64, device=dev)
    colplane = torch.zeros(n_blocks, K, dtype=torch.float64, device=dev)
    candplane = torch.zeros(n_blocks, K, dtype=torch.float32, device=dev)
    cnt0_h, npts_h = cnt0.tolist(), npts.tolist()
    for n in range(n_blocks):
        c, m = int(cnt0_h[n]), int(npts_h[n])
        p = pts[n, :m].to(torch.int64)
        keep = p[:, 0] >= 0
        p, nr = p[keep], nrm[n, :m][keep].to(torch.float32)
        if c == 0:
            continue
        if len(p) == 0:
            candplane[n, :c] = float(BIG)
            continue
        cc = _cand_coords(pos[n, :c].to(torch.int64), size)
        col = torch.arange(c, device=dev)
        best = torch.full((c,), (BIG << _ROW_BITS), dtype=torch.int64,
                          device=dev)
        rows = max(1, _CHUNK_ELEMS // c)
        for lo in range(0, len(p), rows):
            diff = p[lo:lo + rows, None, :] - cc[None]
            d2 = (diff ** 2).sum(-1)
            plane = _plane2(diff, nr[lo:lo + rows, None, :])
            # prefix minimum and its EARLIEST candidate
            pm = torch.cummin((d2 << _ROW_BITS) + col, dim=1).values
            colsum[n, :c] += (pm >> _ROW_BITS).sum(0)
            arg = pm & ((1 << _ROW_BITS) - 1)
            colplane[n, :c] += torch.gather(plane, 1, arg).to(
                torch.float64).sum(0)
            # column minimum and its LOWEST point row
            row = torch.arange(lo, lo + len(d2), device=dev)[:, None]
            best = torch.minimum(best, ((d2 << _ROW_BITS) + row).min(0).values)
        candmin[n, :c] = best >> _ROW_BITS
        r = best & ((1 << _ROW_BITS) - 1)
        candplane[n, :c] = _plane2(p[r] - cc, nr[r])
    return colsum, candmin, colplane.to(torch.float32), candplane


def check_normals(nrm):
    """Raise unless the host array ``nrm`` stays inside the range K3's
    fixed-point plane sums hold exactly (``|n| ≤ MAX_NORMAL``; unit
    normals are far inside)."""
    nrm = np.asarray(nrm)
    if nrm.size and not float(np.abs(nrm).max()) <= MAX_NORMAL:
        raise ValueError("normals beyond the fixed-point range of K3's "
                         f"plane sums (|n| ≤ {MAX_NORMAL})")


def check_k3_limits(n_points, size):
    """Raise where K3's kernel would not be exact: its 32-bit (d², row)
    keys need ``3 (size-1)² < 2^14`` and ``n_points ≤ 2^18``, its d² column
    sums K1's 32-bit limit (:func:`check_k1_limits`). The plain version is
    exact at any size."""
    if (3 * (size - 1) ** 2 >= 1 << (32 - _ROW_BITS)
            or n_points > 1 << _ROW_BITS):
        raise ValueError(f"block size {size} / point budget {n_points} do "
                         "not fit K3's 32-bit (d², row) key: not exact")
    check_k1_limits(n_points, size)


def bucket_colsums_d2(pts, nrm, pos, cnt0, npts, size):
    """K3: K1's outputs plus the point-to-plane column sums. CUDA tensors
    launch ``csrc/bucket_colsums_d2.cu`` under :func:`bucket_plan` (within
    :func:`check_k3_limits`); CPU tensors take
    :func:`bucket_colsums_d2_plain`. Same outputs either way: colsum,
    candmin and candplane bit for bit, colplane within
    ``npts · 2^-21`` (the kernel sums plane² in 2^-20 fixed point, so its
    result does not depend on the order of its atomics). The caller keeps
    ``|nrm| ≤ MAX_NORMAL`` (:func:`check_normals`, once per cloud): the
    kernel launches without a device round trip of its own."""
    if pos.device.type == "cpu":
        return bucket_colsums_d2_plain(pts, nrm, pos, cnt0, npts, size)
    n_blocks, K = pos.shape
    P = pts.shape[1]
    kernels.check_cuda_tensor(pts, "pts", torch.int32, (n_blocks, P, 3))
    kernels.check_cuda_tensor(nrm, "nrm", torch.float32, (n_blocks, P, 3))
    kernels.check_cuda_tensor(pos, "pos", torch.int32)
    kernels.check_cuda_tensor(cnt0, "cnt0", torch.int32, (n_blocks,))
    kernels.check_cuda_tensor(npts, "npts", torch.int32, (n_blocks,))
    check_k3_limits(P, size)
    plan = bucket_plan(n_blocks, P)
    lib = kernels.load("bucket_colsums_d2")
    dev = pos.device
    colsum = torch.empty(n_blocks, K, dtype=torch.int64, device=dev)
    candmin = torch.empty(n_blocks, K, dtype=torch.int64, device=dev)
    colplane = torch.empty(n_blocks, K, dtype=torch.float32, device=dev)
    candplane = torch.empty(n_blocks, K, dtype=torch.float32, device=dev)
    work = torch.empty(lib.pcc_bucket_colsums_d2_work_ints(n_blocks, K),
                       dtype=torch.int32, device=dev)
    kernels.launch(
        "bucket_colsums_d2", lib.pcc_bucket_colsums_d2, dev, pts.data_ptr(),
        nrm.data_ptr(), pos.data_ptr(), cnt0.data_ptr(), npts.data_ptr(),
        colsum.data_ptr(), candmin.data_ptr(), colplane.data_ptr(),
        candplane.data_ptr(), work.data_ptr(), n_blocks, P, K, size,
        plan["threads"], plan["grid"][0])
    return colsum, candmin, colplane, candplane


def sorted_candidates(x_hat, thresholds, K):
    """(values [N, K], flat positions [N, K] int32, cnt0 [N] int32, K) of
    the voxels sorted by descending x_hat, ties by position (the order of
    ``lax.top_k``); K is capped at the block volume."""
    n = x_hat.shape[0]
    flat = x_hat.reshape(n, -1).to(torch.float32)
    K = min(K, flat.shape[-1])
    cnt0 = (flat > thresholds[0]).sum(-1).to(torch.int32)
    vals, pos = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[:, :K].contiguous(), pos[:, :K].to(torch.int32).contiguous(), \
        cnt0, K


def bucket_sweep_sums(x_hat, pts, thresholds, K=32768,
                      colsums_fn=bucket_colsums, nrm=None,
                      colsums_d2_fn=bucket_colsums_d2):
    """Per-threshold D1 (and, with normals, D2) sums, bucket-ordered.

    :param x_hat: [N, B, B, B] decoded probabilities.
    :param pts: [N, P, 3] int occupied-voxel lists (-1 rows = padding).
    :param thresholds: [T] ascending f32 tensor, thresholds[0] ≥ 0.
    :param colsums_fn: K1 entry (the plain version when a check holds the
        kernel against it on the same device).
    :param nrm: optional [N, P, 3] per-point normals: the sums then come
        from ``colsums_d2_fn`` (K3) and two more arrays are returned.
    :return: (ab_sum [N,T], ba_sum [N,T], count [N,T] f32, overflow [N])
        and, with ``nrm``, (ab2_sum [N,T], ba2_sum [N,T]).
    """
    n, size = x_hat.shape[0], x_hat.shape[-1]
    vals, pos, cnt0, K = sorted_candidates(x_hat, thresholds, K)
    overflow = cnt0 > K
    pts = pts.to(torch.int32).contiguous()
    npts = (pts[:, :, 0] >= 0).sum(-1).to(torch.int32)
    if nrm is None:
        colsum, candmin = colsums_fn(pts, pos, torch.clamp_max(cnt0, K),
                                     npts, size)
    else:
        colsum, candmin, colplane, candplane = colsums_d2_fn(
            pts, nrm.to(torch.float32).contiguous(), pos,
            torch.clamp_max(cnt0, K), npts, size)
    valid_k = torch.arange(K, device=x_hat.device)[None, :] < cnt0[:, None]
    # count(t) = #vals > t: binary search on the ascending negated values
    neg_thr = (-thresholds)[None, :].expand(n, -1).contiguous()
    cnt = torch.searchsorted(-vals, neg_thr, side="left")  # [N, T]
    # exact integer prefix sums, rounded to f32 once
    bacum = torch.cumsum(torch.where(valid_k, candmin, 0), dim=-1).to(
        torch.float32)
    idx = torch.clamp(cnt - 1, 0, K - 1)
    ab = torch.where(cnt > 0, torch.gather(colsum.to(torch.float32), 1, idx),
                     torch.tensor(INF, dtype=torch.float32,
                                  device=x_hat.device))
    zero = torch.tensor(0.0, device=x_hat.device)
    ba = torch.where(cnt > 0, torch.gather(bacum, 1, idx), zero)
    res = (ab, ba, cnt.to(torch.float32), overflow)
    if nrm is not None:
        # prefix sum in f64, rounded to f32 once
        ba2cum = torch.cumsum(torch.where(valid_k, candplane, 0).to(
            torch.float64), dim=-1).to(torch.float32)
        inf = torch.tensor(INF, dtype=torch.float32, device=x_hat.device)
        res += (torch.where(cnt > 0, torch.gather(colplane, 1, idx), inf),
                torch.where(cnt > 0, torch.gather(ba2cum, 1, idx), zero))
    return res


def _centroid_guard_metric_pts(pts_f, n_orig, metric):
    """D1 metric of the single centroid point (``model_opt.py:60-62``) per
    block, from the point lists: [N] f32."""
    valid = pts_f[..., 0] >= 0.0
    w = valid.to(torch.float64)[..., None]
    p64 = pts_f.to(torch.float64)
    # exact integer sums, rounded to f32 once
    s1 = (p64 * w).sum(1).to(torch.float32)
    s2 = (p64 ** 2 * w).sum(1).to(torch.float32)
    n = torch.clamp_min(n_orig, 1)
    c = torch.round(s1 / n[:, None])
    ab_sum = s2.sum(-1) - 2 * (c * s1).sum(-1) + n_orig * (c * c).sum(-1)
    d2 = ((pts_f - c[:, None, :]) ** 2).sum(-1)
    ba_sum = torch.where(valid, d2, float(BIG)).min(-1).values
    return metrics_from_sums(ab_sum, ba_sum, n, 1)[metric]


def _centroid_guard_metric_d2_bucket(pts_f, nrm, n_orig, metric):
    """D2 metric of the single centroid point per block, from the point
    lists: all originals vote for the centroid, so its transferred normal
    is the mean original normal; BA uses the nearest original's own normal
    (the smallest plane² among distance-tied originals): [N] f32."""
    valid = pts_f[..., 0] >= 0.0
    w = valid.to(torch.float32)[..., None]
    n = torch.clamp_min(n_orig, 1)
    c = torch.round((pts_f * w).sum(1) / n[:, None])
    n_bar = (nrm * w).sum(1) / n[:, None]
    d = pts_f - c[:, None, :]
    ab_sum = (w[..., 0] * (d * n_bar[:, None, :]).sum(-1) ** 2).sum(-1)
    d2 = torch.where(valid, (d ** 2).sum(-1), float(BIG))
    plane = (-d * nrm).sum(-1) ** 2
    tied = valid & (d2 == d2.min(-1, keepdim=True).values)
    ba_sum = torch.where(tied, plane, float(BIG)).min(-1).values
    return metrics_from_sums(ab_sum, ba_sum, n, 1, prefix="d2")[metric]


def select_thresholds_d1_bucket(x_hat, pts, thresholds,
                                opt_metrics=("d1_mse",),
                                max_deltas=(np.inf,), K=32768,
                                colsums_fn=bucket_colsums, nrm=None,
                                colsums_d2_fn=bucket_colsums_d2):
    """Best threshold per (max_delta × opt_metric) via the bucket sweep.

    With ``nrm`` ([N, P, 3] per-point normals) the d2_* opt metrics are
    supported too, on kernel K3; d1 metrics alone stay on K1 whether or
    not normals are given.

    :return: (picks [N, M] int32, overflow [N] bool); picks of overflowed
        blocks are invalid (re-run them at ``K = B³``).
    """
    need_d2 = any(m.startswith("d2") for m in opt_metrics)
    for m in opt_metrics:
        assert m in D1_METRICS + D2_METRICS, f"{m} is not a d1/d2 metric"
    if need_d2:
        assert nrm is not None, "d2 metrics need per-point normals"
    res = bucket_sweep_sums(x_hat, pts, thresholds, K=K,
                            colsums_fn=colsums_fn,
                            nrm=nrm if need_d2 else None,
                            colsums_d2_fn=colsums_d2_fn)
    ab, ba, cnt, overflow = res[:4]
    pts_f = pts.to(torch.float32)
    n_orig = (pts_f[:, :, 0] >= 0.0).sum(-1).to(torch.float32)
    n1 = torch.clamp_min(n_orig, 1)[:, None]
    sweep = metrics_from_sums(ab, ba, n1, cnt)
    if need_d2:
        nrm_f = nrm.to(torch.float32)
        sweep.update(metrics_from_sums(res[4], res[5], n1, cnt, prefix="d2"))
    sweep["count"] = cnt

    def guard_fn(metric):
        if metric.startswith("d2"):
            return _centroid_guard_metric_d2_bucket(pts_f, nrm_f, n_orig,
                                                    metric)
        return _centroid_guard_metric_pts(pts_f, n_orig, metric)

    picks = select_from_sweep(sweep, n_orig, opt_metrics, max_deltas,
                              guard_fn=guard_fn)
    return picks, overflow

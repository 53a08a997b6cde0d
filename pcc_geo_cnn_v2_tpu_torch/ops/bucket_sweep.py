"""Bucket-ordered adaptive-threshold D1 sweep around kernel K1.

Port of ``pcc_geo_cnn_v2_tpu/ops/bucket_sweep.py`` (d1 path). Candidate
sets of the 256 thresholds are nested: sort the voxels with
``x_hat > thresholds[0]`` once by descending probability and every
threshold's candidate set is a prefix of that order. Then

- ``count(t)``  = #sorted values > t                (``searchsorted``)
- ``ba_sum(t)`` = Σ_{k < count(t)} min_p d²(p, c_k)   (prefix sum of candmin)
- ``ab_sum(t)`` = Σ_p min_{k < count(t)} d²(p, c_k)   (colsum at count(t)-1)

and ``colsum`` / ``candmin`` come from K1 (:func:`bucket_colsums`, CUDA
kernel ``csrc/bucket_colsums.cu``) or, for CPU tensors, from its plain
version :func:`bucket_colsums_plain`.

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
    metrics_from_sums,
    select_from_sweep,
)

__all__ = ["bucket_colsums", "bucket_colsums_plain", "sorted_candidates",
           "bucket_sweep_sums", "select_thresholds_d1_bucket"]

BIG = 1_000_000_000  # > any real d² (≤ 3·(B-1)²): "no point" minimum
_CHUNK_ELEMS = 1 << 24  # point × candidate tile of the plain version


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


def bucket_colsums(pts, pos, cnt0, npts, size):
    """K1: prefix-min column sums and column minima of the sorted
    candidates. CUDA tensors launch ``csrc/bucket_colsums.cu``; CPU tensors
    take :func:`bucket_colsums_plain`. Same outputs either way."""
    if pos.device.type == "cpu":
        return bucket_colsums_plain(pts, pos, cnt0, npts, size)
    n_blocks, K = pos.shape
    P = pts.shape[1]
    kernels.check_cuda_tensor(pts, "pts", torch.int32, (n_blocks, P, 3))
    kernels.check_cuda_tensor(pos, "pos", torch.int32)
    kernels.check_cuda_tensor(cnt0, "cnt0", torch.int32, (n_blocks,))
    kernels.check_cuda_tensor(npts, "npts", torch.int32, (n_blocks,))
    lib = kernels.load("bucket_colsums")
    colsum = torch.zeros(n_blocks, K, dtype=torch.int32, device=pos.device)
    candmin = torch.full((n_blocks, K), BIG, dtype=torch.int32,
                         device=pos.device)
    err = lib.pcc_bucket_colsums(
        pts.data_ptr(), pos.data_ptr(), cnt0.data_ptr(), npts.data_ptr(),
        colsum.data_ptr(), candmin.data_ptr(), n_blocks, P, K, size,
        kernels.stream_ptr(pos.device))
    kernels.check_launch(err, "bucket_colsums")
    kernels.launches["bucket_colsums"] += 1
    # colsum accumulates as uint32 (exact for every P ≤ B³ at B = 64)
    return colsum.to(torch.int64) & 0xFFFFFFFF, candmin.to(torch.int64)


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
                      colsums_fn=bucket_colsums):
    """Per-threshold D1 sums, bucket-ordered.

    :param x_hat: [N, B, B, B] decoded probabilities.
    :param pts: [N, P, 3] int occupied-voxel lists (-1 rows = padding).
    :param thresholds: [T] ascending f32 tensor, thresholds[0] ≥ 0.
    :param colsums_fn: K1 entry (the plain version when a check holds the
        kernel against it on the same device).
    :return: (ab_sum [N,T], ba_sum [N,T], count [N,T] f32, overflow [N]).
    """
    n, size = x_hat.shape[0], x_hat.shape[-1]
    vals, pos, cnt0, K = sorted_candidates(x_hat, thresholds, K)
    overflow = cnt0 > K
    pts = pts.to(torch.int32).contiguous()
    npts = (pts[:, :, 0] >= 0).sum(-1).to(torch.int32)
    colsum, candmin = colsums_fn(pts, pos, torch.clamp_max(cnt0, K), npts,
                                 size)
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
    ba = torch.where(cnt > 0, torch.gather(bacum, 1, idx),
                     torch.tensor(0.0, device=x_hat.device))
    return ab, ba, cnt.to(torch.float32), overflow


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


def select_thresholds_d1_bucket(x_hat, pts, thresholds,
                                opt_metrics=("d1_mse",),
                                max_deltas=(np.inf,), K=32768,
                                colsums_fn=bucket_colsums):
    """Best threshold per (max_delta × opt_metric) via the bucket sweep.

    :return: (picks [N, M] int32, overflow [N] bool); picks of overflowed
        blocks are invalid (re-run them at ``K = B³``).
    """
    for m in opt_metrics:
        assert m in D1_METRICS, f"{m} is not a d1 metric"
    ab, ba, cnt, overflow = bucket_sweep_sums(x_hat, pts, thresholds, K=K,
                                              colsums_fn=colsums_fn)
    pts_f = pts.to(torch.float32)
    n_orig = (pts_f[:, :, 0] >= 0.0).sum(-1).to(torch.float32)
    sweep = metrics_from_sums(ab, ba, torch.clamp_min(n_orig, 1)[:, None],
                              cnt)
    sweep["count"] = cnt
    picks = select_from_sweep(
        sweep, n_orig, opt_metrics, max_deltas,
        guard_fn=lambda m: _centroid_guard_metric_pts(pts_f, n_orig, m))
    return picks, overflow

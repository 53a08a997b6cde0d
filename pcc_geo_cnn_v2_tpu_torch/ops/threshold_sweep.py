"""Per-block threshold selection from swept D1 sums (batched torch).

Port of the selection core of ``pcc_geo_cnn_v2_tpu/ops/threshold_sweep.py``
(``D1_METRICS``, ``_metrics_from_sums``, ``_select_from_sweep``), batched
over blocks instead of ``vmap``-ed. It reproduces the reference's
``model_opt.py:21-77`` semantics exactly: candidate lists stop at the first
empty threshold, max_delta ratio filters fall back to the unfiltered list,
first-minimum argmin, and the centroid failure guard. All metric
arithmetic is f32, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from pcc_geo_cnn_v2_tpu_torch.ops.edt import INF

__all__ = ["D1_METRICS", "metrics_from_sums", "select_from_sweep"]

D1_METRICS = ("d1_sum_AB", "d1_sum_BA", "d1_sum_max", "d1_sum_mean",
              "d1_mse_AB", "d1_mse_BA", "d1_mse")


def metrics_from_sums(ab_sum, ba_sum, n_orig, n_cand):
    """All 7 d1_* metrics from directional sums and counts (f32)."""
    n_cand = torch.as_tensor(n_cand, dtype=torch.float32,
                             device=ab_sum.device)
    safe_cand = torch.clamp_min(n_cand, 1)
    mse_ab = ab_sum / n_orig
    mse_ba = torch.where(n_cand > 0, ba_sum / safe_cand,
                         torch.tensor(INF, dtype=torch.float32,
                                      device=ab_sum.device))
    return {
        "d1_sum_AB": ab_sum,
        "d1_sum_BA": ba_sum,
        "d1_sum_max": torch.maximum(ab_sum, ba_sum),
        "d1_sum_mean": (ab_sum + ba_sum) / 2,
        "d1_mse_AB": mse_ab,
        "d1_mse_BA": mse_ba,
        "d1_mse": torch.maximum(mse_ab, mse_ba),
    }


def select_from_sweep(sweep, n_orig, opt_metrics, max_deltas, guard_fn):
    """Best threshold index per (max_delta × opt_metric) for every block.

    :param sweep: dict of [N, T] f32 metric arrays plus ``count`` [N, T].
    :param n_orig: [N] f32 original point counts.
    :param guard_fn: metric name → [N] centroid-guard metric values.
    :return: [N, len(max_deltas) * len(opt_metrics)] int32 picks.
    """
    counts = sweep["count"]
    n, T = counts.shape
    max_idx = T - 1
    tidx = torch.arange(T, device=counts.device)
    empty = counts == 0
    # reference stops at the first empty threshold (T if none is empty)
    first_empty = torch.where(empty, tidx, T).min(-1).values
    base_elig = tidx[None, :] < first_empty[:, None]
    any_base = base_elig.any(-1)
    inf = torch.tensor(INF, dtype=torch.float32, device=counts.device)

    picks = []
    for max_delta in max_deltas:
        if max_delta is None or not np.isfinite(max_delta):
            elig = base_elig
        else:
            ratio = counts / torch.clamp_min(n_orig, 1)[:, None]
            filt = base_elig & (ratio > 1 / max_delta) & (ratio < max_delta)
            elig = torch.where(filt.any(-1, keepdim=True), filt, base_elig)
        for metric in opt_metrics:
            vals = torch.where(elig, sweep[metric], inf)
            best_val = vals.min(-1).values
            # first minimum, as np.argmin
            k = torch.where(vals == best_val[:, None], tidx, T).min(-1).values
            pick = torch.where(best_val > guard_fn(metric), max_idx, k)
            # no eligible threshold at all → max_idx (empty block)
            pick = torch.where(any_base, pick, max_idx)
            picks.append(pick.to(torch.int32))
    return torch.stack(picks, dim=1)

"""Per-block threshold selection from swept D1 / D2 sums (batched torch).

Port of ``pcc_geo_cnn_v2_tpu/ops/threshold_sweep.py``: the selection core
(``D1_METRICS`` / ``D2_METRICS``, ``_metrics_from_sums``,
``_select_from_sweep``), batched over blocks instead of ``vmap``-ed, and
the grid-based exact D1 sweeps built on it:

- :func:`select_thresholds_d1_batch` — the ``xla`` backend: per threshold
  one EDT of the candidate set, all in plain torch (:func:`d1_sweep`);
- :func:`select_thresholds_d1_pallas` — the same selection on the sums of
  kernel K5 (``ops/edt_sweep.py``); the name is the JAX package's.

Selection reproduces the reference's ``model_opt.py:21-77`` semantics
exactly: candidate lists stop at the first empty threshold, max_delta
ratio filters fall back to the unfiltered list, first-minimum argmin, and
the centroid failure guard. All metric arithmetic is f32, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from pcc_geo_cnn_v2_tpu_torch.ops.edt import INF, squared_edt

__all__ = ["D1_METRICS", "D2_METRICS", "metrics_from_sums",
           "select_from_sweep", "d1_sweep", "select_thresholds_d1",
           "select_thresholds_d1_batch", "select_thresholds_d1_pallas"]

D1_METRICS = ("d1_sum_AB", "d1_sum_BA", "d1_sum_max", "d1_sum_mean",
              "d1_mse_AB", "d1_mse_BA", "d1_mse")
D2_METRICS = tuple(m.replace("d1", "d2") for m in D1_METRICS)


def metrics_from_sums(ab_sum, ba_sum, n_orig, n_cand, prefix="d1"):
    """All 7 {prefix}_* metrics from directional sums and counts (f32)."""
    n_cand = torch.as_tensor(n_cand, dtype=torch.float32,
                             device=ab_sum.device)
    safe_cand = torch.clamp_min(n_cand, 1)
    mse_ab = ab_sum / n_orig
    mse_ba = torch.where(n_cand > 0, ba_sum / safe_cand,
                         torch.tensor(INF, dtype=torch.float32,
                                      device=ab_sum.device))
    return {
        f"{prefix}_sum_AB": ab_sum,
        f"{prefix}_sum_BA": ba_sum,
        f"{prefix}_sum_max": torch.maximum(ab_sum, ba_sum),
        f"{prefix}_sum_mean": (ab_sum + ba_sum) / 2,
        f"{prefix}_mse_AB": mse_ab,
        f"{prefix}_mse_BA": mse_ba,
        f"{prefix}_mse": torch.maximum(mse_ab, mse_ba),
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


def _centroid_guard_metric(occ, dt_orig, metric):
    """D1 metric of the single centroid point (``model_opt.py:60-62``) per
    block, from the occupancy grids and their EDT: [N] f32."""
    n_blocks, B = occ.shape[0], occ.shape[-1]
    occ_b = occ > 0
    n = occ_b.sum(dim=(1, 2, 3)).to(torch.float32)
    ii = torch.arange(B, device=occ.device)
    # exact integer sums Σp and Σp² per axis, rounded to f32 once
    s1, s2 = [], []
    for ax in range(3):
        per = occ_b.sum(dim=tuple(d for d in (1, 2, 3) if d != ax + 1))
        s1.append((per * ii).sum(-1))
        s2.append((per * ii * ii).sum(-1))
    s1 = torch.stack(s1, -1).to(torch.float32)
    s2 = torch.stack(s2, -1).to(torch.float32)
    n1 = torch.clamp_min(n, 1)  # blocks without points: padding rows
    c = torch.round(s1 / n1[:, None])
    ab_sum = s2.sum(-1) - 2 * (c * s1).sum(-1) + n * (c * c).sum(-1)
    ci = torch.clamp(c.to(torch.int64), 0, B - 1)
    ba_sum = dt_orig[torch.arange(n_blocks, device=occ.device), ci[:, 0],
                     ci[:, 1], ci[:, 2]]
    return metrics_from_sums(ab_sum, ba_sum, n1, 1)[metric]


def _select_on_grid(ab, ba, cnt, occ, dt_orig, opt_metrics, max_deltas):
    for m in opt_metrics:
        assert m in D1_METRICS, f"{m} is not a d1 metric"
    n_orig = (occ > 0).sum(dim=(1, 2, 3)).to(torch.float32)
    sweep = metrics_from_sums(ab, ba, torch.clamp_min(n_orig, 1)[:, None],
                              cnt)
    sweep["count"] = cnt
    return select_from_sweep(
        sweep, n_orig, opt_metrics, max_deltas,
        guard_fn=lambda m: _centroid_guard_metric(occ, dt_orig, m))


def d1_sweep(occ, x_hat, thresholds):
    """Per-threshold D1 sums of a batch of blocks, one EDT of the
    candidate set per threshold (plain torch).

    :param occ: [N, B, B, B] original occupancy ({0, 1}).
    :param x_hat: [N, B, B, B] decoded probabilities.
    :param thresholds: [T] ascending f32 tensor.
    :return: (ab_sum, ba_sum, count [N, T] f32, dt_orig [N, B, B, B]);
        from the first empty candidate set on, (INF, 0, 0).
    """
    from pcc_geo_cnn_v2_tpu_torch.ops.edt_sweep import d1_sweep_sums_plain

    dt_orig = squared_edt(occ > 0)
    ab, ba, cnt = d1_sweep_sums_plain(x_hat, occ, dt_orig, thresholds)
    return ab, ba, cnt, dt_orig


def select_thresholds_d1_batch(occ, x_hat, thresholds,
                               opt_metrics=("d1_mse",),
                               max_deltas=(np.inf,)):
    """Best threshold index per (max_delta × opt_metric), exact EDT sweep
    in plain torch (the ``xla`` backend): [N, M] int32."""
    ab, ba, cnt, dt_orig = d1_sweep(occ, x_hat, thresholds)
    return _select_on_grid(ab, ba, cnt, occ, dt_orig, opt_metrics,
                           max_deltas)


def select_thresholds_d1(occ, x_hat, thresholds, opt_metrics=("d1_mse",),
                         max_deltas=(np.inf,)):
    """One block ([B, B, B] inputs) through
    :func:`select_thresholds_d1_batch`: [M] int32."""
    return select_thresholds_d1_batch(occ[None], x_hat[None], thresholds,
                                      opt_metrics, max_deltas)[0]


def select_thresholds_d1_pallas(occ, x_hat, thresholds,
                                opt_metrics=("d1_mse",),
                                max_deltas=(np.inf,), pts=None):
    """Batched selection on the sums of kernel K5 (``ops/edt_sweep.py``).

    Identical picks to :func:`select_thresholds_d1_batch`. Passing
    ``pts`` (the occupied-voxel lists the encoder already holds) moves the
    sparse-tail thresholds onto the points × candidates prefix-min path.
    """
    from pcc_geo_cnn_v2_tpu_torch.ops.edt_sweep import d1_sweep_sums

    ab, ba, cnt, dt_orig = d1_sweep_sums(x_hat, occ, thresholds, pts=pts)
    return _select_on_grid(ab, ba, cnt, occ, dt_orig, opt_metrics,
                           max_deltas)

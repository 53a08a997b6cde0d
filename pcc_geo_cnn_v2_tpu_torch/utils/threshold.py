"""Adaptive per-block threshold selection on the host (KD-trees).

The port's own copy of ``pcc_geo_cnn_v2_tpu/utils/threshold.py``: the
selection semantics of the reference's ``model_opt.py`` — candidate sets
stop at the first empty threshold, ``max_delta`` ratio filters fall back
to the unfiltered list when they eliminate everything, argmin takes the
first minimum, and a block whose best candidate loses to the single
centroid point is emptied (``max_idx``). ``ops/threshold_sweep.py`` is
the batched device sweep with the same semantics; this is its
executable specification and the encoder's host path
(``BlockCodec.compress_blocks``).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from pcc_geo_cnn_v2_tpu_torch.utils.metrics import (
    compute_metrics,
    validate_opt_metrics,
)

__all__ = ["build_points_threshold", "compute_optimal_thresholds"]


def build_points_threshold(x_hat, thresholds, len_block, max_delta=np.inf):
    """Candidate point sets per threshold, stopping at the first empty one.

    :return: list of (threshold_idx, points) whose sizes pass the
        ``1/max_delta < len(points)/len_block < max_delta`` filter.
    """
    out = []
    for i, t in enumerate(thresholds):
        pa = np.argwhere(x_hat > t).astype("float32")
        if len(pa) == 0:
            break
        ratio = len(pa) / len_block
        if (1 / max_delta) < ratio < max_delta:
            out.append((i, pa))
    return out


def compute_optimal_thresholds(block, x_hat, thresholds, resolution,
                               normals=None, opt_metrics=("d1_mse",),
                               max_deltas=(np.inf,), fixed_threshold=False):
    """Best threshold index per (max_delta × opt_metric) combination.

    :param block: [N, 3+] original points of the block (local coords).
    :param x_hat: [B, B, B] decoded occupancy probabilities in [0, 1].
    :param thresholds: ascending threshold grid (e.g. linspace(0, 1, 256)).
    :param resolution: PSNR peak is resolution-1 (selection reads no PSNR).
    :param normals: optional [N, 3] normals enabling d2 metrics.
    :param fixed_threshold: every pick is the middle index
        ``len(thresholds) // 2``, with no sweep.
    :return: (metric_names, best_threshold_idxs), names formatted
        ``{opt_metric}_{max_delta}`` in max_delta-major order.
    """
    validate_opt_metrics(opt_metrics, with_normals=normals is not None)
    assert len(max_deltas) > 0
    names = [f"{m}_{d}" for d in max_deltas for m in opt_metrics]
    n_out = len(max_deltas) * len(opt_metrics)
    max_idx = len(thresholds) - 1

    if fixed_threshold:
        return names, [len(thresholds) // 2] * n_out

    pa_list = build_points_threshold(x_hat, thresholds, len(block))
    if len(pa_list) == 0:
        return names, [max_idx] * n_out

    t1 = cKDTree(block[:, :3], balanced_tree=False)
    pa_metrics = [
        compute_metrics(block[:, :3], pa, resolution - 1, p1_n=normals, t1=t1)
        for _, pa in pa_list
    ]
    centroid = np.round(np.mean(block[:, :3], axis=0))[None, :]
    mean_point = compute_metrics(block[:, :3], centroid, resolution - 1,
                                 p1_n=normals, t1=t1)

    best = []
    for max_delta in max_deltas:
        cur_pa_list, cur_metrics = pa_list, pa_metrics
        if max_delta is not None and np.isfinite(max_delta):
            keep = [i for i, (_, pa) in enumerate(pa_list)
                    if (1 / max_delta) < len(pa) / len(block) < max_delta]
            if keep:
                cur_pa_list = [pa_list[i] for i in keep]
                cur_metrics = [pa_metrics[i] for i in keep]
        for metric in opt_metrics:
            k = int(np.argmin([m[metric] for m in cur_metrics]))
            # the single centroid beats the net output: an empty block
            best.append(max_idx if cur_metrics[k][metric] > mean_point[metric]
                        else cur_pa_list[k][0])
    assert len(best) == len(names)
    return names, best

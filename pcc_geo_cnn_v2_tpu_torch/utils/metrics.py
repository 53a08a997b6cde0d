"""Host-side D1 (point-to-point) / D2 (point-to-plane) geometry metrics.

The port's own copy of ``pcc_geo_cnn_v2_tpu/utils/metrics.py``: symmetric
max/min convention of mpeg-pcc-dmetric, PSNR peak energy 3r², NN-vote
normal transfer (``assign_attr``). KD-trees on the host (scipy); this is
the yardstick the device-side full-cloud metrics are held against.
"""

from __future__ import annotations

import numpy as np

__all__ = ["assign_attr", "compute_metrics", "metrics_from_nn",
           "nn_maps_from_identities", "psnr",
           "avail_opt_metrics", "validate_opt_metrics"]

_STEMS = ("sum_AB", "sum_BA", "sum_max", "sum_mean", "mse_AB", "mse_BA",
          "mse")
# the set (and order) the JAX package accepts
avail_opt_metrics = [f"{d}_{m}" for d in ("d1", "d2") for m in _STEMS]


def validate_opt_metrics(opt_metrics, with_normals=False):
    for m in opt_metrics:
        assert m in avail_opt_metrics, f"{m} not in {avail_opt_metrics}"
        if not with_normals:
            assert not m.startswith("d2"), f"{m} needs normals"


def psnr(mse, max_energy):
    if np.ndim(mse) == 0 and mse == 0:
        return np.inf  # perfect reconstruction (numpy would warn-and-inf)
    return 10 * np.log10(max_energy / mse)


def assign_attr(attr1, idx1, idx2):
    """Transfer attributes from set 1 to set 2 by NN voting.

    :param attr1: [N1, A] attributes on set 1.
    :param idx1: [N2] NN index of each set-2 point within set 1.
    :param idx2: [N1] NN index of each set-1 point within set 2.
    :return: [N2, A] averaged attributes (set-1 points vote at their NN in
        set 2; orphan set-2 points take their own NN's attribute).
    """
    n2 = idx1.shape[0]
    counts = np.zeros(n2)
    sums = np.zeros((n2, attr1.shape[1]))
    np.add.at(counts, idx2, 1.0)
    np.add.at(sums, idx2, attr1)
    orphan = counts == 0
    counts[orphan] = 1.0
    sums[orphan] = attr1[idx1[orphan]]
    return sums / counts[:, None]


def metric_dict(prefix, ab_sum, ba_sum, n_a, n_b, max_energy):
    """The 10 ``{prefix}_*`` keys from directional sums and counts."""
    mse_ab, mse_ba = ab_sum / n_a, ba_sum / n_b
    return {
        f"{prefix}_sum_AB": ab_sum,
        f"{prefix}_sum_BA": ba_sum,
        f"{prefix}_sum_max": max(ab_sum, ba_sum),
        f"{prefix}_sum_mean": (ab_sum + ba_sum) / 2,
        f"{prefix}_mse_AB": mse_ab,
        f"{prefix}_mse_BA": mse_ba,
        f"{prefix}_mse": max(mse_ab, mse_ba),
        f"{prefix}_psnr_AB": psnr(mse_ab, max_energy),
        f"{prefix}_psnr_BA": psnr(mse_ba, max_energy),
        f"{prefix}_psnr": min(psnr(mse_ab, max_energy),
                              psnr(mse_ba, max_energy)),
    }


def compute_metrics(p1, p2, r, p1_n=None, t1=None):
    """Full symmetric D1 (and D2 when normals given) metric dict.

    :param p1: [N1, 3] reference points.
    :param p2: [N2, 3] candidate points.
    :param r: peak value (resolution - 1); PSNR peak energy is 3r².
    :param p1_n: optional [N1, 3] normals on p1 (enables d2_*).
    :param t1: optional prebuilt cKDTree over p1.
    """
    from scipy.spatial import cKDTree

    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    if len(p1) == 0 or len(p2) == 0:
        # degenerate cloud (a model decoding to nothing): unusable quality
        out = {}
        for k in ["d1"] + (["d2"] if p1_n is not None else []):
            out.update({f"{k}_{s}": np.inf for s in _STEMS})
            out.update({f"{k}_{s}": -np.inf
                        for s in ("psnr_AB", "psnr_BA", "psnr")})
        return out
    if t1 is None:
        t1 = cKDTree(p1, balanced_tree=False)
    t2 = cKDTree(p2, balanced_tree=False)
    _, idx2 = t2.query(p1, workers=-1)  # NN of p1 in p2
    _, idx1 = t1.query(p2, workers=-1)  # NN of p2 in p1
    return metrics_from_nn(p1, p2, r, idx1, idx2, p1_n=p1_n)


def metrics_from_nn(p1, p2, r, idx1, idx2, p1_n=None):
    """The metric dict of :func:`compute_metrics` from given NN maps:
    ``idx1[j]`` the row of p1 nearest to p2[j], ``idx2[i]`` the row of p2
    nearest to p1[i]. With a device path's NN identities it tells whether
    that path and the KD-tree differ by tie-broken neighbours alone."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    max_energy = 3.0 * r * r
    p1_ngb, p2_ngb = p2[idx2], p1[idx1]
    metrics = metric_dict(
        "d1", float(np.sum((p1 - p1_ngb) ** 2)),
        float(np.sum((p2 - p2_ngb) ** 2)), len(p1), len(p2), max_energy)
    if p1_n is not None:
        p1_n = np.asarray(p1_n, np.float64)
        p2_n = assign_attr(p1_n, idx1, idx2)

        def plane(a, b_of_a, n_of_a):
            return float(np.sum(np.sum((a - b_of_a) * n_of_a, axis=1) ** 2))

        metrics.update(metric_dict(
            "d2", plane(p1, p1_ngb, p2_n[idx2]),
            plane(p2, p2_ngb, p1_n[idx1]), len(p1), len(p2), max_energy))
    return metrics


def _rows_of(cloud, queries):
    """Row in the integer cloud ``cloud`` (unique rows) of every row of
    ``queries``; raises if one is not a point of the cloud."""
    cloud = np.asarray(cloud, np.int64)
    queries = np.asarray(queries, np.int64)
    span = int(max(cloud.max(), queries.max())) + 1
    assert cloud.min() >= 0 and queries.min() >= 0 and span < 1 << 21

    def key(c):
        return (c[:, 0] * span + c[:, 1]) * span + c[:, 2]

    keys = key(cloud)
    order = np.argsort(keys)
    pos = np.minimum(np.searchsorted(keys[order], key(queries)),
                     len(keys) - 1)
    if not np.array_equal(keys[order][pos], key(queries)):
        raise ValueError("a neighbour identity is not a point of the cloud")
    return order[pos]


def nn_maps_from_identities(p1, p2, a_glob, a_tgt, b_glob, b_tgt):
    """NN maps given as coordinates → the index form ``(idx1, idx2)`` of
    :func:`metrics_from_nn`. ``a_glob`` / ``b_glob`` are p1 / p2 in any row
    order, ``a_tgt[i]`` the point of p2 taken as nearest to ``a_glob[i]``,
    ``b_tgt[j]`` the point of p1 taken as nearest to ``b_glob[j]``. Raises
    if a coordinate is not a point of its cloud or a cloud is covered
    other than once."""
    ia, ib = _rows_of(p1, a_glob), _rows_of(p2, b_glob)
    for rows, cloud in ((ia, p1), (ib, p2)):
        if len(rows) != len(cloud) or len(np.unique(rows)) != len(cloud):
            raise ValueError("the identities do not cover the cloud once")
    idx2 = np.empty(len(p1), np.int64)
    idx2[ia] = _rows_of(p2, a_tgt)
    idx1 = np.empty(len(p2), np.int64)
    idx1[ib] = _rows_of(p1, b_tgt)
    return idx1, idx2

"""Per-block threshold selection from swept D1 / D2 sums (batched torch).

Port of ``pcc_geo_cnn_v2_tpu/ops/threshold_sweep.py``: the selection core
(``D1_METRICS`` / ``D2_METRICS``, ``_metrics_from_sums``,
``_select_from_sweep``), batched over blocks instead of ``vmap``-ed, and
the grid-based exact D1 sweeps built on it:

- :func:`select_thresholds_d1_batch` — the ``xla`` backend: per threshold
  one EDT of the candidate set, all in plain torch (:func:`d1_sweep`);
- :func:`select_thresholds_d1_pallas` — the same selection on the sums of
  kernel K5 (``ops/edt_sweep.py``); the name is the JAX package's.

and the d2 (point-to-plane) sweeps, plain torch as in the JAX package:

- :func:`d2_sweep` / :func:`select_thresholds_device` — on voxelized
  normals, one argmin EDT of the candidate set per threshold, the
  reference's vote-mean normal transfer with its orphan fallback;
- :func:`d2_sweep_pts` / :func:`select_thresholds_device_pts` — the same
  votes over the per-point normal lists the encoder holds, original-side
  normals riding the EDT carries; ``band`` bounds the EDT passes (the
  codec's ``d2_band``).

The normal votes are summed per candidate voxel in 2^-32 fixed point
(int64), so their result does not depend on the order in which the votes
land: on the card ``index_add_`` runs as atomics in no fixed order, and
float sums in that order could pick other d2 thresholds from run to run.
The JAX package sums the votes in f32 (``.at[].add``); the two differ by
rounding only.

Selection reproduces the reference's ``model_opt.py:21-77`` semantics
exactly: candidate lists stop at the first empty threshold, max_delta
ratio filters fall back to the unfiltered list, first-minimum argmin, and
the centroid failure guard. All metric arithmetic is f32, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from pcc_geo_cnn_v2_tpu_torch.ops.edt import (
    INF,
    banded_squared_edt_argmin,
    squared_edt,
    squared_edt_argmin,
    squared_edt_carry,
)
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import voxelize_attrs

__all__ = ["D1_METRICS", "D2_METRICS", "metrics_from_sums",
           "select_from_sweep", "d1_sweep", "d2_sweep", "d2_sweep_pts",
           "select_thresholds_d1", "select_thresholds_d1_batch",
           "select_thresholds_d1_pallas", "select_thresholds_device",
           "select_thresholds_device_pts"]

D1_METRICS = ("d1_sum_AB", "d1_sum_BA", "d1_sum_max", "d1_sum_mean",
              "d1_mse_AB", "d1_mse_BA", "d1_mse")
D2_METRICS = tuple(m.replace("d1", "d2") for m in D1_METRICS)
# voxels of one [N, thresholds, B, B, B] candidate-mask batch of the d2
# sweeps: the threshold chunk is sized to it (32 blocks of 64³: 2 a chunk;
# the vote buffers then hold 0.5 GB)
D2_CHUNK_VOXELS = 1 << 24
_VOTE_SCALE = 2.0 ** 32  # fixed point of the normal vote sums


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


def _check_metrics(opt_metrics, have_normals):
    for m in opt_metrics:
        assert m in D1_METRICS + D2_METRICS, m
    if any(m in D2_METRICS for m in opt_metrics) and not have_normals:
        raise ValueError("d2 opt metrics need normals")


def _select_on_grid(ab, ba, cnt, occ, dt_orig, opt_metrics, max_deltas,
                    d2=None, d2_guard=None):
    """Selection from the d1 sums (and ``d2``, a dict of d2_* arrays with
    its centroid guard ``d2_guard``: metric → [N]) of a batch of blocks."""
    _check_metrics(opt_metrics, d2 is not None)
    n_orig = (occ > 0).sum(dim=(1, 2, 3)).to(torch.float32)
    sweep = metrics_from_sums(ab, ba, torch.clamp_min(n_orig, 1)[:, None],
                              cnt)
    sweep["count"] = cnt
    sweep.update(d2 or {})

    def guard_fn(metric):
        if metric in D2_METRICS:
            return d2_guard(metric)
        return _centroid_guard_metric(occ, dt_orig, metric)

    return select_from_sweep(sweep, n_orig, opt_metrics, max_deltas,
                             guard_fn=guard_fn)


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


# -- d2 (point-to-plane) sweeps ------------------------------------------


def _grid_coords(size, device):
    """[B, B, B, 3] f32 coordinates of every voxel of a block."""
    ii = torch.arange(size, dtype=torch.float32, device=device)
    return torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"), dim=-1)


def _flat_coords(flat, size):
    """Flat voxel indices → [..., 3] f32 coordinates."""
    flat = flat.to(torch.int64)
    return torch.stack([flat // (size * size), (flat // size) % size,
                        flat % size], dim=-1).to(torch.float32)


def _flat_index(nn, size):
    """[..., 3] int coordinates → flat voxel indices (int64)."""
    nn = nn.to(torch.int64)
    return (nn[..., 0] * size + nn[..., 1]) * size + nn[..., 2]


def _vote_sums(tgt, w, vals, n_slots):
    """Votes of rows onto slots, summed per slot in a fixed order.

    :param tgt: [R, V] int slot of every voter, in [0, n_slots).
    :param w: [R, V] f32 {0, 1} voter weights.
    :param vals: [R, V, 3] f32 voted values.
    :return: (count [R, n_slots] int64, sums [R, n_slots, 3] f32): integer
        counts, and value sums in 2^-32 fixed point rounded to f32 once.
    """
    R, V = tgt.shape
    idx = (tgt.to(torch.int64) + n_slots * torch.arange(
        R, device=tgt.device)[:, None]).reshape(-1)
    wi = w.reshape(-1).to(torch.int64)
    fx = torch.round(vals.to(torch.float64) * w[..., None]
                     * _VOTE_SCALE).to(torch.int64).reshape(-1, 3)
    cnt = torch.zeros(R * n_slots, dtype=torch.int64,
                      device=tgt.device).index_add_(0, idx, wi)
    sums = torch.zeros(R * n_slots, 3, dtype=torch.int64,
                       device=tgt.device).index_add_(0, idx, fx)
    return (cnt.view(R, n_slots),
            (sums.to(torch.float64) / _VOTE_SCALE).to(torch.float32)
            .view(R, n_slots, 3))


def _d2_sums(x_hat, thresholds, ba_field, n_orig, ab_fn):
    """The d2 metric dict of a batch of blocks, thresholds in chunks of
    ``D2_CHUNK_VOXELS``: per chunk the candidate masks [N, c, B, B, B],
    their counts, their BA sums over ``ba_field`` and ``ab_fn(masks)``
    ([N, c] AB sums)."""
    n, size, T = x_hat.shape[0], x_hat.shape[-1], thresholds.shape[0]
    step = max(1, D2_CHUNK_VOXELS // (n * size ** 3))
    ab, ba, cnt = [], [], []
    for lo in range(0, T, step):
        masks = x_hat[:, None] > thresholds[lo:lo + step, None, None, None]
        cnt.append(masks.sum(dim=(2, 3, 4)))
        ba.append(torch.where(masks, ba_field[:, None], 0.0).sum(
            dim=(2, 3, 4)))
        ab.append(ab_fn(masks))
    cnt = torch.cat(cnt, 1).to(torch.float32)
    out = metrics_from_sums(torch.cat(ab, 1), torch.cat(ba, 1),
                            torch.clamp_min(n_orig, 1)[:, None], cnt,
                            prefix="d2")
    out["count"] = cnt
    return out


def _at(field, idx):
    """``field`` [N, B, B, B, ...] read at flat voxel indices [N, M]."""
    n = field.shape[0]
    flat = field.reshape(n, -1, *field.shape[4:])
    return flat[torch.arange(n, device=idx.device)[:, None], idx]


def d2_sweep(occ, normals, x_hat, thresholds):
    """Per-threshold D2 (point-to-plane) sums of a batch of blocks on
    voxelized normals (the reference's ``pc_metric.py:109-124`` transfer:
    a candidate's normal is the mean of the originals voting for it through
    their nearest candidate, orphans take their own nearest original's).

    :param occ: [N, B, B, B] original occupancy.
    :param normals: [N, B, B, B, 3] normals at occupied voxels.
    :param x_hat: [N, B, B, B] decoded probabilities.
    :param thresholds: [T] ascending f32 tensor.
    :return: dict of [N, T] d2_* metric arrays + ``count``.
    """
    n, size = occ.shape[0], occ.shape[-1]
    dev = occ.device
    occ_b = occ > 0
    occ_f = occ_b.to(torch.float32)
    n_orig = occ_f.sum(dim=(1, 2, 3))
    coords = _grid_coords(size, dev)
    normals = normals.to(torch.float32)
    _, nn_o = squared_edt_argmin(occ_b)
    n_o = _at(normals, _flat_index(nn_o, size).reshape(n, -1)).view(
        normals.shape)
    ba_field = ((coords - nn_o.to(torch.float32)) * n_o).sum(-1) ** 2
    vol = size ** 3

    def ab_fn(masks):
        c = masks.shape[1]
        _, nn_c = squared_edt_argmin(masks)  # [N, c, B, B, B, 3]
        tgt = _flat_index(nn_c, size).reshape(n * c, vol)
        votes, sums = _vote_sums(
            tgt, occ_f.reshape(n, 1, vol).expand(n, c, vol).reshape(n * c,
                                                                    vol),
            normals.reshape(n, 1, vol, 3).expand(n, c, vol, 3).reshape(
                n * c, vol, 3), vol)
        p2n = torch.where((votes > 0)[..., None],
                          sums / torch.clamp_min(votes, 1)[..., None],
                          n_o.reshape(n, 1, vol, 3).expand(n, c, vol, 3)
                          .reshape(n * c, vol, 3))
        n_eff = torch.gather(p2n, 1, tgt[..., None].expand(-1, -1, 3))
        ab_field = ((coords.reshape(1, vol, 3) - nn_c.reshape(n * c, vol, 3)
                     .to(torch.float32)) * n_eff).sum(-1) ** 2
        return torch.where(occ_b.reshape(n, 1, vol), ab_field.view(
            n, c, vol), 0.0).sum(-1)

    return _d2_sums(x_hat, thresholds, ba_field, n_orig, ab_fn)


def _d2_pts_fields(occ_b, ngrid):
    """Original-side D2 fields of a batch of blocks from ONE carry-EDT:
    (dt_orig, ba_field, of, n_o) — the squared EDT of the occupancy, the
    per-voxel candidate→original plane-distance field, the carried flat
    index of each voxel's nearest original (f32) and that original's
    normal, all [N, B, B, B] (n_o [N, B, B, B, 3])."""
    size = occ_b.shape[-1]
    flat_iota = torch.arange(size ** 3, dtype=torch.float32,
                             device=occ_b.device).view(size, size, size)
    ngrid = ngrid.to(torch.float32)
    dt_orig, (of, onx, ony, onz) = squared_edt_carry(
        occ_b, [flat_iota, ngrid[..., 0], ngrid[..., 1], ngrid[..., 2]])
    n_o = torch.stack([onx, ony, onz], dim=-1)
    nn_o = _flat_coords(of.to(torch.int32), size)
    ba_field = ((_grid_coords(size, occ_b.device) - nn_o) * n_o).sum(-1) ** 2
    return dt_orig, ba_field, of, n_o


def _pts_parts(pts, size):
    """(valid weights [N, P] f32, original counts [N] f32, flat voxel
    index [N, P] int64, f32 coordinates [N, P, 3]) of padded point lists
    (padding rows -1, read as voxel 0 with weight 0)."""
    valid = pts[..., 0] >= 0
    vf = valid.to(torch.float32)
    pts_c = torch.where(valid[..., None], pts.to(torch.int64), 0)
    return vf, vf.sum(-1), _flat_index(pts_c, size), pts_c.to(torch.float32)


def d2_sweep_pts(occ, pts, nrm, x_hat, thresholds, ngrid=None, band=None,
                 fields=None):
    """Point-based per-threshold D2 sums of a batch of blocks.

    The same sums as :func:`d2_sweep` (``band=None``), with the vote-mean
    normal transfer run over the ≤ P original points: original p votes its
    normal onto its nearest candidate, and AB reads the mean at that same
    candidate (which has ≥ 1 vote, so the orphan fallback is never read).

    :param occ: [N, B, B, B] original occupancy.
    :param pts: [N, P, 3] int occupied coordinates, -1 rows = padding.
    :param nrm: [N, P, 3] f32 per-point normals (padding rows ignored).
    :param x_hat: [N, B, B, B] decoded probabilities.
    :param thresholds: [T] ascending f32 tensor.
    :param ngrid: optional [N, B, B, B, 3] voxelized normals (built from
        ``pts`` / ``nrm`` when absent).
    :param band: None = exact argmin EDT per threshold; an int k = banded
        EDT, exact wherever every original is within k voxels of the
        candidate set; an unresolved point is charged its banded distance
        (> k², an upper bound) instead of its plane distance.
    :param fields: optional :func:`_d2_pts_fields` result to reuse.
    :return: dict of [N, T] d2_* metric arrays + ``count``.
    """
    n, size = occ.shape[0], occ.shape[-1]
    P = pts.shape[1]
    occ_b = occ > 0
    vf, n_orig, flat_p, pts_f = _pts_parts(pts, size)
    nrm = nrm.to(torch.float32)
    if ngrid is None:
        ngrid = voxelize_attrs(pts, nrm, size)
    if fields is None:
        fields = _d2_pts_fields(occ_b, ngrid)

    def ab_fn(masks):
        c = masks.shape[1]
        at_p = flat_p[:, None, :].expand(n, c, P)
        if band is None:
            nnf = _flat_index(squared_edt_argmin(masks)[1], size)
        else:
            dist, nnf = banded_squared_edt_argmin(masks, band)
            d_p = torch.gather(dist.reshape(n, c, -1), 2, at_p)
        c_p = torch.gather(nnf.reshape(n, c, -1).to(torch.int64), 2, at_p)
        tgt = c_p.reshape(n * c, P)
        votes, sums = _vote_sums(
            tgt, vf[:, None].expand(n, c, P).reshape(n * c, P),
            nrm[:, None].expand(n, c, P, 3).reshape(n * c, P, 3), size ** 3)
        n_eff = (torch.gather(sums, 1, tgt[..., None].expand(-1, -1, 3))
                 / torch.clamp_min(torch.gather(votes, 1, tgt), 1)[..., None])
        ab_p = ((pts_f[:, None] - _flat_coords(c_p, size))
                * n_eff.view(n, c, P, 3)).sum(-1) ** 2
        if band is not None:
            ab_p = torch.where(d_p <= float(band * band), ab_p, d_p)
        return (ab_p * vf[:, None]).sum(-1)

    return _d2_sums(x_hat, thresholds, fields[1], n_orig, ab_fn)


def _centroid_guard_metric_d2(occ, normals, nn_o, n_o, metric):
    """D2 metric of the single centroid point per block (the reference's
    guard with normals): all originals vote for the centroid, so its
    normal is the mean original normal; BA reads the centroid's nearest
    original (``nn_o`` [N, B, B, B, 3]) and its normal (``n_o``): [N]."""
    n_blocks, size = occ.shape[0], occ.shape[-1]
    occ_b = occ > 0
    w = occ_b.to(torch.float32)[..., None]
    n1 = torch.clamp_min(w.sum(dim=(1, 2, 3, 4)), 1)
    coords = _grid_coords(size, occ.device)
    # exact integer coordinate sums, rounded to f32 once
    s1 = (coords.to(torch.float64) * w).sum(dim=(1, 2, 3)).to(torch.float32)
    c = torch.round(s1 / n1[:, None])
    n_bar = (normals.to(torch.float32) * w).sum(dim=(1, 2, 3)) / n1[:, None]
    ab_sum = torch.where(
        occ_b, ((coords - c[:, None, None, None]) * n_bar[:, None, None, None]
                ).sum(-1) ** 2, 0.0).sum(dim=(1, 2, 3))
    ci = _flat_index(torch.clamp(c.to(torch.int64), 0, size - 1), size)
    nn_at_c = _at(nn_o, ci[:, None])[:, 0].to(torch.float32)
    n_at_c = _at(n_o, ci[:, None])[:, 0]
    ba_sum = ((c - nn_at_c) * n_at_c).sum(-1) ** 2
    return metrics_from_sums(ab_sum, ba_sum, n1, 1, prefix="d2")[metric]


def _centroid_guard_metric_d2_pts(pts_f, vf, nrm, n_orig, of, n_o, metric):
    """Point-based twin of :func:`_centroid_guard_metric_d2` (same values:
    occupied voxels ≡ valid points; ``of`` / ``n_o`` from
    :func:`_d2_pts_fields`): [N]."""
    size = of.shape[-1]
    n1 = torch.clamp_min(n_orig, 1)
    w = vf[..., None]
    s1 = (pts_f.to(torch.float64) * w).sum(1).to(torch.float32)
    c = torch.round(s1 / n1[:, None])
    n_bar = (nrm.to(torch.float32) * w).sum(1) / n1[:, None]
    ab_sum = (vf * ((pts_f - c[:, None]) * n_bar[:, None]).sum(-1) ** 2
              ).sum(-1)
    ci = _flat_index(torch.clamp(c.to(torch.int64), 0, size - 1), size)
    nn_at_c = _flat_coords(_at(of, ci[:, None])[:, 0], size)
    n_at_c = _at(n_o, ci[:, None])[:, 0]
    ba_sum = ((c - nn_at_c) * n_at_c).sum(-1) ** 2
    return metrics_from_sums(ab_sum, ba_sum, n1, 1, prefix="d2")[metric]


def select_thresholds_device(occ, x_hat, thresholds, normals=None,
                             opt_metrics=("d1_mse",), max_deltas=(np.inf,)):
    """Best threshold per (max_delta × opt_metric), d1 and / or d2
    metrics, on the grid sweeps: [N, M] int32. d2_* metrics need
    ``normals`` [N, B, B, B, 3]."""
    _check_metrics(opt_metrics, normals is not None)
    ab, ba, cnt, dt_orig = d1_sweep(occ, x_hat, thresholds)
    d2 = d2_guard = None
    if any(m in D2_METRICS for m in opt_metrics):
        d2 = d2_sweep(occ, normals, x_hat, thresholds)
        _, nn_o = squared_edt_argmin(occ > 0)
        n_o = _at(normals.to(torch.float32), _flat_index(
            nn_o, occ.shape[-1]).reshape(len(occ), -1)).view(normals.shape)

        def d2_guard(metric):
            return _centroid_guard_metric_d2(occ, normals, nn_o, n_o, metric)

    return _select_on_grid(ab, ba, cnt, occ, dt_orig, opt_metrics,
                           max_deltas, d2, d2_guard)


def select_thresholds_device_pts(occ, x_hat, thresholds, pts, nrm,
                                 opt_metrics=("d1_mse",),
                                 max_deltas=(np.inf,), band=None):
    """Best threshold per (max_delta × opt_metric), d1 and / or d2, from
    the per-point normal lists the encoder holds: [N, M] int32.

    The d1 sums are :func:`d1_sweep`'s (plain torch, one EDT a threshold);
    the d2 sums :func:`d2_sweep_pts`'s with ``band``. With ``band=None``
    the picks are :func:`select_thresholds_device`'s.

    :param occ: [N, B, B, B] original occupancy.
    :param x_hat: [N, B, B, B] decoded probabilities.
    :param pts: [N, P, 3] int occupied coordinates, -1 rows = padding.
    :param nrm: [N, P, 3] f32 per-point normals.
    """
    from pcc_geo_cnn_v2_tpu_torch.ops.edt_sweep import d1_sweep_sums_plain

    _check_metrics(opt_metrics, nrm is not None)
    size = occ.shape[-1]
    vf, n_orig, _, pts_f = _pts_parts(pts, size)
    nrm = nrm.to(torch.float32)
    fields = _d2_pts_fields(occ > 0, voxelize_attrs(pts, nrm, size))
    dt_orig, _, of, n_o = fields
    ab, ba, cnt = d1_sweep_sums_plain(x_hat, occ, dt_orig, thresholds)
    d2 = None
    if any(m in D2_METRICS for m in opt_metrics):
        d2 = d2_sweep_pts(occ, pts, nrm, x_hat, thresholds, band=band,
                          fields=fields)

    def d2_guard(metric):
        return _centroid_guard_metric_d2_pts(pts_f, vf, nrm, n_orig, of, n_o,
                                             metric)

    return _select_on_grid(ab, ba, cnt, occ, dt_orig, opt_metrics,
                           max_deltas, d2, d2_guard)

"""Exact full-cloud D1 / D2 metrics via halo-extended per-block EDTs.

Port of ``pcc_geo_cnn_v2_tpu/ops/cloud_metrics.py``. Every point is an
integer voxel of a shared octree partition, so a nearest neighbour either
lies within ``halo`` voxels of the query's block — captured exactly by an
EDT over the block's 27-neighbourhood halo volume — or the query is an
outlier, resolved on the host with a KD-tree (:func:`resolve_outliers`).

D1 needs distances only: kernel K2 (``ops/halo.py``), from the packed grids
and the neighbour table, with nothing assembled on the card. D2 needs the
neighbours' identities: a banded argmin EDT in plain torch
(:func:`blockwise_nn_offsets`, plain XLA in the JAX package too), then the
vote-mean normal transfer and the projections on the host in f64
(:func:`d2_from_identities`).
"""

from __future__ import annotations

import numpy as np
import torch

from pcc_geo_cnn_v2_tpu_torch.ops.edt import banded_squared_edt_argmin
from pcc_geo_cnn_v2_tpu_torch.ops.halo import (
    assemble_halo,
    halo_d1_packed,
    query_core,
)
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import packbits, voxelize
from pcc_geo_cnn_v2_tpu_torch.utils.metrics import metric_dict

__all__ = ["neighbor_table", "assemble_halo", "query_core",
           "blockwise_d1_sums", "blockwise_nn_offsets",
           "pack_point_lists", "blockwise_nn_identities",
           "blockwise_d2_metrics",
           "d2_from_identities",
           "resolve_outliers", "d1_metrics_from_sums"]


def neighbor_table(origins, block_size):
    """[N, 27] int32 indices of each block's 3³ neighbourhood (-1 = absent).

    Entry order is (dx, dy, dz) row-major with the block itself at 13.
    """
    origins = np.asarray(origins, np.int64)
    index = {tuple(o): i for i, o in enumerate(origins.tolist())}
    nb = np.full((len(origins), 27), -1, np.int32)
    offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]
    for i, o in enumerate(origins.tolist()):
        for j, (dx, dy, dz) in enumerate(offs):
            k = index.get((o[0] + dx * block_size, o[1] + dy * block_size,
                           o[2] + dz * block_size))
            if k is not None:
                nb[i, j] = k
    return nb


def blockwise_d1_sums(a_packed, b_packed, origins, size, halo=12, batch=64):
    """Exact full-cloud directional D1 sums between clouds A and B.

    :param a_packed: [N, B³/8] uint8 packed voxel grids (tensor, any
        device; rows past ``len(origins)`` are ignored).
    :param b_packed: same for cloud B.
    :param origins: [N, 3] block origins (shared partition).
    :param batch: blocks a step of K2's plain version (CPU tensors).
    :return: dict(ab_sum, ba_sum, n_a, n_b, outliers_a, outliers_b) —
        ``outliers_*`` are global coordinates whose NN exceeds the halo.
    """
    n = len(origins)
    dev = a_packed.device
    nb = neighbor_table(origins, size)
    zero = torch.zeros(1, a_packed.shape[1], dtype=torch.uint8, device=dev)
    a_ext = torch.cat([a_packed[:n], zero])
    b_ext = torch.cat([b_packed[:n], zero])
    idx = torch.as_tensor(np.where(nb < 0, n, nb), dtype=torch.int32,
                          device=dev)
    stats, masks = halo_d1_packed(a_ext, b_ext, idx, size=size, halo=halo,
                                  batch=batch)
    st = stats.cpu().numpy()  # [direction, (sum, n, unres_cnt), block]
    out = {"ab_sum": float(st[0, 0].sum()), "ba_sum": float(st[1, 0].sum()),
           "n_a": int(st[0, 1].sum()), "n_b": int(st[1, 1].sum())}
    origins = np.asarray(origins)
    for d, key in enumerate(("outliers_a", "outliers_b")):
        flagged = np.flatnonzero(st[d, 2])  # only their masks are fetched
        out[key] = np.zeros((0, 3))
        if len(flagged):
            rows = masks[d][torch.as_tensor(flagged, device=dev)]
            bits = np.unpackbits(rows.cpu().numpy(), axis=-1, bitorder="big")
            c = np.argwhere(bits.reshape(len(rows), size, size, size))
            out[key] = c[:, 1:] + origins[flagged[c[:, 0]]]
    return out


def blockwise_nn_offsets(qry_pts, tgt_packed, origins, size, halo=12,
                         batch=16):
    """Exact NN offsets of every query point against a blockwise target
    cloud: a banded argmin EDT over each block's halo volume; NN beyond
    ``halo`` are flagged for the host.

    :param qry_pts: [N, P, 3] int per-block padded point lists (tensor or
        array; coords < 0 are padding).
    :param tgt_packed: [N, B³/8] packed target occupancy (tensor, any
        device; rows past ``len(origins)`` are ignored).
    :return: host dict(off [N,P,3] int8, ok [N,P] bool, valid [N,P] bool).
    """
    n = len(origins)
    dev = tgt_packed.device
    H = size + 2 * halo
    nb = neighbor_table(origins, size)
    zero = torch.zeros(1, tgt_packed.shape[1], dtype=torch.uint8, device=dev)
    tgt_ext = torch.cat([tgt_packed[:n], zero])
    idx_all = torch.as_tensor(np.where(nb < 0, n, nb), dtype=torch.int64,
                              device=dev)
    qry = torch.as_tensor(qry_pts, device=dev)[:n].to(torch.int64)
    outs = {"off": [], "ok": [], "valid": []}
    for lo in range(0, n, batch):
        q = qry[lo:lo + batch]
        bs = len(q)
        vol = assemble_halo(tgt_ext[idx_all[lo:lo + batch]], size, halo)
        dist, nnf = banded_squared_edt_argmin(vol > 0, halo)
        valid = ((q >= 0) & (q < size)).all(-1)
        qh = torch.clamp(q, 0, size - 1) + halo
        flat_q = (qh[..., 0] * H + qh[..., 1]) * H + qh[..., 2]
        d_at = torch.gather(dist.reshape(bs, -1), 1, flat_q)
        nn_at = torch.gather(nnf.reshape(bs, -1), 1, flat_q).to(torch.int64)
        nn = torch.stack([nn_at // (H * H), (nn_at // H) % H, nn_at % H], -1)
        outs["off"].append((nn - qh).to(torch.int8))
        outs["ok"].append(valid & (d_at <= float(halo * halo)))
        outs["valid"].append(valid)
    return {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}


def _flat_key(coords, resolution):
    c = np.asarray(coords, np.int64)
    return (c[:, 0] * resolution + c[:, 1]) * resolution + c[:, 2]


def pack_point_lists(blocks, budget):
    """[N, budget, 3] int32 padded per-block point lists (-1 rows)."""
    out = np.full((len(blocks), budget, 3), -1, np.int32)
    for i, b in enumerate(blocks):
        out[i, :len(b)] = np.asarray(b)[:, :3]
    return out


def blockwise_nn_identities(a_pts, a_nrm, b_packed, b_blocks, origins, size,
                            points, halo=12, batch=16):
    """Both NN maps between the original cloud A and a candidate cloud B,
    in global coordinates: ``(a_glob, a_n, a_tgt, b_glob, b_tgt)`` with
    ``a_tgt[i]`` the candidate nearest to original ``a_glob[i]`` (normal
    ``a_n[i]``) and ``b_tgt[j]`` the original nearest to candidate
    ``b_glob[j]``. Identities come from banded argmin EDTs on the device
    (only int8 offsets and flags cross to the host); neighbours beyond
    ``halo`` resolve through host KD-trees. Parameters as
    :func:`blockwise_d2_metrics`.
    """
    origins = np.asarray(origins, np.int64)
    n = len(origins)
    dev = b_packed.device
    ab = blockwise_nn_offsets(a_pts, b_packed, origins, size, halo=halo,
                              batch=batch)
    budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in b_blocks)))),
                 64)
    qry_b = pack_point_lists(b_blocks, budget)
    # original occupancy re-packed from the A point lists
    a_dev = torch.as_tensor(a_pts, device=dev)[:n]
    occ_a = packbits((voxelize(a_dev, size)[..., 0] > 0).reshape(n, -1))
    ba = blockwise_nn_offsets(qry_b, occ_a, origins, size, halo=halo,
                              batch=batch)

    def flatten(pts_host, res):
        bi, pi = np.nonzero(res["valid"])
        glob = np.asarray(pts_host)[bi, pi, :3].astype(np.int64) + origins[bi]
        return glob, res["off"][bi, pi].astype(np.int64), res["ok"][bi, pi]

    a_host = a_dev.cpu().numpy()
    a_glob, a_off, a_ok = flatten(a_host, ab)
    a_n = np.asarray(a_nrm)[:n][np.nonzero(ab["valid"])].astype(np.float64)
    b_glob, b_off, b_ok = flatten(qry_b, ba)

    # out-of-halo NNs resolve on the host (the identity, not the distance)
    a_tgt = a_glob + a_off
    if not a_ok.all():
        a_tgt[~a_ok] = resolve_outliers(
            a_glob[~a_ok], b_blocks, origins, size,
            full_tree_limit=2_000_000, return_nn=True)[1]
    b_tgt = b_glob + b_off
    if not b_ok.all():
        from scipy.spatial import cKDTree

        idx = cKDTree(points[:, :3], balanced_tree=False).query(
            b_glob[~b_ok], workers=-1)[1]
        b_tgt[~b_ok] = np.asarray(points[idx, :3], np.int64)
    return a_glob, a_n, a_tgt, b_glob, b_tgt


def blockwise_d2_metrics(a_pts, a_nrm, b_packed, b_blocks, origins, size,
                         resolution, points, halo=12, batch=16,
                         with_d1=False):
    """Exact full-cloud D2 (point-to-plane) metrics.

    Semantics of ``utils/metrics.py:compute_metrics``: candidate normals
    are the vote-mean of original normals over the original→candidate NN
    map, AB projects each original point's error on its NN candidate's
    transferred normal, BA projects each candidate's error on its NN
    original's normal. NN identities come from
    :func:`blockwise_nn_identities`; votes and projections run in f64 on
    the host. Equal-distance ties may pick different neighbours than a
    KD-tree.

    :param a_pts: [N, P, 3] per-block original point lists (tensor on the
        compute device; rows past ``len(origins)`` are ignored).
    :param a_nrm: [N, P, 3] matching normals (host, f32).
    :param b_packed: [N, B³/8] candidate masks (tensor, same device).
    :param b_blocks: candidate per-block point lists (host).
    :param points: [N0, ≥6] original cloud with normal columns 3:6.
    :param with_d1: also emit d1_* keys from the same offsets.
    """
    assert np.shape(points)[1] >= 6, (
        "d2 metrics need the original cloud WITH normal columns 3:6; "
        f"got shape {np.shape(points)}")
    if sum(len(b) for b in b_blocks) == 0:
        return {"d2_psnr": -np.inf, "d1_psnr": -np.inf}
    return d2_from_identities(
        *blockwise_nn_identities(a_pts, a_nrm, b_packed, b_blocks, origins,
                                 size, points, halo=halo, batch=batch),
        points, resolution, with_d1=with_d1)


def d2_from_identities(a_glob, a_n, a_tgt, b_glob, b_tgt, points,
                       resolution, with_d1=False):
    """D2 (and optional D1) metric dict from NN maps, in f64 on the host.

    Identity-source agnostic: with KD-tree identities it reproduces
    ``compute_metrics``; with the device EDT identities only tie-broken
    neighbours can differ.

    :param a_glob / b_glob: [Na,3] / [Nb,3] original / candidate points.
    :param a_n: [Na, 3] original normals.
    :param a_tgt / b_tgt: NN of each original in the candidates / of each
        candidate in the originals.
    :param points: [N0, ≥6] original cloud (normal columns 3:6).
    """
    a_glob = np.asarray(a_glob, np.float64)
    b_glob = np.asarray(b_glob, np.float64)
    a_tgt = np.asarray(a_tgt, np.float64)
    b_tgt = np.asarray(b_tgt, np.float64)
    n_a, n_b = max(len(a_glob), 1), max(len(b_glob), 1)

    # candidate normals: vote-mean of original normals over the A→B NN
    # map (orphans never appear in either sum)
    uniq, inv = np.unique(_flat_key(a_tgt, resolution), return_inverse=True)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inv, np.asarray(a_n, np.float64))
    cnt = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
    p2_n = sums / cnt[:, None]
    ab_sum = float(np.sum(
        np.sum((a_glob - a_tgt) * p2_n[inv], axis=1) ** 2))

    # BA: original normals looked up by voxel key (original voxels unique)
    pk = _flat_key(points[:, :3], resolution)
    order = np.argsort(pk)
    pos = np.searchsorted(pk[order], _flat_key(b_tgt, resolution))
    n_at_tgt = np.asarray(points, np.float64)[order[pos], 3:6]
    ba_sum = float(np.sum(
        np.sum((b_glob - b_tgt) * n_at_tgt, axis=1) ** 2))

    max_energy = 3.0 * (resolution - 1) ** 2
    out = metric_dict("d2", ab_sum, ba_sum, n_a, n_b, max_energy)
    if with_d1:
        out.update(metric_dict(
            "d1", float(np.sum((a_glob - a_tgt) ** 2)),
            float(np.sum((b_glob - b_tgt) ** 2)), n_a, n_b, max_energy))
    return out


def build_cloud_tree(blocks, origins):
    """KD-tree over a blockwise cloud in global coordinates (None if empty)."""
    from scipy.spatial import cKDTree

    origins = np.asarray(origins, np.float32)
    pts = [np.asarray(b)[:, :3].astype(np.float32) + o
           for b, o in zip(blocks, origins) if len(b)]
    if not pts:
        return None
    return cKDTree(np.vstack(pts), balanced_tree=False)


def resolve_outliers(queries, blocks, origins, size,
                     full_tree_limit=20_000_000, return_nn=False):
    """Exact NN dist² of each query against a blockwise cloud.

    Clouds up to ``full_tree_limit`` points take one KD-tree over the whole
    cloud. Beyond it: per ring level r, one tree over the union of blocks
    within Chebyshev r of every pending query's cell; a result is certified
    when d ≤ r·size.

    :param return_nn: also return the NN coordinates [Q, 3] int64 (D2
        needs the identity, not just the distance).
    """
    from scipy.spatial import cKDTree

    queries = np.asarray(queries, np.float64)
    origins = np.asarray(origins, np.int64)
    n_total = sum(len(b) for b in blocks)

    def ret(d2, nn):
        return (d2, nn) if return_nn else d2

    if n_total <= full_tree_limit:
        tree = build_cloud_tree(blocks, origins)
        if tree is None:  # empty candidate cloud: no finite NN distance
            return ret(np.full(len(queries), np.inf),
                       np.zeros((len(queries), 3), np.int64))
        d, idx = tree.query(queries[:, :3], workers=-1)
        return ret(d ** 2, np.asarray(tree.data)[idx].astype(np.int64))
    omap = {tuple(o): i for i, o in enumerate((origins // size).tolist())}
    max_ring = int(np.ceil((origins.max() + size) / size)) \
        if len(origins) else 1
    out = np.empty(len(queries))
    out_nn = np.zeros((len(queries), 3), np.int64)
    qcell = (queries[:, :3] // size).astype(np.int64)
    pending = np.arange(len(queries))
    for ring in range(1, max_ring + 1):
        if not len(pending):
            break
        ids = set()
        for cell in np.unique(qcell[pending], axis=0).tolist():
            for dx in range(-ring, ring + 1):
                for dy in range(-ring, ring + 1):
                    for dz in range(-ring, ring + 1):
                        k = omap.get((cell[0] + dx, cell[1] + dy,
                                      cell[2] + dz))
                        if k is not None:
                            ids.add(k)
        pts = [blocks[i][:, :3] + origins[i] for i in ids if len(blocks[i])]
        if not pts:
            continue
        stacked = np.vstack(pts)
        d, idx = cKDTree(stacked, balanced_tree=False).query(
            queries[pending, :3], workers=-1)
        done = (d <= ring * size) | (ring >= max_ring)
        out[pending[done]] = d[done] ** 2
        out_nn[pending[done]] = stacked[idx[done]].astype(np.int64)
        pending = pending[~done]
    return ret(out, out_nn)


def d1_metrics_from_sums(sums, r, points_a, points_b=None, resolve_a=None):
    """Reference-identical D1 metric dict from blockwise sums. A-outliers
    resolve via ``resolve_a`` (coords → dist²) or a host KD-tree over
    ``points_b``; B-outliers via a KD-tree over ``points_a``."""
    def _kd(points):
        from scipy.spatial import cKDTree

        tree = cKDTree(points, balanced_tree=False)
        return lambda coords: tree.query(coords, workers=-1)[0] ** 2

    ab_sum, ba_sum = sums["ab_sum"], sums["ba_sum"]
    if len(sums["outliers_a"]):
        fn = resolve_a or _kd(points_b)
        ab_sum += float(np.sum(fn(sums["outliers_a"])))
    if len(sums["outliers_b"]):
        fn = _kd(points_a)
        ba_sum += float(np.sum(fn(sums["outliers_b"])))
    return metric_dict("d1", ab_sum, ba_sum, max(sums["n_a"], 1),
                       max(sums["n_b"], 1), 3.0 * r * r)

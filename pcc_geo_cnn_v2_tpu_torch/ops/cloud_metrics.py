"""Exact full-cloud D1 metrics via halo-extended per-block EDTs.

Port of the D1 half of ``pcc_geo_cnn_v2_tpu/ops/cloud_metrics.py``. Every
point is an integer voxel of a shared octree partition, so a nearest
neighbour either lies within ``halo`` voxels of the query's block —
captured exactly by an EDT over the block's 27-neighbourhood halo volume
(kernel K2, ``ops/halo.py``) — or the query is an outlier, resolved on the
host with a KD-tree (:func:`resolve_outliers`).
"""

from __future__ import annotations

import numpy as np
import torch

from pcc_geo_cnn_v2_tpu_torch.ops.halo import halo_d1_dir
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import unpackbits
from pcc_geo_cnn_v2_tpu_torch.utils.metrics import psnr

__all__ = ["neighbor_table", "assemble_halo", "query_core",
           "blockwise_d1_sums",
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


def blockwise_d1_sums(a_packed, b_packed, origins, size, halo=12, batch=64):
    """Exact full-cloud directional D1 sums between clouds A and B.

    :param a_packed: [N, B³/8] uint8 packed voxel grids (tensor, any
        device; rows past ``len(origins)`` are ignored).
    :param b_packed: same for cloud B.
    :param origins: [N, 3] block origins (shared partition).
    :return: dict(ab_sum, ba_sum, n_a, n_b, outliers_a, outliers_b) —
        ``outliers_*`` are global coordinates whose NN exceeds the halo.
    """
    n = len(origins)
    dev = a_packed.device
    nb = neighbor_table(origins, size)
    zero = torch.zeros(1, a_packed.shape[1], dtype=torch.uint8, device=dev)
    a_ext = torch.cat([a_packed[:n], zero])
    b_ext = torch.cat([b_packed[:n], zero])
    idx_all = torch.as_tensor(np.where(nb < 0, n, nb), dtype=torch.int64,
                              device=dev)
    totals = {"ab_sum": 0, "ba_sum": 0, "n_a": 0, "n_b": 0}
    unres = {"ab": [], "ba": []}
    for lo in range(0, n, batch):
        idx = idx_all[lo:lo + batch]
        if len(idx) < batch:  # fixed batch width: pad with empty blocks
            idx = torch.cat([idx, torch.full((batch - len(idx), 27), n,
                                             dtype=torch.int64, device=dev)])
        a_nb, b_nb = a_ext[idx], b_ext[idx]
        for tag, q_nb, t_nb in (("ab", a_nb, b_nb), ("ba", b_nb, a_nb)):
            r = halo_d1_dir(query_core(q_nb, size),
                            assemble_halo(t_nb, size, halo),
                            size=size, halo=halo)
            totals[f"{tag}_sum"] += int(r["sum"].sum())
            totals["n_a" if tag == "ab" else "n_b"] += int(r["n"].sum())
            flagged = torch.nonzero(r["unres_cnt"][:n - lo]).flatten()
            if len(flagged):
                unres[tag].append((lo + flagged.cpu().numpy(),
                                   r["unres"][flagged].cpu().numpy()))
    origins = np.asarray(origins)
    out = dict(totals)
    for tag, key in (("ab", "outliers_a"), ("ba", "outliers_b")):
        coords = []
        for blk, rows in unres[tag]:
            bits = np.unpackbits(rows, axis=-1, bitorder="big")
            c = np.argwhere(bits.reshape(len(rows), size, size, size))
            coords.append(c[:, 1:] + origins[blk[c[:, 0]]])
        out[key] = np.concatenate(coords) if coords else np.zeros((0, 3))
    out["ab_sum"] = float(out["ab_sum"])
    out["ba_sum"] = float(out["ba_sum"])
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
                     full_tree_limit=20_000_000):
    """Exact NN dist² of each query against a blockwise cloud.

    Clouds up to ``full_tree_limit`` points take one KD-tree over the whole
    cloud. Beyond it: per ring level r, one tree over the union of blocks
    within Chebyshev r of every pending query's cell; a result is certified
    when d ≤ r·size.
    """
    from scipy.spatial import cKDTree

    queries = np.asarray(queries, np.float64)
    origins = np.asarray(origins, np.int64)
    n_total = sum(len(b) for b in blocks)
    if n_total <= full_tree_limit:
        tree = build_cloud_tree(blocks, origins)
        if tree is None:  # empty candidate cloud: no finite NN distance
            return np.full(len(queries), np.inf)
        d, _ = tree.query(queries[:, :3], workers=-1)
        return d ** 2
    omap = {tuple(o): i for i, o in enumerate((origins // size).tolist())}
    max_ring = int(np.ceil((origins.max() + size) / size)) \
        if len(origins) else 1
    out = np.empty(len(queries))
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
        d, _ = cKDTree(np.vstack(pts), balanced_tree=False).query(
            queries[pending, :3], workers=-1)
        done = (d <= ring * size) | (ring >= max_ring)
        out[pending[done]] = d[done] ** 2
        pending = pending[~done]
    return out


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
    n_a, n_b = max(sums["n_a"], 1), max(sums["n_b"], 1)
    mse_ab = ab_sum / n_a
    mse_ba = ba_sum / n_b
    max_energy = 3.0 * r * r
    return {
        "d1_sum_AB": ab_sum,
        "d1_sum_BA": ba_sum,
        "d1_sum_max": max(ab_sum, ba_sum),
        "d1_sum_mean": (ab_sum + ba_sum) / 2,
        "d1_mse_AB": mse_ab,
        "d1_mse_BA": mse_ba,
        "d1_mse": max(mse_ab, mse_ba),
        "d1_psnr_AB": psnr(mse_ab, max_energy),
        "d1_psnr_BA": psnr(mse_ba, max_energy),
        "d1_psnr": min(psnr(mse_ab, max_energy), psnr(mse_ba, max_energy)),
    }

"""Octree block partitioning with a bitstream-visible occupancy description.

Host-side (numpy) geometry core. A point cloud with coordinates in
``[0, 2^geo_level)^3`` is split into ``2^level`` blocks per axis; occupied
blocks are returned in Morton order together with a *binstr*: the octree's
internal nodes serialized depth-first (pre-order), one ``uint8`` child-mask
per node, child bit ``v = x + 2*y + 4*z`` (x least significant).

This serialization is part of the bitstream format and matches the
reference implementation (``reference src/utils/octree_coding.py:24-113``
``split_octree``/``partition_octree``; inverse ``departition_octree:116-169``)
so that compressed files remain structurally compatible. The implementation
here is new and fully vectorized (the reference groups points with a Python
loop; see its 7.6 s vs 73.6 s note at ``octree_coding.py:66``).
"""

from __future__ import annotations

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.utils import trace

__all__ = [
    "morton_codes",
    "partition_octree",
    "departition_octree",
    "block_origins",
    "child_bbox",
]


def morton_codes(block_ids: np.ndarray, level: int) -> np.ndarray:
    """Interleave (z, y, x) coordinate bits, z most significant per triple.

    ``block_ids``: integer array [N, 3] of (x, y, z) block coordinates in
    ``[0, 2^level)``. Returns int64 codes whose ascending order is the octree
    DFS traversal order (child index ``v = x + 2*y + 4*z`` ascending at every
    level — same order as the reference's string-interleave sort at
    ``octree_coding.py:87-91``).
    """
    ids = np.asarray(block_ids, dtype=np.int64)
    codes = np.zeros(len(ids), dtype=np.int64)
    for b in range(level):
        bit = level - 1 - b  # MSB first
        triple = (
            ((ids[:, 2] >> bit) & 1) << 2
            | ((ids[:, 1] >> bit) & 1) << 1
            | ((ids[:, 0] >> bit) & 1)
        )
        codes = (codes << 3) | triple
    return codes


def _build_binstr(sorted_codes: np.ndarray, level: int) -> list[int]:
    """Serialize internal-node child masks in DFS pre-order.

    ``sorted_codes`` must be unique, ascending Morton codes of occupied
    leaf blocks (3*level bits each).
    """
    binstr: list[int] = []

    def rec(lo: int, hi: int, depth: int) -> None:
        if depth == level:
            return
        shift = 3 * (level - depth - 1)
        mask = 0
        spans = []
        i = lo
        while i < hi:
            v = int(sorted_codes[i] >> shift) & 7
            j = i
            while j < hi and (int(sorted_codes[j] >> shift) & 7) == v:
                j += 1
            mask |= 1 << v
            spans.append((i, j))
            i = j
        binstr.append(mask)
        for a, b in spans:
            rec(a, b, depth + 1)

    if level > 0 and len(sorted_codes) > 0:
        rec(0, len(sorted_codes), 0)
    return binstr


def partition_octree(points, bbox_min, bbox_max, level):
    """Partition ``points`` into occupied octree blocks at depth ``level``.

    :param points: [N, 3+] array; columns past the first 3 (e.g. normals)
        are carried through untouched.
    :param bbox_min: must be [0, 0, 0] (as in the reference fast path,
        ``octree_coding.py:75``).
    :param bbox_max: upper bound; blocks are sized ``2^(geo_level-level)``
        with ``geo_level = ceil(log2(max(bbox_max)))``.
    :param level: octree depth; 0 returns the input unpartitioned.
    :return: (blocks, binstr) — blocks is a list of [n_i, 3+] arrays in
        local block coordinates, Morton order; binstr is a list of uint8
        child masks (None when level == 0 or points is empty).
    """
    with trace.span("octree.partition"):
        return _partition(np.asarray(points), bbox_min, bbox_max, level)


def _partition(points, bbox_min, bbox_max, level):
    """:func:`partition_octree` inside its span."""
    if len(points) == 0 or level == 0:
        return [points], None
    bbox_min = np.asarray(bbox_min)
    np.testing.assert_array_equal(bbox_min, [0, 0, 0])
    bbox_max = np.asarray(bbox_max)
    geo_level = int(np.ceil(np.log2(np.max(bbox_max))))
    assert geo_level >= level, f"geo_level {geo_level} < level {level}"
    block_size = 2 ** (geo_level - level)

    block_ids = (points[:, :3] // block_size).astype(np.int64)
    codes = morton_codes(block_ids, level)

    order = np.argsort(codes, kind="stable")  # stable: keep point order in-block
    sorted_codes = codes[order]
    sorted_points = points[order]

    # Unique occupied blocks and per-block point counts, already Morton-sorted.
    uniq_codes, first_idx, counts = np.unique(
        sorted_codes, return_index=True, return_counts=True
    )

    # Local coordinates: subtract block origin from xyz only.
    origins = block_ids[order] * block_size
    local = sorted_points.astype(points.dtype, copy=True)
    local[:, :3] = local[:, :3] - origins.astype(local.dtype)

    blocks = np.split(local, np.cumsum(counts)[:-1])
    binstr = _build_binstr(uniq_codes, level)
    return blocks, binstr


def child_bbox(v: int, bbox_min: np.ndarray, bbox_max: np.ndarray):
    """Bounding box of octant ``v`` (bit0=x, bit1=y, bit2=z) of a node."""
    mid = (bbox_max - bbox_min) // 2 + bbox_min
    lo = bbox_min.copy()
    hi = mid.copy()
    for axis in range(3):
        if (v >> axis) & 1:
            lo[axis] = mid[axis]
            hi[axis] = bbox_max[axis]
    return lo, hi


def block_origins(binstr, bbox_min, bbox_max, level):
    """Global origin of every leaf block, in binstr traversal order.

    Walks the DFS pre-order binstr, assigning each leaf (depth == level)
    its global origin in traversal order.
    """
    bbox_min = np.asarray(bbox_min)
    bbox_max = np.asarray(bbox_max)
    binstr = list(binstr)
    origins: list[np.ndarray] = []
    pos = 0  # index into binstr

    def rec(depth: int, lo: np.ndarray, hi: np.ndarray) -> None:
        nonlocal pos
        mask = int(binstr[pos])
        pos += 1
        for v in range(8):
            if (mask >> v) & 1:
                clo, chi = child_bbox(v, lo, hi)
                if depth + 1 == level:
                    origins.append(clo)
                else:
                    rec(depth + 1, clo, chi)

    rec(0, bbox_min, bbox_max)
    return origins


def departition_octree(blocks, binstr, bbox_min, bbox_max, level):
    """Inverse of :func:`partition_octree`: restore global coordinates.

    Assigns each leaf (depth == level) its global origin in binstr
    traversal order and translates each block's xyz back. Blocks are
    returned as new arrays; extra columns pass through.
    """
    with trace.span("octree.departition"):
        origins = block_origins(binstr, bbox_min, bbox_max, level)
        assert len(origins) == len(blocks), (
            f"binstr describes {len(origins)} blocks, got {len(blocks)}"
        )
        out = []
        for block, origin in zip(blocks, origins):
            block = np.array(block, copy=True)
            block[:, :3] = block[:, :3] + origin.astype(block.dtype)
            out.append(block)
        return out

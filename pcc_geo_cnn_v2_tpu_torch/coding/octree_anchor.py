"""Built-in octree anchor codec (G-PCC-octree-style, in lieu of tmc3).

The port's own copy of ``pcc_geo_cnn_v2_tpu/coding/octree_anchor.py``; its
streams are byte-equal to the JAX package's. The reference compares
against the external MPEG G-PCC binary (its ``src/mp_run.py:33-41``); this
module is a self-contained anchor of the same family: positions are
quantized by ``positionQuantizationScale`` (the CTC octree rate control),
deduplicated, and coded as the breadth-first stream of 8-bit
child-occupancy masks of the full octree, the core of G-PCC's octree
geometry mode.

Entropy stage (``entropy="cabac"``, the default): each occupancy bit is
coded with the context-adaptive binary range coder of
``coding/binary_coder.py``, the coder family tmc3 uses, with G-PCC-style
contexts: the child octant, the count of occupied sibling octants coded
before it, the 6-neighbour same-level node-occupancy pattern (known to the
decoder, which decodes level by level), and the per-axis state of the
face-adjacent child voxel (occupied / empty / not yet coded: the +
neighbour's matching child lives in a plane coded before). No tables are
sent; encoder and decoder adapt alike. ``entropy="deflate"`` keeps the
earlier DEFLATE stage for A/B comparison.

Everything outside the sequential coder is vectorized numpy: the context
streams are computed level by level and bit plane by bit plane (8 planes a
level), so the native coder takes flat (bit, context) arrays.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.coding.binary_coder import (
    AbcDecoder,
    abc_encode,
)

__all__ = ["anchor_encode", "anchor_decode", "write_tmc3_style_log"]

_MAGIC_DEFLATE = b"OCTA"
_MAGIC_CABAC = b"OCTB"
# context = ((octant*8 + n_prev_siblings)*64 + neighbour_pattern)*27 + adj3
# (the JAX package's model, chosen there by tools/anchor_ctx_ab.py)
_N_CTX = 8 * 8 * 64 * 27
_HDR = "<IdB"  # resolution uint32, scale float64, bits uint8
_HDR_LEN = struct.calcsize(_HDR)

# direction order for neighbour occupancy: +x −x +y −y +z −z
_DIRS = [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]


def _interleave(coords, bits):
    """[N,3] int → Morton codes (int64), x most significant."""
    c = np.asarray(coords, np.int64)
    out = np.zeros(len(c), np.int64)
    for b in range(bits):
        for ax in range(3):
            out |= ((c[:, ax] >> b) & 1) << (3 * b + (2 - ax))
    return out


def _deinterleave(codes, bits):
    codes = np.asarray(codes, np.int64)
    out = np.zeros((len(codes), 3), np.int64)
    for b in range(bits):
        for ax in range(3):
            out[:, ax] |= ((codes >> (3 * b + (2 - ax))) & 1) << b
    return out


def octree_mask_stream(codes, bits):
    """Sorted unique Morton codes → breadth-first child-mask bytes."""
    codes = np.unique(codes)
    levels = []
    for level in range(bits):
        shift = 3 * (bits - level - 1)
        pc = np.unique(codes >> shift)  # unique (parent<<3 | child)
        par = pc >> 3
        upar, inv = np.unique(par, return_inverse=True)
        masks = np.zeros(len(upar), np.uint8)
        np.bitwise_or.at(masks, inv,
                         (1 << (pc & 7)).astype(np.uint8))
        levels.append(masks)
    return np.concatenate(levels)


def octree_mask_decode(masks, bits):
    """Inverse of :func:`octree_mask_stream` → sorted Morton codes."""
    masks = np.asarray(masks, np.uint8)
    pos = 0
    nodes = np.zeros(1, np.int64)  # root
    for _ in range(bits):
        m = masks[pos:pos + len(nodes)]
        pos += len(nodes)
        parts = [((nodes[((m >> b) & 1).astype(bool)] << 3) | b)
                 for b in range(8)]
        nodes = np.sort(np.concatenate(parts))
    return nodes


# ---------------------------------------------------------------------------
# CABAC context model
# ---------------------------------------------------------------------------


def _nbr_index(nodes, level):
    """[n, 6] index into ``nodes`` of the face-adjacent same-level
    neighbour (−1 if unoccupied/out of grid), direction order ``_DIRS``."""
    out = np.full((len(nodes), 6), -1, np.int64)
    if level == 0:
        return out
    coords = _deinterleave(nodes, level)
    lim = np.int64(1) << level
    for d, (ax, delta) in enumerate(_DIRS):
        nc = coords.copy()
        nc[:, ax] += delta
        valid = (nc[:, ax] >= 0) & (nc[:, ax] < lim)
        ncodes = _interleave(nc[valid], level)
        idx = np.searchsorted(nodes, ncodes)
        idx_c = np.minimum(idx, len(nodes) - 1)
        hit = nodes[idx_c] == ncodes
        rows = np.nonzero(valid)[0]
        out[rows[hit], d] = idx_c[hit]
    return out


def _plane_ctx(b, n_prev, n6, nbr, partial):
    """Context ids for bit-plane (child octant) ``b`` of one level.

    Features: octant (8) × already-coded sibling count (8) × 6-neighbour
    node occupancy pattern (64) × per-axis adjacent-child state (27).
    The adjacent child of octant ``b`` along an axis lives in the
    + neighbour when ``b`` has that axis bit set — its octant flips the
    bit DOWN (``b & ~bit``), i.e. an already-coded plane, so the decoder
    knows it; axes with the bit clear are 'unknown' (the − neighbour's
    matching child is a later plane).
    """
    adj = np.zeros(len(n_prev), np.int32)
    for ax, bitmask in enumerate((4, 2, 1)):
        if b & bitmask:
            nb = nbr[:, 2 * ax]  # + direction
            val = np.ones(len(n_prev), np.int32)  # 1 = unoccupied
            known = nb >= 0
            val[known] += ((partial[nb[known]] >> (b & ~bitmask)) & 1)
        else:
            val = np.zeros(len(n_prev), np.int32)  # 0 = unknown
        adj = adj * 3 + val
    return ((np.int32(b) * 8 + n_prev.astype(np.int32)) * 64
            + n6.astype(np.int32)) * 27 + adj


def _cabac_encode_masks(codes, bits):
    """Occupied Morton codes → context-coded child-mask payload bytes."""
    codes = np.unique(codes)
    all_bits, all_ctx = [], []
    for level in range(bits):
        shift = 3 * (bits - level - 1)
        pc = np.unique(codes >> shift)
        nodes, inv = np.unique(pc >> 3, return_inverse=True)
        masks = np.zeros(len(nodes), np.uint8)
        np.bitwise_or.at(masks, inv, (1 << (pc & 7)).astype(np.uint8))
        nbr = _nbr_index(nodes, level)
        n6 = ((nbr >= 0).astype(np.int32)
              << np.arange(6, dtype=np.int32)).sum(1)
        n_prev = np.zeros(len(nodes), np.uint8)
        partial = np.zeros(len(nodes), np.uint8)
        for b in range(8):
            bitvec = ((masks >> b) & 1).astype(np.uint8)
            all_bits.append(bitvec)
            all_ctx.append(_plane_ctx(b, n_prev, n6, nbr, partial))
            n_prev = n_prev + bitvec
            partial = partial | (bitvec << b).astype(np.uint8)
    return abc_encode(np.concatenate(all_bits), np.concatenate(all_ctx),
                      _N_CTX)


def _cabac_decode_masks(payload, bits):
    """Inverse of :func:`_cabac_encode_masks` → sorted leaf Morton codes."""
    nodes = np.zeros(1, np.int64)  # root
    with AbcDecoder(payload, _N_CTX) as dec:
        for level in range(bits):
            nbr = _nbr_index(nodes, level)
            n6 = ((nbr >= 0).astype(np.int32)
                  << np.arange(6, dtype=np.int32)).sum(1)
            n_prev = np.zeros(len(nodes), np.uint8)
            partial = np.zeros(len(nodes), np.uint8)
            for b in range(8):
                bitvec = dec.decode(_plane_ctx(b, n_prev, n6, nbr, partial))
                n_prev = n_prev + bitvec
                partial = partial | (bitvec << b).astype(np.uint8)
            children = [((nodes[((partial >> b) & 1).astype(bool)] << 3) | b)
                        for b in range(8)]
            nodes = np.sort(np.concatenate(children))
    return nodes


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------


def anchor_encode(points, resolution, scale=1.0, entropy="cabac"):
    """Quantize + octree-code geometry; returns the bitstream bytes.

    :param points: [N, ≥3] integer voxel coordinates.
    :param scale: positionQuantizationScale (≤ 1); rate control.
    :param entropy: ``"cabac"`` (context-adaptive binary range coder,
        the default) or ``"deflate"`` (legacy, pessimistic stage kept
        for A/B comparison).
    """
    assert 0 <= resolution < 2 ** 32, resolution
    q = np.unique(np.round(np.asarray(points)[:, :3] * scale), axis=0)
    q = q[np.all(q >= 0, axis=1)].astype(np.int64)
    max_c = int(q.max()) if len(q) else 0
    bits = max(int(np.ceil(np.log2(max_c + 1))), 1)
    header = struct.pack(_HDR, resolution, scale, bits)
    codes = _interleave(q, bits)
    if entropy == "cabac":
        return _MAGIC_CABAC + header + _cabac_encode_masks(codes, bits)
    assert entropy == "deflate", entropy
    masks = octree_mask_stream(codes, bits)
    return _MAGIC_DEFLATE + header + gzip.compress(masks.tobytes(), 9)


def anchor_decode(data):
    """Bitstream → [N, 3] float64 reconstructed coordinates."""
    magic = data[:4]
    assert magic in (_MAGIC_CABAC, _MAGIC_DEFLATE), \
        "not a builtin-anchor bitstream"
    resolution, scale, bits = struct.unpack(
        _HDR, data[4:4 + _HDR_LEN])
    payload = data[4 + _HDR_LEN:]
    if magic == _MAGIC_CABAC:
        codes = _cabac_decode_masks(payload, bits)
    else:
        masks = np.frombuffer(gzip.decompress(payload), np.uint8)
        codes = octree_mask_decode(masks, bits)
    q = _deinterleave(codes, bits)
    return np.round(q / scale).astype(np.float64), resolution


def write_tmc3_style_log(path, in_path, n_points, n_bytes):
    """Emit an encoder log in tmc3's format so ``parse_bin_log`` (and any
    downstream tooling written against real tmc3 logs) consumes builtin
    anchor runs unchanged."""
    bpp = n_bytes * 8 / max(n_points, 1)
    with open(path, "w") as f:
        f.write(
            f'uncompressedDataPath  : "{in_path}"\n'
            "Slice number: 1\n"
            f"positions bitstream size {n_bytes} B ({bpp:.6g} bpp)\n"
            "colors bitstream size 0 B (0 bpp)\n"
            f"Total bitstream size {n_bytes} B\n"
        )

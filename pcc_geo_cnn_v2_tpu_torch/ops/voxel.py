"""Voxelization and bit packing: point lists ↔ dense occupancy grids.

Port of ``pcc_geo_cnn_v2_tpu/ops/voxel.py``. Blocks travel to the card as
one flat stream of packed coordinates (host :func:`flatten_blocks` +
:func:`pack_coords`) and are rebuilt into a padded ``[N, budget, 3]``
batch there (:func:`unpack_coords`, :func:`unflatten_points`);
:func:`voxelize` scatters them into ``[N, B, B, B, 1]`` f32 grids. The
per-block host helpers :func:`pack_points` (a padded ``[N, P, 3]`` batch,
as the fused ``encode`` of ``BlockCodec.encode_blocks`` takes it) and
:func:`devoxelize_host` are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flatten_blocks", "pack_attrs", "pack_coords", "unpack_coords",
           "unflatten_points", "pack_points", "voxelize", "voxelize_attrs",
           "devoxelize_host", "packbits", "unpackbits"]


def flatten_blocks(blocks, cols=(0, 1, 2), dtype=np.int16):
    """Concatenate variable-length blocks' columns (coordinates by
    default, e.g. ``cols=(3, 4, 5)`` for normals) into one flat stream.

    :return: (flat [F, len(cols)], offsets [N+1] int32)
    """
    offsets = np.zeros(len(blocks) + 1, np.int32)
    np.cumsum([len(b) for b in blocks], out=offsets[1:])
    flat = np.concatenate([np.asarray(b)[:, list(cols)] for b in blocks])
    return flat.astype(dtype), offsets


def pack_attrs(blocks, cols, max_points, dtype=np.float32):
    """Pad per-point attribute columns (e.g. normals) to a dense
    [N, max_points, len(cols)] host batch, zero rows as padding."""
    out = np.zeros((len(blocks), max_points, len(cols)), dtype)
    for i, b in enumerate(blocks):
        b = np.asarray(b)
        m = min(len(b), max_points)
        out[i, :m] = b[:m, cols]
    return out


def pack_coords(flat, size):
    """[F, 3] block-local integer coords → [F] int32 (host side; coords in
    [0, size) with size ≤ 1024 pack into ≤ 30 bits)."""
    shift = int(size - 1).bit_length()
    f = np.asarray(flat, np.int64)
    return ((f[:, 0] << (2 * shift)) | (f[:, 1] << shift)
            | f[:, 2]).astype(np.int32)


def unpack_coords(packed, size):
    """Inverse of :func:`pack_coords` on a tensor: [F] → [F, 3] int32."""
    shift = int(size - 1).bit_length()
    mask = (1 << shift) - 1
    p = packed.to(torch.int32)
    return torch.stack([(p >> (2 * shift)) & mask, (p >> shift) & mask,
                        p & mask], dim=-1)


def unflatten_points(flat, offs, n_blocks, budget, fill=-1):
    """Inverse of :func:`flatten_blocks` for one chunk.

    :param flat: [F, C] stream (rows past ``offs[-1]`` are padding).
    :param offs: [n_blocks + 1] int block offsets into ``flat``.
    :return: [n_blocks, budget, C] with ``fill`` padding rows.
    """
    f, c = flat.shape
    i = torch.arange(f, dtype=offs.dtype, device=flat.device)
    b = torch.searchsorted(offs, i, right=True) - 1
    keep = (b >= 0) & (b < n_blocks)
    b = b[keep].long()
    slot = (i[keep] - offs[b]).long()
    out = torch.full((n_blocks, budget, c), fill, dtype=flat.dtype,
                     device=flat.device)
    out[b, slot] = flat[keep]
    return out


def pack_points(blocks, max_points=None, dtype=np.int32):
    """Pad a list of variable-length [n_i, 3+] blocks to a dense batch on
    the host; padding rows get coordinate -1, which :func:`voxelize` drops.

    :return: (points [N, P, 3], counts [N] int32)
    """
    counts = np.array([len(b) for b in blocks], dtype=np.int32)
    p = int(max_points) if max_points is not None else int(
        counts.max(initial=1))
    if counts.max(initial=0) > p:
        raise ValueError(f"block with {counts.max()} points > budget {p}")
    points = np.full((len(blocks), p, 3), -1, dtype=dtype)
    for i, b in enumerate(blocks):
        points[i, :len(b)] = np.asarray(b)[:, :3].astype(dtype)
    return points, counts


def voxelize(points, size):
    """Scatter integer points into dense binary occupancy grids.

    :param points: [N, P, 3] int; rows with any coordinate outside
        [0, size) (e.g. -1 padding) are dropped.
    :return: [N, size, size, size, 1] float32 occupancy in {0, 1}.
    """
    n, p, _ = points.shape
    pts = points.to(torch.int64)
    valid = torch.all((pts >= 0) & (pts < size), dim=-1)
    bi = torch.arange(n, device=points.device)[:, None].expand(n, p)
    flat = ((bi * size + pts[..., 0]) * size + pts[..., 1]) * size \
        + pts[..., 2]
    grid = torch.zeros(n * size ** 3, dtype=torch.float32,
                       device=points.device)
    grid[flat[valid]] = 1.0
    return grid.view(n, size, size, size, 1)


def voxelize_attrs(points, attrs, size):
    """Scatter per-point attributes onto the grid (points are unique
    voxels, so every voxel receives at most one row).

    :param points: [N, P, 3] int; rows with any coordinate outside
        [0, size) (e.g. -1 padding) are dropped.
    :param attrs: [N, P, A] float attribute rows.
    :return: [N, size, size, size, A] float32.
    """
    n, p, a = attrs.shape
    pts = points.to(torch.int64)
    valid = torch.all((pts >= 0) & (pts < size), dim=-1)
    bi = torch.arange(n, device=points.device)[:, None].expand(n, p)
    flat = ((bi * size + pts[..., 0]) * size + pts[..., 1]) * size \
        + pts[..., 2]
    grid = torch.zeros(n * size ** 3, a, dtype=torch.float32,
                       device=points.device)
    grid.index_put_((flat[valid],), attrs[valid].to(torch.float32),
                    accumulate=True)
    return grid.view(n, size, size, size, a)


def devoxelize_host(grid, threshold):
    """Occupancy probabilities of one block → [M, 3] float32 coordinates
    where ``grid > threshold``, in ``np.argwhere`` order (the reference's
    ``model_types.py:209``)."""
    return np.argwhere(np.asarray(grid) > threshold).astype(np.float32)


_BITS = (128, 64, 32, 16, 8, 4, 2, 1)


def packbits(mask):
    """[N, M] bool (M % 8 == 0) → [N, M/8] uint8, big bit order (numpy's
    ``packbits(..., bitorder="big")``)."""
    n, m = mask.shape
    w = torch.tensor(_BITS, dtype=torch.uint8, device=mask.device)
    return (mask.view(n, m // 8, 8).to(torch.uint8) * w).sum(
        -1, dtype=torch.uint8)


def unpackbits(packed):
    """Inverse of :func:`packbits`: [..., M/8] uint8 → [..., M] uint8."""
    w = torch.tensor(_BITS, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] & w) != 0
    return bits.reshape(*packed.shape[:-1], -1).to(torch.uint8)

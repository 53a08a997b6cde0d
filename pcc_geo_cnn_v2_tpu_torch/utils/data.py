"""Block dataset: host-side batching of variable-size point blocks.

The port's own copy of ``pcc_geo_cnn_v2_tpu/utils/data.py`` (numpy only):
the same seeds give the same arrays. Batches are compact padded
``[N, P, 3]`` int32 point lists (padding -1, dropped by the voxelizer in
the training step), not dense grids.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BlockDataset", "train_val_split_by_dir", "synthetic_blocks"]


class BlockDataset:
    """A list of integer point blocks with shuffled infinite batching."""

    def __init__(self, blocks, max_points=None):
        self.blocks = [np.asarray(b)[:, :3].astype(np.int32) for b in blocks]
        assert len(self.blocks) > 0
        self.max_points = int(
            max_points
            if max_points is not None
            else max(len(b) for b in self.blocks)
        )

    def __len__(self):
        return len(self.blocks)

    def _pack(self, idxs):
        out = np.full((len(idxs), self.max_points, 3), -1, np.int32)
        for row, i in enumerate(idxs):
            b = self.blocks[i]
            n = min(len(b), self.max_points)
            out[row, :n] = b[:n]
        return out

    def batches(self, batch_size, seed=42, repeat=True, shuffle=True):
        """Yield [batch_size, P, 3] int32 batches (infinite when repeat).

        Fewer blocks than one batch still yields one batch (blocks cycled
        to fill it) — a validation split smaller than the batch size must
        not silently produce zero batches.
        """
        rng = np.random.default_rng(seed)
        n = len(self.blocks)
        while True:
            order = rng.permutation(n) if shuffle else np.arange(n)
            if n < batch_size:
                yield self._pack(np.resize(order, batch_size))
            for lo in range(0, n - batch_size + 1, batch_size):
                yield self._pack(order[lo: lo + batch_size])
            if not repeat:
                return


def train_val_split_by_dir(paths, val_tokens=("_val", "/val")):
    """Split file paths into train/val lists by directory naming convention
    (the reference splits ModelNet by dir name, ``tr_train.py:30-32``)."""
    train, val = [], []
    for p in paths:
        (val if any(t in str(p) for t in val_tokens) else train).append(p)
    return train, val


def _surface_patch(rng, block_size, kind, n=5000):
    """Sample one surface-like primitive clipped to the block."""
    if kind == "shell":  # ellipsoid shell
        center = rng.uniform(-0.2, 1.2, 3) * block_size
        radii = rng.uniform(0.3, 1.6, 3) * block_size
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts = center + v * radii
    elif kind == "plane":  # random oriented rough plane
        normal = rng.normal(size=3)
        normal /= np.linalg.norm(normal)
        basis = np.linalg.qr(rng.normal(size=(3, 3)))[0][:, :2]
        uv = rng.uniform(-1.0, 1.0, (n, 2)) * block_size
        bend = np.sin(uv[:, :1] * rng.uniform(0.05, 0.3)) * rng.uniform(
            0, 0.15) * block_size
        pts = (block_size / 2 + uv @ basis.T
               + (bend + rng.normal(0, 0.3, (n, 1))) * normal)
    elif kind == "cylinder":
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        radius = rng.uniform(0.1, 0.5) * block_size
        t = rng.uniform(-1, 1, (n, 1)) * block_size
        theta = rng.uniform(0, 2 * np.pi, n)
        u = np.linalg.qr(np.column_stack([axis, rng.normal(size=(3, 2))]))[0]
        circ = (np.cos(theta)[:, None] * u[:, 1]
                + np.sin(theta)[:, None] * u[:, 2]) * radius
        pts = block_size / 2 + t * axis + circ
    else:  # uniform noise
        pts = rng.uniform(0, block_size, (n // 8, 3))
    return pts


def synthetic_blocks(n_blocks, block_size=64, seed=0, kind="shell"):
    """Procedural occupancy blocks for tests/benchmarks (no dataset needed).

    'shell'/'plane'/'cylinder'/'uniform' draw one primitive each; 'mix'
    composites 1-3 random primitives per block — diverse enough that a
    codec cannot memorize the geometry (latents must carry information),
    with surface-like occupancy ratios similar to ModelNet blocks.
    """
    rng = np.random.default_rng(seed)
    blocks = []
    kinds = ["shell", "plane", "cylinder"]
    for _ in range(n_blocks):
        if kind == "mix":
            parts = [
                _surface_patch(rng, block_size,
                               kinds[rng.integers(len(kinds))])
                for _ in range(rng.integers(1, 4))
            ]
            if rng.random() < 0.3:
                parts.append(_surface_patch(rng, block_size, "uniform"))
            pts = np.vstack(parts)
        else:
            pts = _surface_patch(rng, block_size, kind)
        pts = np.round(pts)
        ok = np.all((pts >= 0) & (pts < block_size), axis=1)
        pts = np.unique(pts[ok], axis=0)
        if len(pts) < 10:  # degenerate draw: fall back to noise
            pts = np.unique(rng.integers(0, block_size, (200, 3)), axis=0)
        blocks.append(pts.astype(np.int32))
    return blocks

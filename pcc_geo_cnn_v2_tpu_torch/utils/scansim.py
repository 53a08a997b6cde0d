"""Scan-like synthetic point clouds: smooth composite 2-manifolds.

No real scan datasets are mountable in this environment (the reference
evaluates on 4 MPEG 10-bit clouds, ``reference src/ev_experiment.yml:150-166``),
so RD training/evaluation uses procedural "figures": a superellipsoid body
with attached limb/head patches and draped sheets, smoothly warped, sampled
densely and voxelized to integer coordinates. The result matches the MPEG
clouds' key statistics — a single connected ~2D manifold at 10-bit
resolution with 0.4–1.5 M occupied voxels and locally smooth curvature —
which is what the block codec actually sees (64³ surface patches).

Per-voxel unit normals are computed from the parametric jacobian (numeric
central differences through the full transform chain, so warps are
accounted for) and averaged per voxel — used for D2 (point-to-plane)
metrics, mirroring the reference's use of pc normals
(``reference src/utils/pc_metric.py:28-49``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["figure_cloud", "figure_blocks"]

_H = 1e-4


def _numeric_normals(f, u, v):
    """Unit normals of p = f(u, v) via central-difference jacobian."""
    pu = f(u + _H, v) - f(u - _H, v)
    pv = f(u, v + _H) - f(u, v - _H)
    n = np.cross(pu, pv)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def _sample(f, n, rng):
    """Stratified-ish uv samples of one parametric patch → (points, normals)."""
    u = rng.random(n)
    v = rng.random(n)
    return f(u, v), _numeric_normals(f, u, v)


def _rotation(rng):
    """Random 3D rotation matrix (QR of a Gaussian)."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.diag(r))


def _superellipsoid(rng, radii, e1, e2, bumps):
    """u,v in [0,1]² → surface points; radius modulated by smooth bumps."""
    ax, ay, az = radii
    kx, ky, kz, amp = bumps

    def f(u, v):
        th = (u - 0.5) * np.pi  # latitude
        ph = (v - 0.5) * 2 * np.pi
        def spow(x, e):
            return np.sign(x) * np.abs(x) ** e
        cx = spow(np.cos(th), e1) * spow(np.cos(ph), e2)
        cy = spow(np.cos(th), e1) * spow(np.sin(ph), e2)
        cz = spow(np.sin(th), e1)
        r = 1.0 + amp * np.sin(kx * th + ky * ph) * np.cos(kz * ph)
        return np.stack([ax * r * cx, ay * r * cy, az * r * cz], -1)

    return f


def _cylinder(rng, radius, length, taper, bend):
    """Limb: tapered, gently bent elliptical cylinder along +z."""
    rx = radius * rng.uniform(0.7, 1.3)

    def f(u, v):
        z = (u - 0.5) * length
        ph = v * 2 * np.pi
        r = 1.0 - taper * u
        bx = bend * length * np.sin(np.pi * u)
        return np.stack([
            rx * r * np.cos(ph) + bx,
            radius * r * np.sin(ph),
            z,
        ], -1)

    return f


def _sheet(rng, size, waves):
    """Draped sheet: smooth random Fourier heightfield."""
    coef = [(rng.uniform(0.02, 0.08) * size,
             rng.uniform(1.0, 3.0), rng.uniform(1.0, 3.0),
             rng.uniform(0, 2 * np.pi)) for _ in range(waves)]

    def f(u, v):
        x = (u - 0.5) * size
        y = (v - 0.5) * size
        z = np.zeros_like(x)
        for a, kx, ky, ph in coef:
            z = z + a * np.sin(2 * np.pi * (kx * u + ky * v) + ph)
        return np.stack([x, y, z], -1)

    return f


def _compose(patch_f, rot, offset, warp):
    """warp(rot @ f(u,v) + offset) as one function (normals differentiate
    through the whole chain)."""

    def f(u, v):
        p = patch_f(u, v) @ rot.T + offset
        return warp(p)

    return f


def _make_warp(rng, resolution, amp_frac=0.025):
    """Global smooth displacement field p + A·sin(Bp + φ) (cross-axis)."""
    amp = resolution * amp_frac * rng.uniform(0.5, 1.5, 3)
    freq = rng.uniform(0.8, 2.2, (3, 3)) * 2 * np.pi / resolution
    phase = rng.uniform(0, 2 * np.pi, 3)
    perm = rng.permutation(3)

    def warp(p):
        disp = np.stack(
            [amp[i] * np.sin((p * freq[i]).sum(-1) + phase[i])
             for i in range(3)], -1
        )
        return p + disp[..., perm]

    return warp


def figure_cloud(seed, resolution=1024, density=1.0, with_normals=True):
    """One scan-like figure voxelized at ``resolution``.

    :param density: oversampling multiplier (1.0 ≈ watertight surface).
    :return: [N, 3] float64 unique integer coords (+ [N, 3] unit normals
        when ``with_normals``), N ≈ 0.4–1.5 M at 1024³.
    """
    rng = np.random.default_rng(seed)
    R = resolution
    warp = _make_warp(rng, R)
    patches = []  # (fn, approx_area_in_voxels)

    # body
    body_r = np.array([rng.uniform(0.14, 0.22), rng.uniform(0.10, 0.18),
                       rng.uniform(0.22, 0.34)]) * R
    body = _superellipsoid(
        rng, body_r, rng.uniform(0.7, 1.3), rng.uniform(0.7, 1.3),
        (rng.integers(2, 5), rng.integers(2, 5), rng.integers(2, 5),
         rng.uniform(0.01, 0.05)),
    )
    center = np.full(3, R / 2.0)
    body_rot = _rotation(rng)
    patches.append((_compose(body, body_rot, center, warp),
                    4 * np.pi * np.prod(body_r) ** (2 / 3)))

    # head
    head_r = np.full(3, rng.uniform(0.05, 0.09) * R)
    head_off = center + body_rot @ np.array([0, 0, body_r[2] + head_r[0] * 0.6])
    head = _superellipsoid(rng, head_r, 1.0, 1.0,
                           (2, 3, 2, rng.uniform(0.01, 0.03)))
    patches.append((_compose(head, _rotation(rng), head_off, warp),
                    4 * np.pi * head_r[0] ** 2))

    # limbs
    for _ in range(rng.integers(3, 6)):
        radius = rng.uniform(0.025, 0.06) * R
        length = rng.uniform(0.25, 0.5) * R
        limb = _cylinder(rng, radius, length, rng.uniform(0.1, 0.5),
                         rng.uniform(0.0, 0.15))
        rot = _rotation(rng)
        # attach: one end near the body surface
        anchor = center + body_rot @ (
            body_r * 0.9 * _unit(rng.normal(size=3)))
        off = anchor + rot @ np.array([0, 0, length / 2 * 0.8])
        patches.append((_compose(limb, rot, off, warp),
                        2 * np.pi * radius * length))

    # drape
    if rng.random() < 0.7:
        size = rng.uniform(0.3, 0.5) * R
        sheet = _sheet(rng, size, waves=rng.integers(2, 5))
        off = center + rng.uniform(-0.15, 0.15, 3) * R
        patches.append((_compose(sheet, _rotation(rng), off, warp),
                        size * size))

    pts_all, nrm_all = [], []
    for f, area in patches:
        n = int(area * 2.2 * density)  # ~2.2 samples per voxel-area unit
        p, nr = _sample(f, n, rng)
        pts_all.append(p)
        nrm_all.append(nr)
    pts = np.vstack(pts_all)
    nrm = np.vstack(nrm_all)

    coords = np.round(pts)
    keep = np.all((coords >= 0) & (coords < R), axis=1)
    coords, nrm = coords[keep], nrm[keep]
    # unique voxels; average (then renormalize) normals per voxel
    coords_i = coords.astype(np.int64)
    key = (coords_i[:, 0] * R + coords_i[:, 1]) * R + coords_i[:, 2]
    order = np.argsort(key, kind="stable")
    key, coords, nrm = key[order], coords[order], nrm[order]
    first = np.ones(len(key), bool)
    first[1:] = key[1:] != key[:-1]
    if not with_normals:
        return coords[first].astype(np.float64)
    idx = np.cumsum(first) - 1
    acc = np.zeros((int(first.sum()), 3))
    np.add.at(acc, idx, nrm)
    norm = np.linalg.norm(acc, axis=1, keepdims=True)
    acc = np.where(norm > 1e-9, acc / np.maximum(norm, 1e-9), [1.0, 0, 0])
    return coords[first].astype(np.float64), acc


def _unit(v):
    return v / np.linalg.norm(v)


def figure_blocks(seeds, resolution=1024, level=4, max_points=None,
                  rng_seed=0):
    """Octree-partition figure clouds into training blocks.

    :return: list of [n_i, 3] float blocks (local coords) pooled over all
        seeds, shuffled; blocks denser than ``max_points`` are dropped
        (not truncated — truncation would corrupt occupancy targets).
    """
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree

    out = []
    for seed in seeds:
        pts = figure_cloud(seed, resolution, with_normals=False)
        blocks, _ = partition_octree(pts, [0, 0, 0], [resolution] * 3,
                                     level)
        out.extend(blocks)
    if max_points is not None:
        kept = [b for b in out if len(b) <= max_points]
        if len(kept) < len(out):
            import logging

            logging.getLogger(__name__).info(
                "figure_blocks: dropped %d/%d blocks over %d points",
                len(out) - len(kept), len(out), max_points)
        out = kept
    rng = np.random.default_rng(rng_seed)
    rng.shuffle(out)
    return out

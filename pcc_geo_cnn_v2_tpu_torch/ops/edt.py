"""Squared Euclidean distance transforms on voxel grids (plain torch).

Port of ``pcc_geo_cnn_v2_tpu/ops/edt.py``, where these are plain XLA too:
the separable min-plus decomposition of the squared EDT, exact because
distances are integers ≤ 3(L-1)², representable in f32.

- :func:`squared_edt` — full 1-D passes ``out[i] = min_j g[j] + (i-j)²``
  (a dense [L, L] broadcast per pass, chunked over the leading dims so a
  batch of 64³ volumes never materialises at once).
- :func:`squared_edt_carry` / :func:`squared_edt_argmin` — the full
  passes carrying per-source values (normals, coordinates) to every voxel
  from its nearest occupied voxel; ties take the smallest source index of
  each pass, as ``jnp.argmin`` over the JAX package's ``[out, in]`` score
  tensor does. The port computes the pass as a shift loop over the source
  offset, in O(L) memory instead of that tensor's O(L²).
- :func:`banded_squared_edt` / :func:`banded_squared_edt_argmin` — passes
  ``out[i] = min_{|k| ≤ band} g[i+k] + k²``: exact for every result
  ≤ band², upper bounds beyond; the argmin variant carries the flat index
  of the nearest occupied voxel. Their ties keep the first winner in scan
  order (k = 0, then +k, -k), another rule than the full passes'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["INF", "minplus_1d", "squared_edt", "squared_edt_carry",
           "squared_edt_argmin", "banded_squared_edt",
           "banded_squared_edt_argmin"]

INF = 1e12
_CHUNK_ELEMS = 1 << 27  # elements of one [rows, L, L] min-plus broadcast


def minplus_1d(g, axis=-1):
    """out[i] = min_j g[j] + (i-j)² along ``axis``."""
    gm = g.movedim(axis, -1)
    L = gm.shape[-1]
    i = torch.arange(L, dtype=gm.dtype, device=gm.device)
    d2 = (i[:, None] - i[None, :]) ** 2  # [out, in]
    rows = gm.reshape(-1, L)
    out = torch.empty_like(rows)
    step = max(1, _CHUNK_ELEMS // (L * L))
    for lo in range(0, len(rows), step):
        out[lo:lo + step] = (rows[lo:lo + step, None, :] + d2).amin(-1)
    return out.view(gm.shape).movedim(-1, axis)


def squared_edt(occ):
    """Squared distance to the nearest occupied voxel over the last three
    axes (leading dims are batch); empty grids yield INF everywhere; f32."""
    g = torch.where(occ.to(torch.bool), 0.0, INF).to(torch.float32)
    for ax in (-3, -2, -1):
        g = minplus_1d(g, ax)
    return g


def _minplus_1d_arg(g, carries, axis):
    """out[i] = min_j g[j] + (i-j)² along ``axis``, and every array of
    ``carries`` gathered at the winning source j. Ties take the smallest
    j: the sources are visited in ascending order (j = i + k for k from
    -(L-1) up) and only a strictly smaller score replaces the best."""
    gm = g.movedim(axis, -1)
    L = gm.shape[-1]
    cms = [c.movedim(axis, -1) for c in carries]
    out = torch.full_like(gm, float("inf"))
    outc = [torch.zeros_like(cm) for cm in cms]
    for k in range(-(L - 1), L):
        lo, hi = max(0, -k), min(L, L - k)  # outputs i with a source i + k
        cand = gm[..., lo + k:hi + k] + float(k * k)
        better = cand < out[..., lo:hi]
        out[..., lo:hi] = torch.where(better, cand, out[..., lo:hi])
        for oc, cm in zip(outc, cms):
            oc[..., lo:hi] = torch.where(better, cm[..., lo + k:hi + k],
                                         oc[..., lo:hi])
    return out.movedim(-1, axis), [oc.movedim(-1, axis) for oc in outc]


def squared_edt_carry(occ, carries):
    """Squared EDT carrying per-source values to each voxel.

    :param occ: [..., X, Y, Z] occupancy.
    :param carries: list of f32 tensors broadcastable to ``occ``'s shape;
        every voxel receives each one's value at its nearest occupied
        voxel (the smallest source index of each pass on ties).
    :return: (dist [..., X, Y, Z] f32, list of carried tensors).
    """
    occ_b = occ.to(torch.bool)
    g = torch.where(occ_b, 0.0, INF).to(torch.float32)
    carry = [c.to(torch.float32).expand(occ_b.shape) for c in carries]
    for ax in (-3, -2, -1):
        g, carry = _minplus_1d_arg(g, carry, ax)
    return g, carry


def _iota(shape, k, device):
    """f32 coordinate ``k`` of every voxel of a ``shape`` volume."""
    view = [1, 1, 1]
    view[k] = shape[k]
    return torch.arange(shape[k], dtype=torch.float32,
                        device=device).view(view).expand(shape)


def squared_edt_argmin(occ):
    """Squared EDT plus the coordinates of the nearest occupied voxel.

    :param occ: [..., X, Y, Z] occupancy.
    :return: (dist [..., X, Y, Z] f32, nn [..., X, Y, Z, 3] int32).
    """
    shape = tuple(occ.shape[-3:])
    g, carry = squared_edt_carry(
        occ, [_iota(shape, k, occ.device) for k in range(3)])
    return g, torch.stack([c.to(torch.int32) for c in carry], dim=-1)


def _banded_minplus_1d(g, band, axis, carry=None):
    """out[i] = min_{|k| ≤ band} g[i+k] + k² (INF beyond the edges). With
    ``carry``, also its value at the winning source; ties keep the first
    winner in scan order (k = 0, then +k, -k by increasing k)."""
    gm = g.movedim(axis, -1)
    L = gm.shape[-1]
    padded = F.pad(gm, (band, band), value=INF)
    out = gm
    if carry is not None:
        cm = carry.movedim(axis, -1)
        cpad = F.pad(cm, (band, band), value=0.0)
        outc = cm
    for k in range(1, band + 1):
        k2 = float(k * k)
        for sh in (band + k, band - k):
            cand = padded[..., sh: sh + L] + k2
            if carry is None:
                out = torch.minimum(out, cand)
            else:
                better = cand < out
                out = torch.where(better, cand, out)
                outc = torch.where(better, cpad[..., sh: sh + L], outc)
    if carry is None:
        return out.movedim(-1, axis)
    return out.movedim(-1, axis), outc.movedim(-1, axis)


def banded_squared_edt(occ, band):
    """Squared EDT over the last three axes of ``occ`` (leading dims are
    batch), exact for every result ≤ band²; f32."""
    g = torch.where(occ.to(torch.bool), 0.0, INF).to(torch.float32)
    for ax in (-3, -2, -1):
        g = _banded_minplus_1d(g, band, ax)
    return g


def banded_squared_edt_argmin(occ, band):
    """Banded squared EDT + flat index of the nearest occupied voxel.

    Exact (distance and argmin) wherever the result ≤ band²; farther
    positions return dist > band² and a meaningless index. The flat index
    rides the passes as f32 (volumes below 2^24 voxels are exact).

    :return: (dist [..., X, Y, Z] f32, nn_flat [..., X, Y, Z] int32).
    """
    occ_b = occ.to(torch.bool)
    X, Y, Z = occ_b.shape[-3:]
    assert X * Y * Z < (1 << 24), "flat index must be f32-exact"
    g = torch.where(occ_b, 0.0, INF).to(torch.float32)
    carry = torch.arange(X * Y * Z, dtype=torch.float32,
                         device=occ.device).view(X, Y, Z).expand(occ_b.shape)
    for ax in (-3, -2, -1):
        g, carry = _banded_minplus_1d(g, band, ax, carry)
    return g, carry.to(torch.int32)

"""Squared Euclidean distance transforms on voxel grids (plain torch).

Port of ``pcc_geo_cnn_v2_tpu/ops/edt.py``, where these are plain XLA too:
the separable min-plus decomposition of the squared EDT, exact because
distances are integers ≤ 3(L-1)², representable in f32.

- :func:`squared_edt` — full 1-D passes ``out[i] = min_j g[j] + (i-j)²``
  (a dense [L, L] broadcast per pass, chunked over the leading dims so a
  batch of 64³ volumes never materialises at once).
- :func:`banded_squared_edt` / :func:`banded_squared_edt_argmin` — passes
  ``out[i] = min_{|k| ≤ band} g[i+k] + k²``: exact for every result
  ≤ band², upper bounds beyond; the argmin variant carries the flat index
  of the nearest occupied voxel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["INF", "minplus_1d", "squared_edt", "banded_squared_edt",
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

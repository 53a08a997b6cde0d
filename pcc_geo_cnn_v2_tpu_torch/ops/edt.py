"""Banded squared Euclidean distance transform on voxel grids (torch).

Port of the banded min-plus helpers of ``pcc_geo_cnn_v2_tpu/ops/edt.py``:
the separable squared EDT, each 1-D pass ``out[i] = min_{|k| ≤ band}
g[i+k] + k²``. Exact for every result ≤ band²; larger values are upper
bounds. Used for the coarse-grid shift bound of the halo kernel
(``ops/halo.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["INF", "banded_squared_edt"]

INF = 1e12


def _banded_minplus_1d(g, band, axis):
    """out[i] = min_{|k| ≤ band} g[i+k] + k² (INF beyond the edges)."""
    gm = g.movedim(axis, -1)
    L = gm.shape[-1]
    padded = F.pad(gm, (band, band), value=INF)
    out = gm
    for k in range(1, band + 1):
        k2 = float(k * k)
        out = torch.minimum(out, padded[..., band + k: band + k + L] + k2)
        out = torch.minimum(out, padded[..., band - k: band - k + L] + k2)
    return out.movedim(-1, axis)


def banded_squared_edt(occ, band):
    """Squared EDT over the last three axes of ``occ`` (leading dims are
    batch), exact for every result ≤ band²; f32."""
    g = torch.where(occ.to(torch.bool), 0.0, INF).to(torch.float32)
    for ax in (-3, -2, -1):
        g = _banded_minplus_1d(g, band, ax)
    return g

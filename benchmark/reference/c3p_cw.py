"""Plain PyTorch reference of ``c3p_cw``: c3p's transforms
(:class:`reference.model.Transforms`) with the channel-wise autoregressive
mean-scale entropy model of Minnen & Singh, "Channel-wise autoregressive
entropy models for learned image compression" (arXiv:2007.08739; the
reference code's ``models/ms2020.py``), and a cloud coded through it.

- ẑ = z symbols + median; latent_means and latent_scales are two hyper
  synthesis transforms of ẑ (``hyper_synthesis_mean_t`` and
  ``hyper_synthesis_t``, c3p's architecture);
- y in ``num_slices`` channel slices; slice k is conditioned on the first
  ``min(k, max_support)`` decoded slices: μ_k = mean_k(latent_means,
  support), σ_k = scale_k(latent_scales, support), bounded below by the
  table's first scale; symbols round(y_k − μ_k) under the smallest table
  scale at or above σ_k; ŷ_k = symbols + μ_k + ½ tanh(lrp_k(latent_means,
  support, symbols + μ_k));
- each slice net: conv k3 → 48, ReLU, conv k3 → 32, ReLU, conv k3 →
  slice, stride 1, SAME padding;
- x_hat = synthesis(ŷ).

Float32 with TF32 off (:func:`reference.model.f32_convs`); it imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference.judge import CloudReference, octree_blocks
from reference.model import (Transforms, factorized_medians, scale_table,
                             tensor_tree, _t)

__all__ = ["CWModel", "CWCloudReference"]


class CWModel:
    """The inference half of c3p_cw from its flax weight tree (c3p's
    modules with c3p_cw's laid over them)."""

    def __init__(self, tree, analysis, device, num_slices=8,
                 max_support=4):
        self.device = torch.device(device)
        self.tree = tensor_tree(tree, device)
        self.t = Transforms(self.tree, analysis)
        self.z_median = _t(factorized_medians(tree["entropy_bottleneck"]),
                           device).view(1, -1, 1, 1, 1)
        self.table = scale_table()
        self.num_slices, self.max_support = num_slices, max_support

    def _net(self, name, x):
        t = self.tree[name]
        L = Transforms._layer
        x = F.relu(L(t["Conv_0"], x, 1, False))
        x = F.relu(L(t["Conv_1"], x, 1, False))
        return L(t["Conv_2"], x, 1, False)

    def _mean_hyper(self, z_hat):
        t = self.tree["hyper_synthesis_mean_t"]
        for i, s in enumerate((1, 2, 1)):
            z_hat = F.relu(Transforms._layer(t[f"ConvTranspose_{i}"], z_hat,
                                             s, True))
        return z_hat

    def _rows(self, sigma):
        rows = torch.zeros(sigma.shape, dtype=torch.int64,
                           device=sigma.device)
        for s in self.table[:-1].astype(np.float32):
            rows += sigma > float(s)
        return rows

    @torch.no_grad()
    def code(self, occupancy):
        """[N, 1, B, B, B] occupancy → (each y element's scale-table row,
        int64 NCDHW; decoded probabilities x_hat [N, B, B, B])."""
        y = self.t.analysis_t(occupancy)
        z_sym = torch.round(self.t.hyper_analysis_t(y) - self.z_median)
        z_hat = z_sym + self.z_median
        means = self._mean_hyper(z_hat)
        scales = self.t.hyper_synthesis_t(z_hat)
        cs = y.shape[1] // self.num_slices
        y_hats, rows = [], []
        for k in range(self.num_slices):
            support = y_hats[:min(k, self.max_support)]
            mu = self._net(f"slice_mean_{k}", torch.cat([means] + support, 1))
            sigma = self._net(f"slice_scale_{k}",
                              torch.cat([scales] + support, 1)).clamp_min(
                                  float(self.table[0]))
            q = torch.round(y[:, k * cs:(k + 1) * cs] - mu) + mu
            lrp = self._net(f"slice_lrp_{k}",
                            torch.cat([means] + support + [q], 1))
            y_hats.append(q + 0.5 * torch.tanh(lrp))
            rows.append(self._rows(sigma))
        x_hat = torch.clamp(self.t.synthesis_t(torch.cat(y_hats, 1)), 0.0,
                            1.0)
        return torch.cat(rows, 1), x_hat[:, 0]


class CWCloudReference(CloudReference):
    """:class:`reference.judge.CloudReference` of a cloud coded by
    :class:`CWModel`: its blocks, their y scale rows (NDHWC, uint8, on the
    host) and decoded probabilities; ``recon_keys`` as there."""

    def __init__(self, model, points, resolution, level, thresholds,
                 batch=32):
        self.points = np.asarray(points)
        self.resolution, self.level = resolution, level
        self.bs = resolution >> level
        self.ids, self.blocks = octree_blocks(points, resolution, level)
        dev = model.device
        self.thr = torch.tensor(np.asarray(thresholds, np.float32),
                                device=dev)
        B = self.bs
        x_hat, rows = [], []
        for lo in range(0, len(self.blocks), batch):
            part = self.blocks[lo:lo + batch]
            occ = torch.zeros(len(part), 1, B, B, B, device=dev)
            for i, b in enumerate(part):
                t = torch.as_tensor(b, device=dev)
                occ[i, 0, t[:, 0], t[:, 1], t[:, 2]] = 1.0
            r, xh = model.code(occ)
            rows.append(r.permute(0, 2, 3, 4, 1).to(torch.uint8).cpu())
            x_hat.append(xh)
        self.x_hat = torch.cat(x_hat)
        self.rows = torch.cat(rows).numpy()
        self._picks = None

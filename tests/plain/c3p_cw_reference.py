"""Plain PyTorch reference of ``c3p_cw``: c3p (Quach, Valenzise, Dufaux,
arXiv:2006.09043) with the channel-wise autoregressive mean-scale entropy
model of Minnen & Singh (arXiv:2007.08739, the reference code's
``models/ms2020.py``).

Written from the published equations over the flax weight tree (kernels
DHWIO), on NCDHW tensors: convolutions are ``F.conv3d`` with XLA ``SAME``
padding, transposed convolutions ``F.conv_transpose3d`` with the kernel
flipped, float32 with TF32 off. It imports no kernel and no module of the
port, and nothing of JAX.

- ẑ = round(z − median) + median; latent_means and latent_scales are two
  hyper synthesis transforms of ẑ (c3p's architecture, ReLU at the end);
- y in ``num_slices`` channel slices; slice k is conditioned on the first
  ``min(k, max_support)`` decoded slices: μ_k = mean_k(latent_means,
  support), σ_k = scale_k(latent_scales, support) bounded below by the
  scale table's first entry, symbols round(y_k − μ_k) coded under the
  smallest table scale at or above σ_k, ŷ_k = symbols + μ_k +
  ½ tanh(lrp_k(latent_means, support, symbols + μ_k));
- each slice net: conv k3 → 48, ReLU, conv k3 → 32, ReLU, conv k3 → slice;
- training: the rate of y_k takes (y_k + u) − μ_k, u ~ U(-½, ½); ẑ and
  ŷ_k use straight-through rounding; loss λ·focal + bits per occupied
  voxel of y and z, plus the factorized prior's aux loss on its quantiles.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["f32", "scale_table", "CWReference"]

LIKELIHOOD_BOUND = 1e-9
TAIL_MASS = 1e-9


def f32():
    """Float32 convolutions and matmuls: no TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def scale_table(lo=0.11, hi=256.0, levels=64):
    return np.exp(np.linspace(np.log(lo), np.log(hi), levels))


def _pads(n, k, s):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x, leaf, s=1):
    kernel = leaf["kernel"]
    pads = []
    for n in reversed(x.shape[2:]):
        pads.extend(_pads(n, kernel.shape[0], s))
    return F.conv3d(F.pad(x, pads), kernel.permute(4, 3, 0, 1, 2),
                    leaf.get("bias"), s)


def conv_t(x, leaf, s=1):
    """flax ``ConvTranspose(padding="SAME")``: the input dilated by ``s``,
    correlated with the kernel as stored."""
    kernel = leaf["kernel"]
    k = kernel.shape[0]
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    w = kernel.flip(0, 1, 2).permute(3, 4, 0, 1, 2)
    y = F.conv_transpose3d(x, w, leaf.get("bias"), s, k - 1 - pad_a)
    out = (x.shape[2] - 1) * s + pad_len - k + 2
    return y[:, :, :out, :out, :out]


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= ctx.bound) | (g < 0), g, 0.0), None


def lower_bound(x, bound):
    """max(x, bound), passing a gradient wherever it would raise x."""
    return _LowerBound.apply(x, bound)


def _round_st(x):
    return x + (torch.round(x) - x).detach()


def _phi(x):
    return 0.5 * torch.special.erfc(-x / math.sqrt(2.0))


def _logits_cumulative(eb, x, detach=False):
    """The factorized prior's cumulative logit at x [C, 1, M]."""
    sg = (lambda t: t.detach()) if detach else (lambda t: t)
    u = x
    n = sum(1 for k in eb if k.startswith("matrix_"))
    for k in range(n):
        u = torch.matmul(F.softplus(sg(eb[f"matrix_{k}"])), u) \
            + sg(eb[f"bias_{k}"])
        if f"factor_{k}" in eb:
            u = u + torch.tanh(sg(eb[f"factor_{k}"])) * torch.tanh(u)
    return u


def _tensors(tree, device, grad):
    return {k: _tensors(v, device, grad) if isinstance(v, dict) else
            torch.tensor(np.asarray(v, np.float32), device=device,
                         requires_grad=grad)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


class CWReference:
    """c3p_cw over a flax weight tree (``{"params": ...}`` or its inner
    dict; ``grad=True`` makes every leaf a tensor that takes a gradient,
    :meth:`leaves` by flax path)."""

    def __init__(self, tree, num_slices=8, max_support=4, device="cpu",
                 grad=False):
        self.p = _tensors(tree.get("params", tree), device, grad)
        self.num_slices, self.max_support = num_slices, max_support
        self.table = scale_table()

    def leaves(self):
        return _leaves(self.p)

    # -- transforms ---------------------------------------------------------

    def analysis(self, x):
        t = self.p["analysis_t"]
        for i in range(3):
            b = t[f"AnalysisBlock_{i}"]
            h = F.relu(conv(x, b["Conv_0"], 2))
            u = F.relu(conv(h, b["Conv_1"]))
            x = h + F.relu(conv(u, b["Conv_2"]))
        return conv(x, t["Conv_0"])

    def synthesis(self, y):
        t = self.p["synthesis_t"]
        for i in range(3):
            b = t[f"SynthesisBlock_{i}"]
            h = F.relu(conv_t(y, b["ConvTranspose_0"], 2))
            u = F.relu(conv_t(h, b["ConvTranspose_1"]))
            y = h + F.relu(conv_t(u, b["ConvTranspose_2"]))
        return F.relu(conv_t(y, t["ConvTranspose_0"]))

    def hyper_analysis(self, y):
        t = self.p["hyper_analysis_t"]
        z = F.relu(conv(y, t["Conv_0"]))
        z = F.relu(conv(z, t["Conv_1"], 2))
        return conv(z, t["Conv_2"])

    def hyper_synthesis(self, z_hat, name):
        t = self.p[name]
        for i, s in enumerate((1, 2, 1)):
            z_hat = F.relu(conv_t(z_hat, t[f"ConvTranspose_{i}"], s))
        return z_hat

    def net(self, name, x):
        t = self.p[name]
        x = F.relu(conv(x, t["Conv_0"]))
        x = F.relu(conv(x, t["Conv_1"]))
        return conv(x, t["Conv_2"])

    def median(self):
        return self.p["entropy_bottleneck"]["quantiles"][:, 1].view(
            1, -1, 1, 1, 1)

    # -- the slice chain ------------------------------------------------------

    def _slice(self, k, hyper, y_hats):
        means, scales = hyper
        support = y_hats[:min(k, self.max_support)]
        mu = self.net(f"slice_mean_{k}", torch.cat([means] + support, 1))
        sigma = self.net(f"slice_scale_{k}", torch.cat([scales] + support, 1))
        return mu, lower_bound(sigma, float(self.table[0])), support

    def rows(self, sigma):
        """Each element's scale-table row: the smallest table scale at or
        above σ."""
        rows = torch.zeros(sigma.shape, dtype=torch.int64,
                           device=sigma.device)
        for s in self.table[:-1].astype(np.float32):
            rows += sigma > float(s)
        return rows

    @torch.no_grad()
    def code(self, x):
        """Occupancy [N, 1, B, B, B] → dict(z_sym, y_sym, idx int64, mu,
        y_hat, x_hat), NCDHW: what the encoder codes and the decoder makes
        of it."""
        y = self.analysis(x)
        z_sym = torch.round(self.hyper_analysis(y) - self.median())
        z_hat = z_sym + self.median()
        hyper = (self.hyper_synthesis(z_hat, "hyper_synthesis_mean_t"),
                 self.hyper_synthesis(z_hat, "hyper_synthesis_t"))
        cs = y.shape[1] // self.num_slices
        y_hats, syms, rows, mus = [], [], [], []
        for k in range(self.num_slices):
            mu, sigma, support = self._slice(k, hyper, y_hats)
            sym = torch.round(y[:, k * cs:(k + 1) * cs] - mu)
            q = sym + mu
            lrp = self.net(f"slice_lrp_{k}",
                           torch.cat([hyper[0]] + support + [q], 1))
            y_hats.append(q + 0.5 * torch.tanh(lrp))
            syms.append(sym)
            rows.append(self.rows(sigma))
            mus.append(mu)
        y_hat = torch.cat(y_hats, 1)
        return {"z_sym": z_sym.to(torch.int32),
                "y_sym": torch.cat(syms, 1).to(torch.int32),
                "idx": torch.cat(rows, 1), "mu": torch.cat(mus, 1),
                "y_hat": y_hat,
                "x_hat": torch.clamp(self.synthesis(y_hat), 0.0, 1.0)}

    # -- training -----------------------------------------------------------

    def loss(self, x, noise_y, noise_z, lmbda, alpha, gamma=2.0):
        """(RD loss, aux loss) of occupancy x [N, 1, B, B, B]; noises
        NDHWC."""
        eb = self.p["entropy_bottleneck"]
        y = self.analysis(x)
        z = self.hyper_analysis(y)
        z_tilde = z + noise_z.permute(0, 4, 1, 2, 3)
        c = z_tilde.shape[1]
        flat = z_tilde.transpose(0, 1).reshape(c, 1, -1)
        lo = _logits_cumulative(eb, flat - 0.5)
        hi = _logits_cumulative(eb, flat + 0.5)
        sign = -torch.sign(lo + hi).detach()
        z_lik = lower_bound(torch.abs(torch.sigmoid(sign * hi)
                                      - torch.sigmoid(sign * lo)),
                            LIKELIHOOD_BOUND)
        z_hat = _round_st(z - self.median()) + self.median()
        hyper = (self.hyper_synthesis(z_hat, "hyper_synthesis_mean_t"),
                 self.hyper_synthesis(z_hat, "hyper_synthesis_t"))
        cs = y.shape[1] // self.num_slices
        u = noise_y.permute(0, 4, 1, 2, 3)
        y_hats, bits = [], torch.sum(torch.log(z_lik))
        for k in range(self.num_slices):
            part = slice(k * cs, (k + 1) * cs)
            mu, sigma, support = self._slice(k, hyper, y_hats)
            v = torch.abs(y[:, part] + u[:, part] - mu)
            lik = lower_bound(_phi((0.5 - v) / sigma)
                              - _phi((-0.5 - v) / sigma), LIKELIHOOD_BOUND)
            bits = bits + torch.sum(torch.log(lik))
            q = _round_st(y[:, part] - mu) + mu
            lrp = self.net(f"slice_lrp_{k}",
                           torch.cat([hyper[0]] + support + [q], 1))
            y_hats.append(q + 0.5 * torch.tanh(lrp))
        x_tilde = self.synthesis(torch.cat(y_hats, 1))
        pt_1 = torch.where(x == 1, x_tilde, 1.0)
        pt_1 = torch.minimum(torch.maximum(pt_1, pt_1.new_tensor(1e-3)),
                             pt_1.new_tensor(0.999))
        pt_0 = torch.where(x == 0, x_tilde, 0.0)
        pt_0 = torch.minimum(torch.maximum(pt_0, pt_0.new_tensor(1e-3)),
                             pt_0.new_tensor(0.999))
        focal = (-torch.sum(alpha * (1 - pt_1) ** gamma * torch.log(pt_1))
                 - torch.sum((1 - alpha) * pt_0 ** gamma
                             * torch.log(1 - pt_0)))
        rate = bits / (-math.log(2) * torch.sum(x))
        t = TAIL_MASS
        targets = torch.log(torch.tensor([t / 2, 0.5, 1 - t / 2])
                            / torch.tensor([1 - t / 2, 0.5, t / 2]))
        q = _logits_cumulative(eb, eb["quantiles"][:, None, :], detach=True)
        aux = torch.sum(torch.abs(q[:, 0, :] - targets.to(x.device)))
        return lmbda * focal + rate, aux

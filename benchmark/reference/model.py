"""Plain PyTorch reference of the codec's models (Quach, Valenzise, Dufaux,
"Improved deep point cloud geometry compression", arXiv:2006.09043):
analysis, hyper analysis, hyper synthesis and synthesis transforms, the
quantization of y and z, and the decoded occupancy probabilities x_hat.

Written from the published architectures, on NCDHW tensors and the flax
weight tree as the committed files hold it (kernels DHWIO). It imports
nothing of the program: convolutions are ``F.conv3d`` with XLA ``SAME``
padding, transposed convolutions ``F.conv_transpose3d`` with the flax
(correlation) kernel flipped, and the factorized prior's median is solved
here by float64 bisection. Float32 with TF32 off (:func:`f32_convs`); the
control of the benchmark's check runs the same code with TF32 on.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["f32_convs", "conv", "conv_t", "Transforms", "tensor_tree",
           "ReferenceModel", "factorized_medians", "scale_table"]


def scale_table(lo=0.11, hi=256.0, levels=64):
    """The conditional's log-spaced table of scales (the paper's code,
    ``model_types.py``): y is coded under the smallest table scale at or
    above its predicted scale, which is bounded below by the first."""
    return np.exp(np.linspace(np.log(lo), np.log(hi), levels))


def f32_convs(tf32=False):
    """Full f32 convolutions and matmuls (``tf32=True``: the control's
    lower precision)."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _same_pads(n, k, s):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _t(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def conv(x, kernel, bias, s):
    """flax ``nn.Conv(padding="SAME")``, stride ``s``, of NCDHW ``x`` with a
    DHWIO ``kernel``."""
    pads = []
    for n in reversed(x.shape[2:]):
        pads.extend(_same_pads(n, kernel.shape[0], s))
    return F.conv3d(F.pad(x, pads), kernel.permute(4, 3, 0, 1, 2), bias, s)


def conv_t(x, kernel, bias, s):
    """flax ``nn.ConvTranspose(padding="SAME")`` (``lax.conv_transpose``:
    the input dilated by ``s`` and correlated with the kernel as stored) of
    NCDHW ``x``: ``conv_transpose3d`` with the kernel flipped, (I, O), the
    high side cropped to the flax length."""
    k = kernel.shape[0]
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    pad_b = pad_len - pad_a
    assert pad_b <= pad_a
    w = kernel.flip(0, 1, 2).permute(3, 4, 0, 1, 2)
    y = F.conv_transpose3d(x, w, bias, s, k - 1 - pad_a)
    out = (x.shape[2] - 1) * s + pad_a + pad_b - k + 2
    return y[:, :, :out, :out, :out]


class Transforms:
    """The four transforms of a v2 (hyperprior) model over a flax weight
    tree of tensors (kernels DHWIO), read at every call so that the same
    code trains: V1 (k9 / k5 stride-2 stacks) or the V2 residual blocks
    (a strided conv and two convs with a skip) of ``analysis``."""

    def __init__(self, tree, analysis):
        self.tree = tree
        self.v1 = analysis.endswith("V1")

    @staticmethod
    def _layer(leaf, x, s, transpose):
        fn = conv_t if transpose else conv
        return fn(x, leaf["kernel"], leaf.get("bias"), s)

    def _stack(self, t, x, name, transpose):
        L = self._layer
        if self.v1:
            for i in range(3):
                x = L(t[f"{name}_{i}"], x, 2, transpose)
                if i < 2 or transpose:
                    x = F.relu(x)
            return x
        block = "SynthesisBlock" if transpose else "AnalysisBlock"
        for i in range(3):
            b = t[f"{block}_{i}"]
            h = F.relu(L(b[f"{name}_0"], x, 2, transpose))
            u = F.relu(L(b[f"{name}_1"], h, 1, transpose))
            x = h + F.relu(L(b[f"{name}_2"], u, 1, transpose))
        x = L(t[f"{name}_0"], x, 1, transpose)
        return F.relu(x) if transpose else x

    def analysis_t(self, x):
        return self._stack(self.tree["analysis_t"], x, "Conv", False)

    def synthesis_t(self, y):
        return self._stack(self.tree["synthesis_t"], y, "ConvTranspose",
                           True)

    def hyper_analysis_t(self, y):
        t = self.tree["hyper_analysis_t"]
        z = F.relu(self._layer(t["Conv_0"], y, 1, False))
        z = F.relu(self._layer(t["Conv_1"], z, 2, False))
        return self._layer(t["Conv_2"], z, 1, False)

    def hyper_synthesis_t(self, z):
        t = self.tree["hyper_synthesis_t"]
        for i, s in enumerate((1, 2, 1)):
            z = F.relu(self._layer(t[f"ConvTranspose_{i}"], z, s, True))
        return z


def tensor_tree(tree, device):
    """A numpy weight tree as float32 tensors on ``device``."""
    return {k: tensor_tree(v, device) if isinstance(v, dict) else
            _t(v, device) for k, v in tree.items()}


class ReferenceModel:
    """The inference half of a v2 (hyperprior) model from its flax weight
    tree: ``symbols(x)``, ``scale_rows(z_sym)`` and ``x_hat(y_sym)``."""

    def __init__(self, tree, analysis, synthesis, device):
        self.device = torch.device(device)
        self.t = Transforms(tensor_tree(tree, device), analysis)
        self.z_median = _t(factorized_medians(tree["entropy_bottleneck"]),
                           device)
        self.table = scale_table()

    @torch.no_grad()
    def symbols(self, occupancy):
        """[N, 1, B, B, B] f32 occupancy → (y_sym, z_sym) int32, NCDHW."""
        y = self.t.analysis_t(occupancy)
        z = self.t.hyper_analysis_t(y)
        z_sym = torch.round(z - self.z_median.view(1, -1, 1, 1, 1))
        return torch.round(y).to(torch.int32), z_sym.to(torch.int32)

    @torch.no_grad()
    def scale_rows(self, z_sym):
        """z symbols → each y element's row of :func:`scale_table`
        (int64, NCDHW): the hyper synthesis of ẑ = z_sym + median."""
        z_hat = z_sym.float() + self.z_median.view(1, -1, 1, 1, 1)
        sigma = self.t.hyper_synthesis_t(z_hat).clamp_min(
            float(self.table[0]))
        rows = torch.zeros(sigma.shape, dtype=torch.int64,
                           device=sigma.device)
        for s in self.table[:-1].astype(np.float32):
            rows += sigma > float(s)
        return rows

    @torch.no_grad()
    def x_hat(self, y_sym):
        """y symbols → decoded occupancy probabilities [N, B, B, B] f32 in
        [0, 1]."""
        return torch.clamp(self.t.synthesis_t(y_sym.float()), 0.0, 1.0)[:, 0]


def _cumulative_logit(p, x):
    """The factorized prior's monotone cumulative logit, float64, at
    [C, M] points (Ballé et al. 2018, appendix 6.1)."""
    u = x[:, None, :]
    n = sum(1 for k in p if k.startswith("matrix_"))
    for k in range(n):
        m = np.logaddexp(0.0, np.asarray(p[f"matrix_{k}"], np.float64))
        u = np.einsum("cij,cjm->cim", m, u) + np.asarray(p[f"bias_{k}"],
                                                         np.float64)
        if f"factor_{k}" in p:
            u = u + np.tanh(np.asarray(p[f"factor_{k}"], np.float64)) \
                * np.tanh(u)
    return u[:, 0, :]


def factorized_medians(p):
    """Per channel the point where the cumulative is one half (logit 0),
    by float64 bisection on a bracket grown until it holds the root."""
    c = np.asarray(p["quantiles"]).shape[0]
    lo, hi = np.full((c, 1), -1.0), np.full((c, 1), 1.0)
    for _ in range(64):
        grow_lo = _cumulative_logit(p, lo) > 0
        grow_hi = _cumulative_logit(p, hi) < 0
        if not (grow_lo.any() or grow_hi.any()):
            break
        lo, hi = np.where(grow_lo, 2 * lo, lo), np.where(grow_hi, 2 * hi, hi)
    for _ in range(100):
        mid = (lo + hi) / 2
        up = _cumulative_logit(p, mid) < 0
        lo, hi = np.where(up, mid, lo), np.where(up, hi, mid)
    return ((lo + hi) / 2)[:, 0].astype(np.float32)

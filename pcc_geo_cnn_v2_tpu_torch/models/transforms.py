"""Analysis/synthesis transform stacks as torch modules.

Port of ``pcc_geo_cnn_v2_tpu/models/transforms.py`` (V2, ProgressiveV2
and the hyper transforms, ``add`` residual mode). Modules run NCDHW
inside; the codec model converts from and to the JAX package's NDHWC at
its public methods. Submodule names are the flax auto-names
(``AnalysisBlock_0``, ``Conv_1``, ``ConvTranspose_0``…) so weight import is
one rule per leaf (``weights.params_from_jax``).

Padding follows XLA's ``SAME`` rules exactly, written out:

- ``Conv`` stride s: ``pad_total = max((ceil(n/s) - 1)·s + k - n, 0)``,
  split low = total // 2 — a stride-2 k3 conv on an even size pads (0, 1),
  which no symmetric torch ``padding=`` reproduces, hence the explicit
  ``F.pad``.
- ``ConvTranspose`` (flax, ``transpose_kernel=False``) is
  ``lax.conv_transpose``: the input is dilated by s, padded
  ``(pad_a, pad_b)`` with ``pad_len = k + s - 2``, ``pad_a = k - 1`` if
  ``s > k - 1`` else ``ceil(pad_len / 2)``, and correlated with the
  UNFLIPPED kernel. ``F.conv_transpose3d`` (kernel flipped, I/O swapped)
  would give the same values, but cuDNN's deterministic algorithm for it
  is slow; :class:`ConvTranspose` instead
  runs forward convs on the un-flipped kernel (see its docstring).
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv", "ConvTranspose", "AnalysisBlock", "SynthesisBlock",
           "BlockStack", "HyperAnalysisTransform", "HyperSynthesisTransform",
           "TRANSFORMS"]


def same_pads(n, k, s):
    """XLA ``SAME`` (low, high) padding of one spatial dim."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def transpose_pads(k, s):
    """``lax.conv_transpose`` ``SAME`` (pad_a, pad_b) of one spatial dim."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


class Conv(nn.Module):
    """flax ``nn.Conv(padding="SAME")`` on NCDHW; weight OIDHW."""

    def __init__(self, cin, cout, kernel=3, stride=1, bias=True):
        super().__init__()
        self.k, self.s = kernel, stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        pads = []
        for n in reversed(x.shape[2:]):  # F.pad lists the last dim first
            pads.extend(same_pads(n, self.k, self.s))
        return F.conv3d(F.pad(x, pads), self.weight, self.bias, self.s)


def _parity_taps(k, s, pad_a, r):
    """Kernel taps reaching real inputs for outputs j ≡ r (mod s) of a
    ``lax.conv_transpose``, and the input offset of the first one: output
    j = s·i + r reads input i + o0 + t through tap ``taps[t]``."""
    taps = [m for m in range(k) if (r + m - pad_a) % s == 0]
    return taps, ((r + taps[0] - pad_a) // s if taps else 0)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(padding="SAME")`` on NCDHW; weight OIDHW
    holding the flax (correlation) kernel.

    Computed as a sub-pixel decomposition: for each output parity class
    (j mod s per axis) only the taps that meet real inputs of the dilated
    input contribute, so the layer is s³ forward ``conv3d`` calls with
    small kernels, interleaved — the same products as the dilated
    correlation without the zeros. Forward convs keep cuDNN on fast
    deterministic algorithms (its deterministic transposed-conv algorithm
    is an order of magnitude slower at these shapes); at stride 1 it is a
    single ``conv3d``.
    """

    def __init__(self, cin, cout, kernel=3, stride=1, bias=True):
        super().__init__()
        self.k, self.s = kernel, stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        k, s = self.k, self.s
        pad_a, pad_b = transpose_pads(k, s)
        if s == 1:
            return F.conv3d(F.pad(x, (pad_a, pad_b) * 3), self.weight,
                            self.bias)
        sizes = x.shape[2:]
        outs = [(n - 1) * s + pad_a + pad_b - k + 2 for n in sizes]
        y = x.new_zeros((x.shape[0], self.weight.shape[0], *outs))
        for rs in itertools.product(range(s), repeat=3):
            w, pads = self.weight, []
            for ax, (r, n, L) in enumerate(zip(rs, sizes, outs)):
                taps, o0 = _parity_taps(k, s, pad_a, r)
                if not taps:
                    break
                w = w.index_select(2 + ax, torch.tensor(taps,
                                                        device=x.device))
                n_r = len(range(r, L, s))
                # read x[o0 .. o0 + n_r + len(taps) - 2]; F.pad crops when
                # a pad is negative
                pads.append((-o0, o0 + n_r + len(taps) - 1 - n))
            else:
                flat = [p for pair in reversed(pads) for p in pair]
                y[:, :, rs[0]::s, rs[1]::s, rs[2]::s] = F.conv3d(
                    F.pad(x, flat), w)
        if self.bias is not None:
            y = y + self.bias.view(1, -1, 1, 1, 1)
        return y


class AnalysisBlock(nn.Module):
    """Strided conv + two convs, ``h + f(h)`` skip (``add`` mode)."""

    def __init__(self, cin, filters, kernel=3, strides=2):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, kernel, strides)
        self.Conv_1 = Conv(filters, filters, kernel)
        self.Conv_2 = Conv(filters, filters, kernel)

    def forward(self, x):
        h = F.relu(self.Conv_0(x))
        t = F.relu(self.Conv_1(h))
        return h + F.relu(self.Conv_2(t))


class SynthesisBlock(nn.Module):
    """Strided transposed conv + two transposed convs, ``add`` skip."""

    def __init__(self, cin, filters, kernel=3, strides=2):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(cin, filters, kernel, strides)
        self.ConvTranspose_1 = ConvTranspose(filters, filters, kernel)
        self.ConvTranspose_2 = ConvTranspose(filters, filters, kernel)

    def forward(self, x):
        h = F.relu(self.ConvTranspose_0(x))
        t = F.relu(self.ConvTranspose_1(h))
        return h + F.relu(self.ConvTranspose_2(t))


class BlockStack(nn.Module):
    """Shared body of the V2 analysis/synthesis families."""

    def __init__(self, filters, widths, synthesis, cin, kernel=3):
        super().__init__()
        self.synthesis = synthesis
        block = SynthesisBlock if synthesis else AnalysisBlock
        name = "SynthesisBlock" if synthesis else "AnalysisBlock"
        c = cin
        for i, frac in enumerate(widths):
            f = int(filters * frac)
            setattr(self, f"{name}_{i}", block(c, f, kernel))
            c = f
        self.n_blocks = len(widths)
        self.block_name = name
        if synthesis:
            self.ConvTranspose_0 = ConvTranspose(c, 1, kernel)
        else:
            self.Conv_0 = Conv(c, filters, kernel, bias=False)

    def forward(self, x):
        for i in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x)
        if self.synthesis:
            return F.relu(self.ConvTranspose_0(x))
        return self.Conv_0(x)


def AnalysisTransformV2(filters):
    return BlockStack(filters, (0.5, 1, 1), synthesis=False, cin=1)


def SynthesisTransformV2(filters):
    return BlockStack(filters, (1, 1, 0.5), synthesis=True, cin=filters)


def AnalysisTransformProgressiveV2(filters):
    return BlockStack(filters, (0.25, 0.5, 1), synthesis=False, cin=1)


def SynthesisTransformProgressiveV2(filters):
    return BlockStack(filters, (1, 0.5, 0.25), synthesis=True, cin=filters)


class HyperAnalysisTransform(nn.Module):
    """y → z: conv, stride-2 conv, linear conv."""

    def __init__(self, filters):
        super().__init__()
        self.Conv_0 = Conv(filters, filters, 3)
        self.Conv_1 = Conv(filters, filters, 3, 2)
        self.Conv_2 = Conv(filters, filters, 3, bias=False)

    def forward(self, x):
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        return self.Conv_2(x)


class HyperSynthesisTransform(nn.Module):
    """z → σ: deconv, stride-2 deconv, deconv, all ReLU."""

    def __init__(self, filters):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(filters, filters, 3)
        self.ConvTranspose_1 = ConvTranspose(filters, filters, 3, 2)
        self.ConvTranspose_2 = ConvTranspose(filters, filters, 3)

    def forward(self, x):
        x = F.relu(self.ConvTranspose_0(x))
        x = F.relu(self.ConvTranspose_1(x))
        return F.relu(self.ConvTranspose_2(x))


TRANSFORMS = {
    "AnalysisTransformV2": AnalysisTransformV2,
    "SynthesisTransformV2": SynthesisTransformV2,
    "AnalysisTransformProgressiveV2": AnalysisTransformProgressiveV2,
    "SynthesisTransformProgressiveV2": SynthesisTransformProgressiveV2,
    "HyperAnalysisTransform": HyperAnalysisTransform,
    "HyperSynthesisTransform": HyperSynthesisTransform,
}

"""Analysis/synthesis transform stacks as torch modules.

Port of ``pcc_geo_cnn_v2_tpu/models/transforms.py``: V1 (k9/k5/k5
stride-2 stacks), V2, ProgressiveV2 (``add`` and ``concat`` residual
modes) and the hyper transforms. Modules run NCDHW
inside; the codec model converts from and to the JAX package's NDHWC at
its public methods. Submodule names are the flax auto-names
(``AnalysisBlock_0``, ``Conv_1``, ``ConvTranspose_0``…) so weight import is
one rule per leaf (``weights.params_from_jax``).

Every layer takes a ``dtype`` as the flax modules do: the input and the
parameters are cast to it, the convolution sums in f32 and rounds its
result to ``dtype``, the bias is added in ``dtype``, and the result stays
in ``dtype``; the parameters themselves stay f32. ``None`` is f32.

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

import contextlib
import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn

from pcc_geo_cnn_v2_tpu_torch.ops import conv_one_out
from pcc_geo_cnn_v2_tpu_torch.utils import trace

__all__ = ["Conv", "ConvTranspose", "subpixel_conv_transpose",
           "AnalysisTransformV1", "SynthesisTransformV1", "AnalysisBlock",
           "SynthesisBlock", "BlockStack", "AnalysisTransformV2",
           "SynthesisTransformV2", "AnalysisTransformProgressiveV2",
           "SynthesisTransformProgressiveV2", "HyperAnalysisTransform",
           "HyperSynthesisTransform", "SliceTransform", "TRANSFORMS"]

RESIDUAL_MODES = ("add", "concat")


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


def _cast(x, weight, bias, dtype):
    """Operands of a layer computing in ``dtype`` (None: as they are)."""
    if dtype is None or dtype == x.dtype == weight.dtype:
        return x, weight, bias
    return (x.to(dtype), weight.to(dtype),
            None if bias is None else bias.to(dtype))


def _conv3d(x, weight, stride=1):
    """``F.conv3d`` without bias. A reduced-precision conv on the CPU is
    computed on the operands widened to f32 and rounded once, which is
    what the card's tensor cores do (f32 accumulation); ATen's CPU kernels
    leave their accumulation type open."""
    if x.device.type == "cpu" and x.dtype != torch.float32:
        return F.conv3d(x.float(), weight.float(), None, stride).to(x.dtype)
    return F.conv3d(x, weight, None, stride)


def _add_bias(y, bias):
    return y if bias is None else y + bias.view(1, -1, 1, 1, 1)


class Conv(nn.Module):
    """flax ``nn.Conv(padding="SAME")`` on NCDHW; weight OIDHW."""

    def __init__(self, cin, cout, kernel=3, stride=1, bias=True, dtype=None):
        super().__init__()
        self.k, self.s, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x, dtype=None):
        """:param dtype: compute type of this call (default: the layer's)."""
        x, w, b = _cast(x, self.weight, self.bias, dtype or self.dtype)
        pads = []
        for n in reversed(x.shape[2:]):  # F.pad lists the last dim first
            pads.extend(same_pads(n, self.k, self.s))
        if x.dtype == torch.float32:
            return F.conv3d(F.pad(x, pads), w, b, self.s)
        return _add_bias(_conv3d(F.pad(x, pads), w, self.s), b)


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
    single ``conv3d``. A layer into one output channel runs instead on
    the hand-written ``conv_one_out`` where ``conv_one_out.routes`` says
    so (f32 on the card, in a pass that records no graph): cuDNN fills one
    column of its tile with it.
    """

    def __init__(self, cin, cout, kernel=3, stride=1, bias=True, dtype=None):
        super().__init__()
        self.k, self.s, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x, dtype=None):
        """:param dtype: compute type of this call (default: the layer's)."""
        k, s = self.k, self.s
        x, weight, bias = _cast(x, self.weight, self.bias,
                                dtype or self.dtype)
        if conv_one_out.routes(x, weight, s):
            with (trace.span("transforms.conv_transpose") if s > 1
                  else contextlib.nullcontext()):
                return conv_one_out.conv_transpose_one_out(
                    x, self._one_out_table(weight), bias, k, s)
        pad_a, pad_b = transpose_pads(k, s)
        if s == 1:
            xp = F.pad(x, (pad_a, pad_b) * 3)
            if x.dtype == torch.float32:
                return F.conv3d(xp, weight, bias)
            return _add_bias(_conv3d(xp, weight), bias)
        outs = [(n - 1) * s + pad_a + pad_b - k + 2 for n in x.shape[2:]]
        # a span in passes that record no graph (the codec's): in training
        # the layer's backward kernels would fall outside it
        with (contextlib.nullcontext() if torch.is_grad_enabled()
              else trace.span("transforms.conv_transpose")):
            return _add_bias(subpixel_conv_transpose(x, weight, s, outs),
                             bias)

    def _one_out_table(self, weight):
        """``conv_one_out``'s packed table of ``weight``, packed once and
        again after the weight was written or moved; complete on the card
        when returned, as other threads' streams read it."""
        key = (weight.data_ptr(), weight._version, str(weight.device))
        hit = self.__dict__.get("_one_out")
        if hit is None or hit[0] != key:
            table = conv_one_out.pack_weights(weight, self.s)
            if table.is_cuda:
                torch.cuda.current_stream(table.device).synchronize()
            self.__dict__["_one_out"] = hit = (key, table)
        return hit[1]


def subpixel_conv_transpose(x, weight, s, outs, shifts=(0, 0, 0)):
    """``lax.conv_transpose`` (``SAME``, stride ``s``, un-flipped OIDHW
    ``weight``) of NCDHW ``x`` without bias, as s³ forward convs, one a
    parity class: output j = s·i + r of an axis reads input
    i + o0 + t through tap ``taps[t]`` (:func:`_parity_taps`).

    :param outs: the output length of each spatial axis.
    :param shifts: per axis, how many planes ``x`` holds before the
        global input's first: output j then reads ``x[i + o0 + t +
        shift]``. 0 for a whole input; a depth slab extended by a halo of
        ``shift`` planes of its lower neighbour gives the slab's outputs
        (``parallel.spatial``). Planes read outside ``x`` are zeros.
    """
    ks = weight.shape[2:]
    sizes = x.shape[2:]
    # the parity classes are written into the input's memory format
    last = (x.is_contiguous(memory_format=torch.channels_last_3d)
            and not x.is_contiguous())
    y = torch.empty(
        (x.shape[0], weight.shape[0], *outs), dtype=x.dtype,
        device=x.device, memory_format=torch.channels_last_3d if last
        else torch.contiguous_format).zero_()
    for rs in itertools.product(range(s), repeat=3):
        w, pads = weight, []
        for ax, (r, n, L, shift, k) in enumerate(zip(rs, sizes, outs, shifts,
                                                      ks)):
            taps, o0 = _parity_taps(k, s, transpose_pads(k, s)[0], r)
            if not taps:
                break
            w = w.index_select(2 + ax, torch.tensor(taps, device=x.device))
            n_r = len(range(r, L, s))
            # read x[o .. o + n_r + len(taps) - 2]; F.pad crops when a pad
            # is negative
            o = o0 + shift
            pads.append((-o, o + n_r + len(taps) - 1 - n))
        else:
            flat = [p for pair in reversed(pads) for p in pair]
            y[:, :, rs[0]::s, rs[1]::s, rs[2]::s] = _conv3d(F.pad(x, flat), w)
    return y


class AnalysisTransformV1(nn.Module):
    """Three stride-2 convs, k9 → k5 → k5 (linear, no bias): ×8 down."""

    def __init__(self, filters, dtype=None):
        super().__init__()
        self.Conv_0 = Conv(1, filters, 9, 2, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, 5, 2, dtype=dtype)
        self.Conv_2 = Conv(filters, filters, 5, 2, bias=False, dtype=dtype)

    def forward(self, x):
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        return self.Conv_2(x)


class SynthesisTransformV1(nn.Module):
    """Three stride-2 transposed convs, k5 → k5 → k9 to one channel, all
    ReLU: ×8 up."""

    def __init__(self, filters, dtype=None):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(filters, filters, 5, 2,
                                             dtype=dtype)
        self.ConvTranspose_1 = ConvTranspose(filters, filters, 5, 2,
                                             dtype=dtype)
        self.ConvTranspose_2 = ConvTranspose(filters, 1, 9, 2, dtype=dtype)

    def forward(self, x):
        x = F.relu(self.ConvTranspose_0(x))
        x = F.relu(self.ConvTranspose_1(x))
        return F.relu(self.ConvTranspose_2(x))


def _skip(h, t, residual_mode):
    """``add``: h + t; ``concat``: channels (t, h)."""
    return h + t if residual_mode == "add" else torch.cat((t, h), dim=1)


class AnalysisBlock(nn.Module):
    """Strided conv + two convs with a skip from the strided output
    (``residual_mode`` ``add``: ``h + f(h)``; ``concat``: ``(f(h), h)``
    on channels, 2·filters out)."""

    def __init__(self, cin, filters, kernel=3, strides=2, dtype=None,
                 residual_mode="add"):
        super().__init__()
        self.residual_mode = residual_mode
        self.Conv_0 = Conv(cin, filters, kernel, strides, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, kernel, dtype=dtype)
        self.Conv_2 = Conv(filters, filters, kernel, dtype=dtype)

    def forward(self, x):
        h = F.relu(self.Conv_0(x))
        t = F.relu(self.Conv_1(h))
        return _skip(h, F.relu(self.Conv_2(t)), self.residual_mode)


class SynthesisBlock(nn.Module):
    """Strided transposed conv + two transposed convs with a skip (as
    :class:`AnalysisBlock`)."""

    def __init__(self, cin, filters, kernel=3, strides=2, dtype=None,
                 residual_mode="add"):
        super().__init__()
        self.residual_mode = residual_mode
        self.ConvTranspose_0 = ConvTranspose(cin, filters, kernel, strides,
                                             dtype=dtype)
        self.ConvTranspose_1 = ConvTranspose(filters, filters, kernel,
                                             dtype=dtype)
        self.ConvTranspose_2 = ConvTranspose(filters, filters, kernel,
                                             dtype=dtype)

    def forward(self, x):
        h = F.relu(self.ConvTranspose_0(x))
        t = F.relu(self.ConvTranspose_1(h))
        return _skip(h, F.relu(self.ConvTranspose_2(t)), self.residual_mode)


class BlockStack(nn.Module):
    """Shared body of the V2 analysis/synthesis families."""

    def __init__(self, filters, widths, synthesis, cin, kernel=3,
                 dtype=None, residual_mode="add"):
        super().__init__()
        if residual_mode not in RESIDUAL_MODES:
            raise ValueError(f"residual_mode {residual_mode!r} is not one "
                             f"of {RESIDUAL_MODES}")
        self.synthesis = synthesis
        self.dtype = dtype
        self.residual_mode = residual_mode
        block = SynthesisBlock if synthesis else AnalysisBlock
        name = "SynthesisBlock" if synthesis else "AnalysisBlock"
        c = cin
        for i, frac in enumerate(widths):
            f = int(filters * frac)
            setattr(self, f"{name}_{i}", block(c, f, kernel, dtype=dtype,
                                               residual_mode=residual_mode))
            c = f if residual_mode == "add" else 2 * f
        self.n_blocks = len(widths)
        self.block_name = name
        if synthesis:
            self.ConvTranspose_0 = ConvTranspose(c, 1, kernel, dtype=dtype)
        else:
            self.Conv_0 = Conv(c, filters, kernel, bias=False, dtype=dtype)

    def forward(self, x):
        for i in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x)
        if self.synthesis:
            return F.relu(self.ConvTranspose_0(x))
        return self.Conv_0(x)


def AnalysisTransformV2(filters, dtype=None, residual_mode="add"):
    return BlockStack(filters, (0.5, 1, 1), synthesis=False, cin=1,
                      dtype=dtype, residual_mode=residual_mode)


def SynthesisTransformV2(filters, dtype=None, residual_mode="add"):
    return BlockStack(filters, (1, 1, 0.5), synthesis=True, cin=filters,
                      dtype=dtype, residual_mode=residual_mode)


def AnalysisTransformProgressiveV2(filters, dtype=None, residual_mode="add"):
    return BlockStack(filters, (0.25, 0.5, 1), synthesis=False, cin=1,
                      dtype=dtype, residual_mode=residual_mode)


def SynthesisTransformProgressiveV2(filters, dtype=None,
                                    residual_mode="add"):
    return BlockStack(filters, (1, 0.5, 0.25), synthesis=True, cin=filters,
                      dtype=dtype, residual_mode=residual_mode)


class HyperAnalysisTransform(nn.Module):
    """y → z: conv, stride-2 conv, linear conv."""

    def __init__(self, filters, dtype=None):
        super().__init__()
        self.Conv_0 = Conv(filters, filters, 3, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, 3, 2, dtype=dtype)
        self.Conv_2 = Conv(filters, filters, 3, bias=False, dtype=dtype)

    def forward(self, x):
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        return self.Conv_2(x)


class HyperSynthesisTransform(nn.Module):
    """z → σ: deconv, stride-2 deconv, deconv, all ReLU."""

    def __init__(self, filters, dtype=None):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(filters, filters, 3, dtype=dtype)
        self.ConvTranspose_1 = ConvTranspose(filters, filters, 3, 2,
                                             dtype=dtype)
        self.ConvTranspose_2 = ConvTranspose(filters, filters, 3, dtype=dtype)

    def forward(self, x):
        x = F.relu(self.ConvTranspose_0(x))
        x = F.relu(self.ConvTranspose_1(x))
        return F.relu(self.ConvTranspose_2(x))


class SliceTransform(nn.Module):
    """One net of the channel-wise context model (Minnen & Singh 2020):
    conv k3 → ``widths[0]``, ReLU; conv k3 → ``widths[1]``, ReLU; conv k3
    → ``cout``, linear. Stride 1: it maps a latent-sized input to one
    slice's μ, σ or latent residual."""

    def __init__(self, cin, cout, widths=(48, 32), dtype=None):
        super().__init__()
        self.Conv_0 = Conv(cin, widths[0], 3, dtype=dtype)
        self.Conv_1 = Conv(widths[0], widths[1], 3, dtype=dtype)
        self.Conv_2 = Conv(widths[1], cout, 3, dtype=dtype)

    def forward(self, x):
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        return self.Conv_2(x)


TRANSFORMS = {
    "AnalysisTransformV1": AnalysisTransformV1,
    "SynthesisTransformV1": SynthesisTransformV1,
    "AnalysisTransformV2": AnalysisTransformV2,
    "SynthesisTransformV2": SynthesisTransformV2,
    "AnalysisTransformProgressiveV2": AnalysisTransformProgressiveV2,
    "SynthesisTransformProgressiveV2": SynthesisTransformProgressiveV2,
    "HyperAnalysisTransform": HyperAnalysisTransform,
    "HyperSynthesisTransform": HyperSynthesisTransform,
}

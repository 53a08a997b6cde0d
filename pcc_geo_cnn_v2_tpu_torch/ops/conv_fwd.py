"""Stride-1 k3 convolutions of the synthesis tails on the card.

c3p's synthesis blocks end in two stride-1 k3 C → C layers each; those
at 16 → 16 at 64³ and 32 → 32 at 32³ hold 75% of a decoded block's
convolution FLOPs. cuDNN runs them in f32 as an implicit GEMM at about 15
TFLOP/s; ``csrc/conv_fwd.cu`` computes the same correlation with f32 FFMA,
each output summed by one thread in cuDNN's order (input channel, then the
27 taps), the SAME padding from its loader's zero fill, the bias and the
ReLU that follows every such layer in its epilogue.

- :func:`routes` — whether a call takes the kernel: CUDA, f32, k3 stride
  1, contiguous NCDHW input, (cin, cout, volume) in :data:`SHAPES`, and no
  autograd graph being recorded. Every other call keeps the caller's own
  path (training keeps cuDNN's forward and ``conv_wgrad``).
- :func:`pack_weights` — the ``[cin, 27, cout]`` weight table, in the
  order the kernel's inner loop reads it.
- :func:`conv3d` — the kernel's wrapper; :func:`conv3d_plain` is the same
  function in plain PyTorch, summed in the kernel's order (the CPU tests'
  version of it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pcc_geo_cnn_v2_tpu_torch.ops import kernels

__all__ = ["INSTANCES", "SHAPES", "routes", "pack_weights", "conv3d",
           "conv3d_plain"]

# (cin, cout) the kernel is instantiated for (PCC_CONV_FWD_SHAPES in
# csrc/conv_fwd.cu)
INSTANCES = frozenset({(16, 16), (32, 32)})
# (cin, cout, volume) where the kernel beats cuDNN's f32 forward at the
# benchmark cells' 128-block chunk (PERF.md §6's layer table: 16 → 16 at
# 32³ is an analysis tail, which runs channels-last and so keeps cuDNN);
# the rest of the model's stride-1 k3 layers stay on cuDNN (32 → 32 at
# 16³ ties it, the 64-channel layers run at 40 TFLOP/s there)
SHAPES = frozenset({(16, 16, (64, 64, 64)), (16, 16, (32, 32, 32)),
                    (32, 32, (32, 32, 32))})


def routes(x, weight, k, s):
    """True when :func:`conv3d` computes the stride-``s`` SAME convolution
    of ``x`` by ``weight`` (``[cout, cin, k, k, k]``): both f32 on CUDA, k
    = 3, s = 1, ``x`` contiguous NCDHW with rows of a multiple of 16 bytes
    from a 16-byte aligned base (the kernel's tensor map), (cin, cout,
    volume) in :data:`SHAPES`, and no autograd graph recorded (the kernel
    has no backward)."""
    return (x.is_cuda and x.dtype == weight.dtype == torch.float32
            and k == 3 and s == 1 and x.dim() == 5 and x.is_contiguous()
            and x.shape[-1] % 4 == 0 and x.data_ptr() % 16 == 0
            and (x.shape[1], weight.shape[0], tuple(x.shape[2:])) in SHAPES
            and not torch.is_grad_enabled())


def pack_weights(weight):
    """The kernel's weight table of OIDHW ``weight`` ``[cout, cin, 3, 3,
    3]``: ``[cin, 27, cout]`` f32 with entry (c, 9·a + 3·b + e, o) =
    w[o, c, a, b, e]."""
    cout, cin = weight.shape[:2]
    return (weight.detach().float().reshape(cout, cin, 27)
            .permute(1, 2, 0).contiguous())


def conv3d_plain(x, table, bias=None, relu=False):
    """:func:`conv3d` in plain PyTorch, summed in the kernel's order for
    every output: input channel, then the taps (a, b, e) (a fused
    multiply-add there, a product and a sum here); then the bias and, with
    ``relu``, ``F.relu``."""
    n, cin, d, h, w = x.shape
    cout = table.shape[-1]
    xp = F.pad(x.float(), (1, 1) * 3)
    acc = x.new_zeros((n, cout, d, h, w), dtype=torch.float32)
    for c in range(cin):
        for tap in range(27):
            a, b, e = tap // 9, tap // 3 % 3, tap % 3
            acc += (table[c, tap].view(1, cout, 1, 1, 1)
                    * xp[:, c:c + 1, a:a + d, b:b + h, e:e + w])
    if bias is not None:
        acc = acc + bias.float().view(1, cout, 1, 1, 1)
    return F.relu(acc) if relu else acc


def conv3d(x, table, bias=None, relu=False):
    """The stride-1 k3 SAME convolution of NCDHW ``x`` by the weights
    packed into ``table`` (:func:`pack_weights`), plus ``bias`` ``[cout]``
    (or None), followed by a ReLU when ``relu``.

    :return: ``[N, cout, D, H, W]`` f32.
    """
    if x.device.type == "cpu":
        return conv3d_plain(x, table, bias, relu)
    n, cin = x.shape[:2]
    cout = table.shape[-1]
    if (cin, cout) not in INSTANCES:
        raise ValueError(f"conv_fwd: (cin, cout) = ({cin}, {cout}) is not "
                         f"one of {sorted(INSTANCES)}")
    kernels.check_cuda_tensor(x, "x", torch.float32)
    kernels.check_cuda_tensor(table, "table", torch.float32, (cin, 27, cout))
    if bias is not None:
        kernels.check_cuda_tensor(bias, "bias", torch.float32, (cout,))
    y = torch.empty((n, cout, *x.shape[2:]), dtype=torch.float32,
                    device=x.device)
    if x.shape[-1] % 4 or any(t.data_ptr() % 16 for t in (x, table, y)):
        raise ValueError("conv_fwd: x's rows must be a multiple of 16 bytes, "
                         "and x, table and output 16-byte aligned")
    lib = kernels.load("conv_fwd")
    kernels.launch("conv_fwd", lib.pcc_conv_fwd, x.device, x.data_ptr(),
                   table.data_ptr(), None if bias is None else bias.data_ptr(),
                   y.data_ptr(), cin, cout, n, *x.shape[2:], int(relu))
    return y

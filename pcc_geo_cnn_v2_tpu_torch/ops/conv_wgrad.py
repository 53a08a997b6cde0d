"""The weight gradient of stride-1 k3 convolutions on the card, in training.

Training runs its convolutions under cuDNN's deterministic algorithms
(``codec.deterministic_convs``). For few channels at large volumes cuDNN's
fast weight-gradient algorithms finish their reduction over positions with
float atomics, so it falls back to a direct kernel at about 1 TFLOP/s.
``csrc/conv_wgrad.cu`` splits the same reduction over the card and sums the
parts in a fixed order, so the gradient is both fast and bit-equal run to
run.

- :func:`routes` — whether a convolution takes :func:`conv3d`: a graph is
  being recorded and the weight requires a gradient, both f32 on CUDA, the
  input contiguous NCDHW or channels-last (the analysis transforms run
  channels-last: cuDNN keeps the layout of their one-channel input), k =
  3, stride 1, and (cin, cout) in :data:`SHAPES`. Every other call keeps
  the caller's own path; the codec's passes record no graph and are
  tested for that first.
- :func:`conv3d` — ``F.conv3d(xp, weight, bias)`` of a padded input whose
  backward takes the weight gradient from the kernel and the input and
  bias gradients from ``aten.convolution_backward`` (cuDNN, as before).
- :func:`conv3d_wgrad` — the kernel's wrapper;
  :func:`conv3d_wgrad_plain` is the same sum in plain PyTorch, split as
  the kernel splits it (the CPU tests' version of it).

The split (:func:`geometry`): positions come in tiles of
TD × TH × TW of one batch element, ordered (n, d, h, w); CTA b of
``ctas`` takes tiles [⌊T·b / ctas⌋, ⌊T·(b + 1) / ctas⌋). A tile's
segments of 8 positions along w, ordered (d, h, w), go to the CTA's
``groups`` thread groups in turn; each (CTA, group) sums its positions into
one slot of partials. The slots are then summed in 8 contiguous ranges,
each in order, and the 8 sums in order.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pcc_geo_cnn_v2_tpu_torch.ops import kernels

__all__ = ["SHAPES", "routes", "geometry", "tiles", "conv3d",
           "conv3d_wgrad", "conv3d_wgrad_plain"]

# (cin, cout) → (TD, TH): the instantiated shapes and their tiles
# (PCC_WGRAD_SHAPES in csrc/conv_wgrad.cu)
_TILES = {(16, 16): (4, 2), (32, 32): (2, 2), (16, 1): (4, 4)}
SHAPES = frozenset(_TILES)
TW, SEG, THREADS, CTAS, SUM_RANGES = 32, 8, 256, 132, 8


def routes(x, weight, k, s):
    """True when the stride-``s`` convolution of ``x`` by ``weight``
    (``[cout, cin, k, k, k]``) takes :func:`conv3d`: an autograd graph is
    being recorded and ``weight`` requires its gradient, both f32 on CUDA,
    ``x`` contiguous NCDHW or channels-last, k = 3, s = 1 and (cin, cout)
    in :data:`SHAPES`."""
    return (torch.is_grad_enabled() and weight.requires_grad
            and x.is_cuda and x.dtype == weight.dtype == torch.float32
            and k == 3 and s == 1 and x.dim() == 5
            and (x.is_contiguous()
                 or x.is_contiguous(memory_format=torch.channels_last_3d))
            and (x.shape[1], weight.shape[0]) in SHAPES)


def geometry(cin, cout):
    """(TD, TH, TW, groups) of (cin, cout): a tile's extent and the thread
    groups a CTA, each with its own slot of partials (a thread owns
    min(cout, 4) output channels and one input channel)."""
    td, th = _TILES[(cin, cout)]
    rco = min(cout, 4)
    return td, th, TW, THREADS // (cout // rco * cin)


def tiles(cin, cout, n, size):
    """The tiles of ``n`` volumes of ``size`` (D, H, W) positions."""
    td, th, tw, _ = geometry(cin, cout)
    d, h, w = size
    return n * -(-d // td) * -(-h // th) * -(-w // tw)


def _ctas(cin, cout, n, size):
    return min(tiles(cin, cout, n, size), CTAS)


def _partials_plain(xp, dy):
    """``[slots, cout·cin·27]``: each slot's sum of products, in the
    kernel's split, each slot summed in torch's own order."""
    n, cin = xp.shape[:2]
    cout, size = dy.shape[1], tuple(dy.shape[2:])
    td, th, tw, groups = geometry(cin, cout)
    ctas = _ctas(cin, cout, n, size)
    nd, nh, nw = (-(-m // t) for m, t in zip(size, (td, th, tw)))
    total = n * nd * nh * nw
    bounds = [total * b // ctas for b in range(ctas + 1)]
    q = td * th * (tw // SEG) // groups  # segments a group takes a tile

    def tiled(v):
        """``v`` [n, c, D, H, W] zero-padded to whole tiles, as [tiles, q,
        groups, 8, c]: segment s = q·groups + g of a tile."""
        c = v.shape[1]
        v = F.pad(v, (0, nw * tw - size[2], 0, nh * th - size[1],
                      0, nd * td - size[0]))
        v = v.reshape(n, c, nd, td, nh, th, nw, tw // SEG, SEG)
        v = v.permute(0, 2, 4, 6, 3, 5, 7, 8, 1)
        return v.reshape(total, q, groups, SEG, c)

    g = tiled(dy)
    out = xp.new_empty((ctas, groups, cout, cin, 27))
    for tap in range(27):
        a, b, c = tap // 9, tap // 3 % 3, tap % 3
        x = tiled(xp[:, :, a:a + size[0], b:b + size[1], c:c + size[2]])
        per_tile = torch.einsum("tqgvk,tqgvc->tgkc", g, x)
        for cta in range(ctas):
            out[cta, ..., tap] = per_tile[bounds[cta]:bounds[cta + 1]].sum(0)
    return out.reshape(ctas * groups, cout * cin * 27)


def conv3d_wgrad_plain(xp, dy):
    """:func:`conv3d_wgrad` in plain PyTorch: the partials of the kernel's
    split (within a slot torch's own order, where the
    kernel sums each segment's 8 positions in turn with FFMA), then the
    slots summed in the kernel's order; in the operands' dtype (f64 gives
    the card a reference of the exact sum)."""
    part = _partials_plain(xp, dy)
    slots = len(part)
    sums = []
    for r in range(SUM_RANGES):
        acc = torch.zeros_like(part[0])
        for k in range(slots * r // SUM_RANGES,
                       slots * (r + 1) // SUM_RANGES):
            acc = acc + part[k]
        sums.append(acc)
    dw = sums[0]
    for s in sums[1:]:
        dw = dw + s
    return dw.reshape(dy.shape[1], xp.shape[1], 3, 3, 3)


_geometry_checked = False


def _check_geometry(lib):
    """The split must be the built kernel's (once a process)."""
    global _geometry_checked
    if _geometry_checked:
        return
    for cin, cout in sorted(SHAPES):
        geo = (ctypes.c_int * 5)()
        if lib.pcc_conv_wgrad_geometry(cin, cout, geo) != 0:
            raise RuntimeError(f"conv_wgrad: ({cin}, {cout}) is not "
                               f"instantiated in the built kernel")
        want = (*geometry(cin, cout), CTAS)
        if tuple(geo) != want:
            raise RuntimeError(f"conv_wgrad: the kernel's split for ({cin}, "
                               f"{cout}) is {tuple(geo)}, the wrapper's "
                               f"{want}")
    _geometry_checked = True


def conv3d_wgrad(xp, dy):
    """The weight gradient ``[cout, cin, 3, 3, 3]`` of ``F.conv3d(xp, w)``
    (stride 1, no padding: ``xp`` is padded already) for the output
    gradient ``dy`` ``[N, cout, D, H, W]``; ``xp`` is ``[N, cin, D + 2, H +
    2, W + 2]``."""
    n, cin = xp.shape[:2]
    cout, size = dy.shape[1], tuple(dy.shape[2:])
    if (xp.dim() != 5 or dy.dim() != 5 or dy.shape[0] != n
            or tuple(xp.shape[2:]) != tuple(m + 2 for m in size)):
        raise ValueError(f"conv_wgrad: xp {tuple(xp.shape)} is not dy "
                         f"{tuple(dy.shape)} padded by one a side")
    if xp.device.type == "cpu":
        return conv3d_wgrad_plain(xp, dy)
    if (cin, cout) not in SHAPES:
        raise ValueError(f"conv_wgrad: (cin, cout) = ({cin}, {cout}) is not "
                         f"one of {sorted(SHAPES)}")
    kernels.check_cuda_tensor(xp, "xp", torch.float32)
    kernels.check_cuda_tensor(dy, "dy", torch.float32)
    lib = kernels.load("conv_wgrad")
    _check_geometry(lib)
    ctas = _ctas(cin, cout, n, size)
    slots = ctas * geometry(cin, cout)[3]
    part = torch.empty((slots, cout * cin * 27), dtype=torch.float32,
                       device=xp.device)
    dw = torch.empty((cout, cin, 3, 3, 3), dtype=torch.float32,
                     device=xp.device)
    kernels.launch("conv_wgrad", lib.pcc_conv_wgrad, xp.device,
                   xp.data_ptr(), dy.data_ptr(), part.data_ptr(),
                   dw.data_ptr(), cin, cout, n, *size, ctas)
    return dw


class _Conv3d(torch.autograd.Function):
    """``F.conv3d(xp, weight, bias)``, stride 1; the backward's weight
    gradient from :func:`conv3d_wgrad` (on NCDHW copies of channels-last
    operands), the input and bias gradients from
    ``aten.convolution_backward`` on the operands as they are."""

    @staticmethod
    def forward(ctx, xp, weight, bias):
        ctx.save_for_backward(xp, weight)
        ctx.bias_sizes = None if bias is None else [bias.shape[0]]
        return F.conv3d(xp, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        xp, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = db = dw = None
        if need_x or need_b:
            dx, _, db = torch.ops.aten.convolution_backward(
                dy, xp, weight, ctx.bias_sizes, [1] * 3, [0] * 3, [1] * 3,
                False, [0] * 3, 1, (need_x, False, need_b))
        if need_w:
            dw = conv3d_wgrad(xp.contiguous(), dy.contiguous())
        return dx, dw, db


def conv3d(xp, weight, bias=None):
    """``F.conv3d(xp, weight, bias)`` (stride 1, ``xp`` padded already),
    its weight gradient on the kernel (see :func:`routes`)."""
    return _Conv3d.apply(xp, weight, bias)

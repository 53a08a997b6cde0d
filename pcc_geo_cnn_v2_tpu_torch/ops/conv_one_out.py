"""Transposed convolutions into one output channel on the card.

The synthesis transforms end in a layer with a single output channel
(c1 / c2: k9, stride 2, 32 → 1; c3 / c3p: k3, stride 1, 16 → 1). cuDNN
runs it as an implicit GEMM whose N is that one channel, which fills one
column of its tile; ``csrc/conv_one_out.cu`` computes it instead: one
launch writes all s³ parity classes of the interleaved result, each output
summed by one thread in a fixed order (input channel, then the taps along
d, h, w), so the result does not depend on the batch width.

- :func:`routes` — whether a call takes the kernel: CUDA, f32, one output
  channel, contiguous NCDHW input, an instantiated (k, s, cin) of
  :data:`SHAPES`, and no autograd graph being recorded. Every other call
  keeps the caller's own path.
- :func:`pack_weights` — the ``[cin, NT, NT, s, s, GW]`` weight table in the
  order the kernel's inner loop reads it (:func:`geometry`).
- :func:`conv_transpose_one_out` — the kernel's wrapper;
  :func:`conv_transpose_one_out_plain` is the same function in plain
  PyTorch, summed in the kernel's order (the CPU tests' version of it).

Geometry (``lax.conv_transpose`` ``SAME``, :func:`transforms._parity_taps`):
along an axis, output j = s·i + r reads input i + d through kernel tap
m = s·d + pad_a − r, for d in [dmin, dmax] and 0 ≤ m < k.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pcc_geo_cnn_v2_tpu_torch.models import transforms
from pcc_geo_cnn_v2_tpu_torch.ops import kernels

__all__ = ["SHAPES", "routes", "geometry", "tap_table", "pack_weights",
           "conv_transpose_one_out", "conv_transpose_one_out_plain"]

# (k, s, cin) the kernel is instantiated for (PCC_ONE_OUT_SHAPES in
# csrc/conv_one_out.cu)
SHAPES = frozenset({(9, 2, 32), (3, 1, 16)})


def routes(x, weight, s):
    """True when ``conv_one_out`` computes the transposed conv of ``x`` by
    ``weight`` (``[cout, cin, k, k, k]``) at stride ``s``: both f32 on
    CUDA, cout 1, ``x`` contiguous NCDHW with rows of a multiple of 16
    bytes from a 16-byte aligned base (the kernel's tensor map), (k, s,
    cin) in :data:`SHAPES`, and no autograd graph recorded (training keeps
    cuDNN, whose backward the kernel does not have)."""
    return (x.is_cuda and x.dtype == weight.dtype == torch.float32
            and weight.shape[0] == 1 and x.dim() == 5 and x.is_contiguous()
            and x.shape[-1] % 4 == 0 and x.data_ptr() % 16 == 0
            and (weight.shape[2], s, x.shape[1]) in SHAPES
            and not torch.is_grad_enabled())


def geometry(k, s):
    """(dmin, NT, GW): the first input offset of an axis, the number of
    offsets, and the weights a group of the table (NT·s taps along w,
    padded to a multiple of 4)."""
    pad_a, pad_b = transforms.transpose_pads(k, s)
    dmin, dmax = -(pad_a // s), pad_b // s
    nt = dmax - dmin + 1
    return dmin, nt, -(-nt * s // 4) * 4


@functools.cache
def tap_table(k, s):
    """``[NT, s]`` int: the kernel tap of input offset dmin + dd for parity
    r, -1 where none meets it (the kernel's ``tap``)."""
    pad_a, _ = transforms.transpose_pads(k, s)
    dmin, nt, _ = geometry(k, s)
    m = s * (np.arange(nt)[:, None] + dmin) + pad_a - np.arange(s)[None]
    m = np.where((m >= 0) & (m < k), m, -1)
    m.flags.writeable = False
    return m


def pack_weights(weight, s):
    """The kernel's weight table of OIDHW ``weight`` ``[1, cin, k, k, k]``
    (the flax correlation kernel): ``[cin, NT, NT, s, s, GW]`` f32 with
    entry (c, dd, dh, rd, rh, dw·s + rw) = w[0, c, m(rd, dd), m(rh, dh),
    m(rw, dw)], zero where a tap is -1 and in the padding."""
    k, cin = weight.shape[2], weight.shape[1]
    _, nt, gw = geometry(k, s)
    t = tap_table(k, s)
    md = t.reshape(nt, 1, s, 1, 1, 1)
    mh = t.reshape(1, nt, 1, s, 1, 1)
    mw = t.reshape(1, 1, 1, 1, nt, s)
    valid = (md >= 0) & (mh >= 0) & (mw >= 0)
    flat = np.where(valid, (md * k + mh) * k + mw, 0)
    idx = torch.as_tensor(flat.reshape(-1), device=weight.device)
    mask = torch.as_tensor(valid.reshape(-1), device=weight.device)
    w = weight.detach().reshape(cin, k ** 3).float()
    table = torch.where(mask, w[:, idx], 0.0).reshape(cin, nt, nt, s, s,
                                                      nt * s)
    return torch.nn.functional.pad(table, (0, gw - nt * s)).contiguous()


def _outs(x, s, outs):
    return tuple(s * n for n in x.shape[2:]) if outs is None else \
        tuple(outs)


def conv_transpose_one_out_plain(x, table, bias, k, s, outs=None, shift=0):
    """:func:`conv_transpose_one_out` in plain PyTorch, summed in the
    kernel's order for every output: input channel, then the offsets along
    d, h, w (a fused multiply-add there, a product and a sum here)."""
    n, cin = x.shape[:2]
    dmin, nt, _ = geometry(k, s)
    outs = _outs(x, s, outs)
    ni = [-(-o // s) for o in outs]
    # xp[..., p] = x[..., p + dmin (+ shift along d)], zero outside x
    pads, sh = [], (shift, 0, 0)
    for ax in (2, 1, 0):  # F.pad lists the last dim first
        lo = -dmin - sh[ax]
        hi = ni[ax] + nt - 1 - lo - x.shape[2 + ax]
        pads += [lo, hi]
    xp = torch.nn.functional.pad(x.float(), pads)
    w = table[..., :nt * s].reshape(cin, nt, nt, s, s, nt, s)
    acc = x.new_zeros((n, s, s, s, *ni), dtype=torch.float32)
    for c in range(cin):
        for dd in range(nt):
            for dh in range(nt):
                for dw in range(nt):
                    xs = xp[:, c, dd:dd + ni[0], dh:dh + ni[1],
                            dw:dw + ni[2]]
                    acc += (w[c, dd, dh, :, :, dw].reshape(1, s, s, s, 1, 1,
                                                           1)
                            * xs[:, None, None, None])
    if bias is not None:
        acc += bias.float().reshape(1, 1, 1, 1, 1, 1, 1)
    # [n, rd, rh, rw, i_d, i_h, i_w] → [n, s·i_d + rd, s·i_h + rh, ...]
    y = acc.permute(0, 4, 1, 5, 2, 6, 3).reshape(n, 1, *(s * m for m in ni))
    return y[:, :, :outs[0], :outs[1], :outs[2]].contiguous()


_geometry_checked = False


def _check_geometry(lib):
    """The table layout must be the built kernel's (once a process)."""
    global _geometry_checked
    if _geometry_checked:
        return
    for k, s, cin in sorted(SHAPES):
        geo = (ctypes.c_int * 4)()
        if lib.pcc_conv_one_out_geometry(k, s, cin, geo) != 0:
            raise RuntimeError(f"conv_one_out: ({k}, {s}, {cin}) is not "
                               f"instantiated in the built kernel")
        dmin, nt, gw = geometry(k, s)
        want = (dmin, nt, gw, nt * nt * s * s * gw)
        if tuple(geo) != want:
            raise RuntimeError(f"conv_one_out: the kernel's table geometry "
                               f"for ({k}, {s}, {cin}) is {tuple(geo)}, "
                               f"the wrapper packs {want}")
    _geometry_checked = True


def conv_transpose_one_out(x, table, bias, k, s, outs=None, shift=0):
    """``lax.conv_transpose`` (``SAME``, stride ``s``, the un-flipped kernel
    packed by :func:`pack_weights` into ``table``) of NCDHW ``x`` into one
    channel, plus ``bias`` ``[1]`` (or None).

    :param outs: the output length of each spatial axis (default s × the
        input's).
    :param shift: planes ``x`` holds before the global input's first along
        D (a slab extended by its halo; see
        :func:`transforms.subpixel_conv_transpose`).
    :return: ``[N, 1, *outs]`` f32.
    """
    if x.device.type == "cpu":
        return conv_transpose_one_out_plain(x, table, bias, k, s, outs,
                                            shift)
    n, cin = x.shape[:2]
    if (k, s, cin) not in SHAPES:
        raise ValueError(f"conv_one_out: (k, s, cin) = ({k}, {s}, {cin}) is "
                         f"not one of {sorted(SHAPES)}")
    _, nt, gw = geometry(k, s)
    kernels.check_cuda_tensor(x, "x", torch.float32)
    kernels.check_cuda_tensor(table, "table", torch.float32,
                              (cin, nt, nt, s, s, gw))
    if bias is not None:
        kernels.check_cuda_tensor(bias, "bias", torch.float32, (1,))
    outs = _outs(x, s, outs)
    y = torch.empty((n, 1, *outs), dtype=torch.float32, device=x.device)
    if x.shape[-1] % 4 or any(t.data_ptr() % 16 for t in (x, table, y)):
        raise ValueError("conv_one_out: x's rows must be a multiple of 16 "
                         "bytes, and x, table and output 16-byte aligned")
    lib = kernels.load("conv_one_out")
    _check_geometry(lib)
    kernels.launch("conv_one_out", lib.pcc_conv_one_out, x.device,
                   x.data_ptr(), table.data_ptr(),
                   None if bias is None else bias.data_ptr(), y.data_ptr(),
                   k, s, cin, n, *x.shape[2:], *outs, shift)
    return y

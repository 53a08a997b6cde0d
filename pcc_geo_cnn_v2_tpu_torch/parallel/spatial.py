"""Spatial (sp) sharding: 3D convolutions over a depth-sharded voxel grid.

Port of ``pcc_geo_cnn_v2_tpu/parallel/spatial.py``. A block too large for
one device (a 256³ octree cell, say) is cut along depth (D) into one slab
a rank, and every conv of the analysis and hyper-analysis stacks, and
every transposed conv of the synthesis stack, runs on the rank's slab
extended by halo planes that its neighbours send: no rank ever holds a
whole activation.

JAX runs ``shard_map`` over a ``Mesh`` in one process; the port runs one
process a rank in a ``torch.distributed`` group, as its data-parallel
training does (``parallel/mesh.process_group``). A rank holds
``[N, C, D/world, H, W]`` (NCDHW, as the models run inside); every slab
has the same depth, rank r the r-th. The public entry points take and
return NDHWC, as the models' ``encode_syms`` / ``decode_y`` do.

Halo transport: on ``nccl`` one ``batch_isend_irecv`` of device tensors.
On ``gloo`` (the CPU, or ranks sharing a card, ``mesh.backend_for``) the
planes go through host buffers: gloo's send and receive hand the tensor's
raw pointer to its TCP transport, so a CUDA tensor is copied to the host
before and back after. The convs still run on the rank's device.

Numerics: every conv runs in f32 whatever the model's dtype (JAX's sp
path is f32), under ``codec.deterministic_convs`` (no TF32, one algorithm
a shape). At world 1 the halos are the zero planes of the global edges
and each conv is given the tensor the unsharded layer pads for itself, so
symbols and x_hat equal the model's own ``encode_syms`` / ``decode_y`` on
the same device bit for bit. At a larger world the convs see other shapes
and may sum in another order: symbols differ from the unsharded ones at
rounding boundaries only (JAX's bound: under 5e-4 of them). Encoder and
decoder both run :func:`decode_y_spatial` at the same world size, so
their x_hat are bit-equal.

The fused-tail kernels (``conv_backend="pallas"``) take whole volumes;
this path runs the module weights through cuDNN forward convs whatever
the model's backend (and a layer into one output channel through
``conv_one_out``, as the unsharded model does). Stacks with
``residual_mode="concat"`` are refused: JAX's sp path adds ``h + t``
whatever the mode, which is wrong there. So is a model that codes y in
slices (``num_slices > 1``): its symbols are the slice chain's, which this
path does not run.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs
from pcc_geo_cnn_v2_tpu_torch.coding.strings import StringFormat
from pcc_geo_cnn_v2_tpu_torch.models.codec_models import (
    _to_ncdhw,
    _to_ndhwc,
)
from pcc_geo_cnn_v2_tpu_torch.models.transforms import (
    AnalysisTransformV1,
    BlockStack,
    SynthesisTransformV1,
    same_pads,
    subpixel_conv_transpose,
    transpose_pads,
)
from pcc_geo_cnn_v2_tpu_torch.ops import conv_one_out

__all__ = ["conv3d_spatial_sharded", "conv3d_transpose_spatial_sharded",
           "encode_syms_spatial", "decode_y_spatial", "depth_slab",
           "gather_depth", "symbols_to_bytes", "bytes_to_symbols"]


def _host_staged(x, group):
    """Whether ``x`` must cross ``group`` through host buffers (a CUDA
    tensor over gloo)."""
    return x.device.type != "cpu" and dist.get_backend(group) != "nccl"


def _halo_exchange(x, halo_lo, halo_hi, group):
    """Extend the local slab with its neighbours' boundary planes.

    :param x: the rank's ``[N, C, D_local, H, W]`` slab.
    :return: ``[N, C, halo_lo + D_local + halo_hi, H, W]``: the last
        ``halo_lo`` planes of rank r - 1, the slab, the first ``halo_hi``
        planes of rank r + 1; zeros at the global edges.
    """
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    n, c, _, h, w = x.shape

    def planes(d, device=x.device):
        return torch.zeros((n, c, d, h, w), dtype=x.dtype, device=device)

    lo, hi = planes(halo_lo), planes(halo_hi)
    if world > 1 and (halo_lo or halo_hi):
        staged = _host_staged(x, group)
        buf = torch.device("cpu") if staged else x.device
        ops, recv = [], {}

        def peer(r):
            return dist.get_global_rank(group, r)

        def send(t, r):
            ops.append(dist.P2POp(dist.isend, t.contiguous().to(buf), peer(r),
                                  group))

        def receive(key, d, r):
            recv[key] = planes(d, buf)
            ops.append(dist.P2POp(dist.irecv, recv[key], peer(r), group))

        # one batched call: no order of sends and receives to deadlock on
        if halo_lo and rank > 0:
            receive("lo", halo_lo, rank - 1)
        if halo_lo and rank < world - 1:
            send(x[:, :, -halo_lo:], rank + 1)
        if halo_hi and rank < world - 1:
            receive("hi", halo_hi, rank + 1)
        if halo_hi and rank > 0:
            send(x[:, :, :halo_hi], rank - 1)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        lo = recv["lo"].to(x.device) if "lo" in recv else lo
        hi = recv["hi"].to(x.device) if "hi" in recv else hi
    return torch.cat([lo, x, hi], dim=2)


def _check_halos(halo_lo, halo_hi, d_local):
    if max(halo_lo, halo_hi) > d_local:
        raise ValueError(f"a halo of {max(halo_lo, halo_hi)} planes exceeds "
                         f"the slab's depth {d_local}")


def conv3d_spatial_sharded(x_local, weight, bias=None, *, stride=1, group):
    """``SAME``-padded 3D conv (flax ``nn.Conv``) with D sharded over
    ``group``: the rank's slab of the global result.

    The slab is extended by the global ``SAME`` pads of D in halo planes
    (zeros at the global edges), convolved VALID along D and with its own
    ``SAME`` pads along H and W.

    :param x_local: ``[N, Cin, D/world, H, W]``; D divisible by
        world·stride, and no halo deeper than a slab (ValueError).
    :param weight: ``[Cout, Cin, kd, kh, kw]``; ``bias`` ``[Cout]``.
    :return: ``[N, Cout, D/(world·stride), ⌈H/s⌉, ⌈W/s⌉]``.
    """
    world = dist.get_world_size(group)
    kd, kh, kw = weight.shape[2:]
    d_local, h, w = x_local.shape[2:]
    if d_local % stride:
        raise ValueError(f"a depth of {d_local * world} does not divide "
                         f"over {world} ranks at stride {stride}")
    halo_lo, halo_hi = same_pads(d_local * world, kd, stride)
    _check_halos(halo_lo, halo_hi, d_local)
    x = _halo_exchange(x_local, halo_lo, halo_hi, group)
    pads = (*same_pads(w, kw, stride), *same_pads(h, kh, stride), 0, 0)
    return F.conv3d(F.pad(x, pads), weight, bias, stride)


def conv3d_transpose_spatial_sharded(x_local, weight, bias=None, *,
                                     stride=1, group):
    """``SAME``-padded transposed 3D conv (flax ``nn.ConvTranspose``,
    ``lax.conv_transpose``) with D sharded over ``group``: the rank's slab
    of the global result.

    The input-space halos are JAX's: output j = s·i + r reads inputs
    i + o0 .. i + o0 + taps - 1 (``transforms._parity_taps``), from
    ⌊pad_a / s⌋ planes below the slab to (k - 2 - pad_a) // s + 1 above
    it. The rank's outputs are the global outputs s·D_local·rank ..
    s·D_local·(rank + 1) - 1, whose inputs are the slab's own rows i: on
    the extended slab they are read ``halo_lo`` planes further in, which
    is ``subpixel_conv_transpose``'s D shift (the port's sub-pixel form
    of the layer, never a conv of a dilated input). At stride 1 it is one
    forward conv over the halos, as in :class:`transforms.ConvTranspose`.
    A layer into one output channel takes ``conv_one_out`` where
    :class:`transforms.ConvTranspose` does (``conv_one_out.routes``), with
    the same D shift: at world 1 its result is the unsharded layer's.

    :param x_local: ``[N, Cin, D/world, H, W]``; no halo deeper than a
        slab (ValueError).
    :param weight: ``[Cout, Cin, kd, kh, kw]`` holding the flax
        (correlation) kernel; ``bias`` ``[Cout]``.
    :return: ``[N, Cout, s·D/world, s·H, s·W]``.
    """
    s = stride
    kd = weight.shape[2]
    d_local, h, w = x_local.shape[2:]
    pad_a, _ = transpose_pads(kd, s)
    halo_lo, halo_hi = pad_a // s, max((kd - 2 - pad_a) // s + 1, 0)
    _check_halos(halo_lo, halo_hi, d_local)
    x = _halo_exchange(x_local, halo_lo, halo_hi, group)
    outs = (s * d_local, s * h, s * w)
    if conv_one_out.routes(x, weight, s):
        return conv_one_out.conv_transpose_one_out(
            x, conv_one_out.pack_weights(weight, s), bias, kd, s, outs,
            shift=halo_lo)
    if s == 1:
        kh, kw = weight.shape[3:]
        pads = (*transpose_pads(kw, 1), *transpose_pads(kh, 1), 0, 0)
        return F.conv3d(F.pad(x, pads), weight, bias)
    y = subpixel_conv_transpose(x, weight, s, outs, shifts=(halo_lo, 0, 0))
    return y if bias is None else y + bias.view(1, -1, 1, 1, 1)


def _layer_args(layer):
    """A layer's weight and bias in f32."""
    return (layer.weight.float(),
            None if layer.bias is None else layer.bias.float())


def _check_model(model):
    if model.num_slices > 1:
        raise NotImplementedError(f"the sp path codes y in one slice, not "
                                  f"{model.num_slices}: no sliced models")


def _check_stack(t):
    if isinstance(t, BlockStack):
        if t.residual_mode != "add":
            raise NotImplementedError(
                f"the sp path runs 'add' residual stacks only, not "
                f"{t.residual_mode!r}")
    elif not isinstance(t, (AnalysisTransformV1, SynthesisTransformV1)):
        raise NotImplementedError(type(t).__name__)


@torch.no_grad()
def encode_syms_spatial(model, x_local, group):
    """``model.encode_syms`` of an oversized block, D sharded over
    ``group``: every conv of the analysis (and hyper-analysis) stack is a
    halo-exchanged :func:`conv3d_spatial_sharded`. V1 and
    (Progressive)V2 stacks with ``add`` residuals.

    :param model: a port ``CompressionModelV1`` / ``V2`` with its weights,
        on the device the slab runs on.
    :param x_local: the rank's ``[N, D/world, H, W, 1]`` occupancy slab;
        D divisible by world·16 (world·8 for V1).
    :return: the rank's slabs ``{y_sym[, z_sym]}`` int32, NDHWC: V1
        ``round(y - medians)``; V2 ``round(y)`` and ``round(z -
        medians)``. A sliced model raises NotImplementedError.
    """
    _check_model(model)
    has_z = hasattr(model, "hyper_analysis_t")
    _check_stack(model.analysis_t)
    factor = 16 if has_z else 8
    if x_local.shape[1] % factor:
        raise ValueError(f"a slab depth of {x_local.shape[1]} is not a "
                         f"multiple of {factor}")
    deterministic_convs()
    device = model.entropy_bottleneck.quantiles.device

    def conv(h, layer, act=True):
        h = conv3d_spatial_sharded(h, *_layer_args(layer), stride=layer.s,
                                   group=group)
        return F.relu(h) if act else h

    an = model.analysis_t
    y = _to_ncdhw(x_local.to(device, torch.float32))
    if isinstance(an, AnalysisTransformV1):
        y = conv(y, an.Conv_0)
        y = conv(y, an.Conv_1)
        y = conv(y, an.Conv_2, act=False)
    else:
        for i in range(an.n_blocks):
            block = getattr(an, f"{an.block_name}_{i}")
            h = conv(y, block.Conv_0)
            t = conv(h, block.Conv_1)
            y = h + conv(t, block.Conv_2)
        y = conv(y, an.Conv_0, act=False)
    if not has_z:
        return {"y_sym": model.entropy_bottleneck.quantize_symbols(
            _to_ndhwc(y))}
    ha = model.hyper_analysis_t
    z = conv(y, ha.Conv_0)
    z = conv(z, ha.Conv_1)
    z = conv(z, ha.Conv_2, act=False)
    return {"z_sym": model.entropy_bottleneck.quantize_symbols(_to_ndhwc(z)),
            "y_sym": model.conditional.quantize_symbols(_to_ndhwc(y))}


@torch.no_grad()
def decode_y_spatial(model, y_sym_local, group):
    """``model.decode_y`` (V1: ``decode``) of an oversized block, D sharded
    over ``group``: every transposed conv of the synthesis stack is a
    halo-exchanged :func:`conv3d_transpose_spatial_sharded`.

    Bit-exactness contract: encoder and decoder both run this function at
    the same world size on the same symbols, so their x_hat (and every
    threshold mask cut from it) are bit-equal — the block codec's
    decoder-canonical rule, on the sp axis.

    :param y_sym_local: the rank's ``[N, D/(8·world), H/8, W/8, C]`` int32
        symbols.
    :return: the rank's x_hat ``[N, D/world, H, W, 1]`` f32 in [0, 1].
    """
    _check_model(model)
    _check_stack(model.synthesis_t)
    deterministic_convs()
    device = model.entropy_bottleneck.quantiles.device
    prior = getattr(model, "conditional", model.entropy_bottleneck)
    y_hat = prior.dequantize_symbols(y_sym_local.to(device))

    def deconv(h, layer):
        return F.relu(conv3d_transpose_spatial_sharded(
            h, *_layer_args(layer), stride=layer.s, group=group))

    sy = model.synthesis_t
    x = _to_ncdhw(y_hat)
    if isinstance(sy, SynthesisTransformV1):
        x = deconv(x, sy.ConvTranspose_0)
        x = deconv(x, sy.ConvTranspose_1)
        x = deconv(x, sy.ConvTranspose_2)
    else:
        for i in range(sy.n_blocks):
            block = getattr(sy, f"{sy.block_name}_{i}")
            h = deconv(x, block.ConvTranspose_0)
            t = deconv(h, block.ConvTranspose_1)
            x = h + deconv(t, block.ConvTranspose_2)
        x = deconv(x, sy.ConvTranspose_0)
    return torch.clamp(_to_ndhwc(x).float(), 0.0, 1.0)


def depth_slab(x, group, axis=1):
    """The rank's slab of a whole tensor: the rank-th of ``world`` equal
    parts along ``axis`` (D of NDHWC by default). A depth that the world
    size does not divide raises."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    d = x.shape[axis]
    if d % world:
        raise ValueError(f"a depth of {d} does not divide over {world} "
                         f"ranks")
    return x.narrow(axis, rank * (d // world), d // world)


def gather_depth(x_local, group, axis=1):
    """Every rank's slab, concatenated along ``axis``, on every rank (on
    ``x_local``'s device): the whole symbols or x_hat of a block."""
    world = dist.get_world_size(group)
    if world == 1:
        return x_local
    staged = _host_staged(x_local, group)
    t = x_local.contiguous()
    t = t.cpu() if staged else t
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=axis).to(x_local.device)


def _y_rows(model, fmt, z_sym, n):
    """The host y rows of ``n`` whole blocks: the decoder's, from z
    unsharded (z is the block over 16), as JAX's sp round trip does."""
    deterministic_convs()
    hyper = model.decode_hyper(z_sym)
    return fmt.host_rows(model.slice_params(hyper, [], 0)[1], n)


def symbols_to_bytes(model, syms):
    """A block's whole symbols (:func:`gather_depth`) → its rANS strings
    ``(y[, z])``, one block a row, in the block codec's format
    (``coding/strings.py``). A sliced model raises NotImplementedError."""
    _check_model(model)
    out = {k: v.cpu().numpy() for k, v in syms.items()}
    fmt = StringFormat(model, out["y_sym"].shape[1:])
    out["y_idx"] = _y_rows(model, fmt, syms.get("z_sym"), len(out["y_sym"]))
    return fmt.encode(out)


def bytes_to_symbols(model, strings, y_shape):
    """Inverse of :func:`symbols_to_bytes` from the strings alone: the
    blocks' whole ``{y_sym[, z_sym]}`` int32 on the model's device.

    :param y_shape: one block's y ``(D/8, H/8, W/8, C)``.
    """
    _check_model(model)
    fmt = StringFormat(model, y_shape)
    device = model.entropy_bottleneck.quantiles.device
    z = torch.as_tensor(fmt.decode_z(strings), device=device)
    rows = _y_rows(model, fmt, z, len(strings))
    y = torch.as_tensor(fmt.y_decoder(strings).decode(rows), device=device)
    return {k: v for k, v in (("y_sym", y), ("z_sym", z)) if k in fmt.keys}

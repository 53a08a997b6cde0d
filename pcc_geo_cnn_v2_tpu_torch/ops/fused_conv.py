"""Fused residual tails of the V2-family transform stacks (kernels K4a/K4b).

Counterpart of ``pcc_geo_cnn_v2_tpu/ops/pallas_conv.py``. Every analysis /
synthesis block ends in a stride-1 tail

    out = relu(conv2(relu(conv1(x) + b1)) + b2) [+ x]

of two 3×3×3 SAME convolutions C → C (a stride-1 SAME transposed conv is
the same correlation, so one function serves both block kinds). The tail is
one kernel launch that keeps the intermediate on chip:

- :func:`fused_residual_tail` — K4a, whole volumes (``csrc/fused_tail.cu``);
- :func:`fused_residual_tail_slab` — K4b, the same function over D-slabs
  (``csrc/fused_tail_slab.cu``) for the volumes past :data:`MAX_FUSED_ROWS`;
- :func:`tail_plan` — the launch geometry of both kernels: a block owns an
  H×W tile of one batch element and rolls a window of planes along a depth
  range; the plan picks K4a's depth range so that the grid fills the card;
- :func:`fused_block_stack_apply` — a whole ``BlockStack`` with the strided
  convs through the port's ``Conv`` / ``ConvTranspose`` modules (cuDNN) and
  the tails through the kernels: the ``conv_backend="pallas"`` inference
  path (the name is the JAX package's for this backend).

Data is channels-last (``[N, S, S, S, C]``, the JAX package's layout) from
the stack's input to its output; the strided convs see it as NCDHW views
in ``torch.channels_last_3d`` strides, so nothing is copied between layers
as long as cuDNN answers in the layout it was asked in.

Types, as in the TPU kernel: x and the weights are cast to ``dtype`` (f32
or bf16), the 27·C products of a voxel are summed in f32, the bias is added
in f32, the intermediate and the result are rounded to ``dtype``, and the
residual adds the rounded x in f32. The TPU layout devices (128-lane
folding, ``kron(I_G, W)`` block-diagonal taps, rolls) have no counterpart:
the weights are packed tap-major ``[27, cin, cout]`` and nothing else. A
folded ``[N, S³·C/128, 128]`` input is the same memory as ``[N, S, S, S,
C]`` and is accepted and returned as given.

CUDA tensors launch the kernels; CPU tensors take the plain versions
(:func:`fused_residual_tail_plain`, :func:`fused_residual_tail_slab_plain`),
which nothing on a CUDA path calls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from pcc_geo_cnn_v2_tpu_torch.ops import kernels

__all__ = ["fused_residual_tail", "fused_residual_tail_plain",
           "fused_residual_tail_slab", "fused_residual_tail_slab_plain",
           "fused_block_stack_apply", "pack_tail_weights", "packed_tails",
           "MAX_FUSED_ROWS", "KERNEL_CHANNELS", "TILE_DEPTH", "TILES",
           "tail_plan"]

LANES = 128
# The JAX package's dispatch rule, kept so that each kernel runs at the
# shapes its TPU twin runs at: volumes of more than this many 128-element
# rows (S³·C / 128) go to the slab kernel.
MAX_FUSED_ROWS = 8192
# what the CUDA kernels are compiled for: channel counts, the unit of depth
# ``slab`` must be a multiple of, and per (dtype, channels) the H×W tile of
# a block and the blocks an SM holds by shared memory (``Geom`` / ``Tile``
# of csrc/fused_tail.cuh; checked against the built library at first use)
KERNEL_CHANNELS = (16, 32, 64)
TILE_DEPTH = 4
_DTYPES = (torch.float32, torch.bfloat16)
TILES = {
    (torch.bfloat16, 16): (8, 16, 2),
    (torch.bfloat16, 32): (8, 16, 2),
    (torch.bfloat16, 64): (8, 16, 1),
    (torch.float32, 16): (16, 16, 1),
    (torch.float32, 32): (8, 16, 1),
    (torch.float32, 64): (8, 8, 1),
}
H100_SMS = 132


def tail_plan(spatial, channels, n, dtype, *, sms=H100_SMS, depth_chunk=None):
    """Launch geometry of K4a / K4b for ``n`` volumes of ``spatial``³ ×
    ``channels``: grid ``(tiles · depth_ranges, n)``, block ``b`` of a batch
    element owning H×W tile ``b % tiles`` and output planes
    ``[k · depth_chunk, min((k + 1) · depth_chunk, spatial))``, ``k = b //
    tiles``.

    A depth range of ``d`` planes computes ``d + 2`` intermediate planes
    (its two seams are recomputed), so long ranges cost least per voxel but
    give few blocks. With ``depth_chunk=None`` (K4a) the plan takes the
    range that minimises the rounds ``ceil(blocks / (sms · blocks an SM
    holds))`` times the per-block work, the longer range on ties (on the
    H100 the fastest of the ranges 1, 2, 4, ... 32 at every stage shape,
    ``tools/torch_bench_fused_tail.py --chunks``); K4b passes its
    ``slab``. Every choice gives the same bits.
    """
    return dict(_tail_plan(spatial, channels, n, dtype, sms, depth_chunk))


@functools.lru_cache(maxsize=256)
def _tail_plan(spatial, channels, n, dtype, sms, depth_chunk):
    if (dtype, channels) not in TILES:
        raise ValueError(f"no kernel for dtype {dtype}, channels {channels}")
    th, tw, per_sm = TILES[(dtype, channels)]
    nth, ntw = -(-spatial // th), -(-spatial // tw)
    tiles = nth * ntw
    mid, outv = (th + 2) * (tw + 2), th * tw

    def rounds_cost(chunk):
        blocks = tiles * -(-spatial // chunk) * n
        return -(-blocks // (sms * per_sm)) * ((chunk + 2) * mid
                                               + chunk * outv)

    if depth_chunk is None:
        depth_chunk = min(range(1, spatial + 1),
                          key=lambda c: (rounds_cost(c), -c))
    if not 0 < depth_chunk <= spatial:
        raise ValueError(f"depth_chunk {depth_chunk} outside 1..{spatial}")
    ranges = -(-spatial // depth_chunk)
    return dict(tile_h=th, tile_w=tw, tiles_h=nth, tiles_w=ntw,
                depth_chunk=depth_chunk, depth_ranges=ranges,
                grid=(tiles * ranges, n), blocks_per_sm=per_sm)


def pack_tail_weights(kernel, dtype=torch.bfloat16, *, oidhw=False):
    """Conv kernel → the kernels' tap-major ``[27, cin, cout]`` in ``dtype``.

    :param kernel: flax layout ``[3, 3, 3, cin, cout]`` (numpy or tensor),
        or with ``oidhw`` the port's module parameter ``[cout, cin, 3, 3,
        3]``. Tap order is (dz, dy, dx) row-major over {-1, 0, 1}³. Serves
        stride-1 transposed-conv tails unchanged (same correlation).
    """
    k = kernel if torch.is_tensor(kernel) else torch.from_numpy(
        np.array(kernel))
    if oidhw:
        k = k.permute(2, 3, 4, 1, 0)
    if k.ndim != 5 or tuple(k.shape[:3]) != (3, 3, 3):
        raise ValueError(f"expected a 3x3x3 conv kernel, got {tuple(k.shape)}")
    return k.reshape(27, k.shape[3], k.shape[4]).to(dtype).contiguous()


def _operands(x, w1, b1, w2, b2, spatial, channels, dtype):
    """(x as [N, S, S, S, C] in dtype, packed w1, b1 f32, packed w2, b2)."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype}")
    xv = x.reshape(x.shape[0], spatial, spatial, spatial, channels)
    xv = xv.to(dtype).contiguous()

    def weight(w):
        if not torch.is_tensor(w) or w.ndim == 5:
            w = pack_tail_weights(w, dtype)
        if tuple(w.shape) != (27, channels, channels):
            raise ValueError(f"expected weights [27, {channels}, {channels}]"
                             f", got {tuple(w.shape)}")
        return w.to(device=x.device, dtype=dtype).contiguous()

    def bias(b):
        b = torch.as_tensor(np.asarray(b) if not torch.is_tensor(b) else b)
        return b.to(device=x.device, dtype=torch.float32).contiguous()

    return xv, weight(w1), bias(b1), weight(w2), bias(b2)


def _conv_same(x, wp):
    """f32 3×3×3 SAME correlation of NCDHW ``x`` with packed weights."""
    cin, cout = wp.shape[1:]
    w = wp.float().reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
    return F.conv3d(F.pad(x, (1,) * 6), w)


def _tail_ncdhw(xf, w1, b1, w2, b2, dtype, t_valid=None):
    """relu(conv2(relu(conv1(x) + b1)) + b2) on f32 NCDHW values of
    ``dtype``-rounded operands, the intermediate rounded to ``dtype`` and
    zeroed where ``t_valid`` (over D) is false."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        t = F.relu(_conv_same(xf, w1) + b1.view(1, -1, 1, 1, 1))
        if t_valid is not None:
            t = torch.where(t_valid.view(1, 1, -1, 1, 1), t, 0.0)
        t = t.to(dtype).float()
        return F.relu(_conv_same(t, w2) + b2.view(1, -1, 1, 1, 1))


def fused_residual_tail_plain(x, w1, b1, w2, b2, *, spatial, channels,
                              residual=True, dtype=torch.bfloat16):
    """Plain PyTorch version of K4a: ``dtype`` operands as f32 values, f32
    convolutions, rounded where the kernel rounds."""
    xv, w1, b1, w2, b2 = _operands(x, w1, b1, w2, b2, spatial, channels,
                                   dtype)
    xf = xv.float().permute(0, 4, 1, 2, 3)
    y = _tail_ncdhw(xf, w1, b1, w2, b2, dtype)
    if residual:
        y = y + xf
    return y.permute(0, 2, 3, 4, 1).to(dtype).contiguous().reshape(x.shape)


def fused_residual_tail_slab_plain(x, w1, b1, w2, b2, *, spatial, channels,
                                   slab=8, residual=True,
                                   dtype=torch.bfloat16):
    """Plain PyTorch version of K4b: slab by slab over D with a 2-slice
    halo read by predicate (slices outside the volume are zero, and so is
    the intermediate there), each slab's interior written once."""
    if spatial % slab:
        raise ValueError(f"spatial {spatial} is not a multiple of slab "
                         f"{slab}")
    xv, w1, b1, w2, b2 = _operands(x, w1, b1, w2, b2, spatial, channels,
                                   dtype)
    xf = xv.float().permute(0, 4, 1, 2, 3)
    out = torch.empty_like(xf)
    for lo in range(0, spatial, slab):
        # D slices lo-2 .. lo+slab+2, zero where outside the volume
        a, b = max(lo - 2, 0), min(lo + slab + 2, spatial)
        xs = F.pad(xf[:, :, a:b], (0, 0, 0, 0, a - (lo - 2),
                                   lo + slab + 2 - b))
        g_d = torch.arange(lo - 2, lo + slab + 2, device=x.device)
        t_valid = (g_d >= 0) & (g_d < spatial)
        y = _tail_ncdhw(xs, w1, b1, w2, b2, dtype, t_valid)[:, :, 2:slab + 2]
        if residual:
            y = y + xs[:, :, 2:slab + 2]
        out[:, :, lo:lo + slab] = y
    return out.permute(0, 2, 3, 4, 1).to(dtype).contiguous().reshape(x.shape)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


_geometry_checked = False


def _check_geometry():
    """:data:`TILES` must be what the built kernels use (once a process)."""
    global _geometry_checked
    if _geometry_checked:
        return
    import ctypes

    lib = kernels.load("fused_tail")
    for (dtype, channels), want in TILES.items():
        geo = (ctypes.c_int * 3)()
        err = lib.pcc_fused_tail_geometry(
            channels, int(dtype == torch.bfloat16), geo)
        if err or tuple(geo) != want:
            raise RuntimeError(
                f"fused_tail: TILES[{dtype}, {channels}] = {want} but the "
                f"kernel reports {tuple(geo)} (error {err})")
    _geometry_checked = True


def _launch(name, x, w1, b1, w2, b2, spatial, channels, residual, dtype,
            slab=None):
    xv, w1, b1, w2, b2 = _operands(x, w1, b1, w2, b2, spatial, channels,
                                   dtype)
    if channels not in KERNEL_CHANNELS:
        raise ValueError(f"{name}: the kernel is built for channels in "
                         f"{KERNEL_CHANNELS}, got {channels}")
    kernels.check_cuda_tensor(xv, "x", dtype)
    for nm, t in (("w1", w1), ("w2", w2)):
        kernels.check_cuda_tensor(t, nm, dtype)
    for nm, t in (("b1", b1), ("b2", b2)):
        kernels.check_cuda_tensor(t, nm, torch.float32, (channels,))
    out = torch.empty_like(xv)
    if any(t.data_ptr() % 16 for t in (xv, w1, w2, out)):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")
    lib = kernels.load(name)
    _check_geometry()
    if slab is None:  # K4a: the depth range of a CTA from the plan
        entry, depth = lib.pcc_fused_tail, tail_plan(
            spatial, channels, xv.shape[0], dtype,
            sms=_sm_count(xv.device))["depth_chunk"]
    else:
        entry, depth = lib.pcc_fused_tail_slab, slab
    kernels.launch(name, entry, xv.device, xv.data_ptr(), w1.data_ptr(),
                   b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                   xv.shape[0], spatial, channels, depth, int(residual),
                   int(dtype == torch.bfloat16))
    return out.reshape(x.shape)


def fused_residual_tail(x, w1, b1, w2, b2, *, spatial, channels,
                        residual=True, dtype=torch.bfloat16):
    """K4a wrapper: relu(conv2(relu(conv1(x)))) [+ x] on cubes, one launch.

    :param x: ``[N, S, S, S, C]`` (S = ``spatial``, C = ``channels``) or
        folded ``[N, S³·C/128, 128]``; returned in the layout given, in
        ``dtype``.
    :param w1, w2: flax kernels ``[3, 3, 3, C, C]`` (packed per call) or
        weights already packed by :func:`pack_tail_weights`; b1, b2 ``[C]``.
    """
    if x.device.type == "cpu":
        return fused_residual_tail_plain(
            x, w1, b1, w2, b2, spatial=spatial, channels=channels,
            residual=residual, dtype=dtype)
    return _launch("fused_tail", x, w1, b1, w2, b2, spatial, channels,
                   residual, dtype)


def fused_residual_tail_slab(x, w1, b1, w2, b2, *, spatial, channels, slab=8,
                             residual=True, dtype=torch.bfloat16):
    """K4b wrapper: the same function over D-slabs of ``slab`` slices, for
    volumes past :data:`MAX_FUSED_ROWS`. Takes the unpadded volume."""
    if x.device.type == "cpu":
        return fused_residual_tail_slab_plain(
            x, w1, b1, w2, b2, spatial=spatial, channels=channels, slab=slab,
            residual=residual, dtype=dtype)
    if spatial % slab or slab % TILE_DEPTH:
        raise ValueError(f"fused_tail_slab: spatial {spatial} must be a "
                         f"multiple of slab {slab}, and slab of "
                         f"{TILE_DEPTH}")
    return _launch("fused_tail_slab", x, w1, b1, w2, b2, spatial, channels,
                   residual, dtype, slab=slab)


def _tail(x, w1, b1, w2, b2, spatial, channels, dtype):
    """The JAX package's dispatch: whole-volume kernel up to
    :data:`MAX_FUSED_ROWS` folded rows, slab kernel above."""
    fn = (fused_residual_tail
          if spatial ** 3 * channels // LANES <= MAX_FUSED_ROWS
          else fused_residual_tail_slab)
    return fn(x, w1, b1, w2, b2, spatial=spatial, channels=channels,
              dtype=dtype)


def _tail_convs(stack, i):
    blk = getattr(stack, f"{stack.block_name}_{i}")
    if stack.synthesis:
        return blk.ConvTranspose_0, blk.ConvTranspose_1, blk.ConvTranspose_2
    return blk.Conv_0, blk.Conv_1, blk.Conv_2


def packed_tails(stack, dtype):
    """Per block of a ``BlockStack``: (w1, b1, w2, b2) packed for the
    kernels in ``dtype``, on the parameters' device.

    Packed once and kept on the stack; packed anew when a tail parameter
    was written (``load_state_dict``) or moved since — the codec calls this
    from ``set_params`` so that no encode or decode call pays for it.
    """
    convs = [m for i in range(stack.n_blocks)
             for m in _tail_convs(stack, i)[1:]]
    key = tuple((p.data_ptr(), p._version, str(p.device))
                for m in convs for p in (m.weight, m.bias))
    cache = stack.__dict__.setdefault("_packed_tails", {})
    hit = cache.get(dtype)
    if hit is None or hit[0] != key:
        packed = []
        for a, b in zip(convs[::2], convs[1::2]):
            packed.append(tuple(
                t for m in (a, b) for t in (
                    pack_tail_weights(m.weight.detach(), dtype, oidhw=True),
                    m.bias.detach().float().contiguous())))
        cache[dtype] = hit = (key, packed)
    return hit[1]


def fused_block_stack_apply(stack, x, *, dtype=torch.bfloat16):
    """Apply a V2-family ``BlockStack`` to channels-last ``x`` ``[N, S, S,
    S, cin]``: strided (transposed) convs through the stack's own modules,
    computing in ``dtype`` with the bias added in ``dtype``; residual tails
    through K4a / K4b. Same values as the module up to summation order.

    :return: ``[N, S', S', S', cout]`` in ``dtype`` (channels-last).
    """
    tails = packed_tails(stack, dtype)
    spatial = x.shape[1]

    def layer(conv, h):
        y = conv(h.permute(0, 4, 1, 2, 3), dtype=dtype)
        return y.permute(0, 2, 3, 4, 1)

    for i in range(stack.n_blocks):
        strided = _tail_convs(stack, i)[0]
        h = F.relu(layer(strided, x))
        spatial = spatial * 2 if stack.synthesis else spatial // 2
        x = _tail(h, *tails[i], spatial, strided.weight.shape[0], dtype)
    if stack.synthesis:
        return F.relu(layer(stack.ConvTranspose_0, x))
    return layer(stack.Conv_0, x)

"""The port's fused residual tails (K4a / K4b) against the JAX package's.

The same numpy inputs go through the JAX functions of
``pcc_geo_cnn_v2_tpu/ops/pallas_conv.py`` (Pallas kernels in
``interpret=True`` mode, as ``tests/test_pallas_conv.py`` runs them) and
through the port's ``ops/fused_conv.py`` on CPU tensors, where the wrappers
take the plain PyTorch versions. The CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``.

Tolerances: f32 results agree to rtol 1e-4 / atol 1e-5 (both sides sum the
27·C products of a voxel in f32, in different orders). In bf16 both sides
round at the same points (operands, intermediate, result), so most elements
are equal; a sum that lands within f32 noise of a bf16 rounding boundary
rounds the other way, and such a flip of the intermediate moves the outputs
it feeds. Distances are counted in bf16 steps: the spacing of bf16 numbers
at the larger of the two values, or at 1/16 of the tensor's largest value
for elements smaller than that (they are sums that cancel, and their error
is set by the size of the terms, not of the result).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
from pcc_geo_cnn_v2_tpu.models.transforms import TRANSFORMS as JAX_TRANSFORMS
from pcc_geo_cnn_v2_tpu.ops import pallas_conv as jpc
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.models.transforms import TRANSFORMS
from pcc_geo_cnn_v2_tpu_torch.ops import fused_conv as fc
from pcc_geo_cnn_v2_tpu_torch.weights import (
    params_from_jax,
    tail_weights_from_jax,
)

F32 = dict(rtol=1e-4, atol=1e-5)


def _operands(spatial, channels, n=2, seed=0, w_std=0.1):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((n,) + (spatial,) * 3 + (channels,))
         ).astype(np.float32)
    w1, w2 = (
        (w_std * rng.standard_normal((3, 3, 3, channels, channels))
         ).astype(np.float32) for _ in range(2))
    b1, b2 = ((0.3 * rng.standard_normal(channels)).astype(np.float32)
              for _ in range(2))
    return x, w1, b1, w2, b2


def _f32(t):
    return t.float().numpy()


def bf16_steps(got, want):
    """Elementwise distance in bf16 steps (see the module docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                     np.abs(want).max() / 16)
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("spatial,channels", [(8, 16), (8, 32), (8, 64),
                                              (16, 16)])
def test_tail_f32_matches_jax(spatial, channels):
    x, w1, b1, w2, b2 = _operands(spatial, channels)
    want = jpc.fused_residual_tail(
        jnp.asarray(x), w1, b1, w2, b2, spatial=spatial, channels=channels,
        interpret=True, dtype=jnp.float32)
    got = fc.fused_residual_tail(
        torch.from_numpy(x), w1, b1, w2, b2, spatial=spatial,
        channels=channels, dtype=torch.float32)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_tail_no_residual_and_folded_io():
    spatial, channels = 8, 16
    x, w1, b1, w2, b2 = _operands(spatial, channels, n=3)
    rows, _ = jpc.fold_shape(spatial, channels)
    xf = x.reshape(3, rows, 128)
    want = jpc.fused_residual_tail(
        jnp.asarray(xf), w1, b1, w2, b2, spatial=spatial, channels=channels,
        residual=False, interpret=True, dtype=jnp.float32)
    got = fc.fused_residual_tail(
        torch.from_numpy(xf), w1, b1, w2, b2, spatial=spatial,
        channels=channels, residual=False, dtype=torch.float32)
    assert got.shape == (3, rows, 128)  # returned as given
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    unfolded = fc.fused_residual_tail(
        torch.from_numpy(x), w1, b1, w2, b2, spatial=spatial,
        channels=channels, residual=False, dtype=torch.float32)
    assert torch.equal(unfolded.reshape(3, rows, 128), got)
    with_res = fc.fused_residual_tail(
        torch.from_numpy(x), w1, b1, w2, b2, spatial=spatial,
        channels=channels, dtype=torch.float32)
    np.testing.assert_allclose(with_res.numpy(), unfolded.numpy() + x,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spatial,channels", [(8, 16), (8, 32), (8, 64)])
def test_tail_bf16_matches_jax(spatial, channels):
    x, w1, b1, w2, b2 = _operands(spatial, channels)
    want = jpc.fused_residual_tail(
        jnp.asarray(x), w1, b1, w2, b2, spatial=spatial, channels=channels,
        interpret=True, dtype=jnp.bfloat16)
    got = fc.fused_residual_tail(
        torch.from_numpy(x), w1, b1, w2, b2, spatial=spatial,
        channels=channels, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    g, w = _f32(got), np.asarray(want.astype(jnp.float32))
    steps = bf16_steps(g, w)
    print(f"bf16 tail {spatial}^3 x {channels}: max {steps.max():.2f} steps,"
          f" {100 * (g == w).mean():.3f}% equal")
    assert steps.max() <= 2.0
    assert (g == w).mean() >= 0.99


def test_plain_version_rounds_where_the_kernel_rounds():
    """bf16: operands rounded on entry, f32 sums, intermediate rounded,
    f32 residual add, result rounded — written out with f64 sums."""
    spatial, channels = 4, 16
    x, w1, b1, w2, b2 = _operands(spatial, channels, n=1)

    def rnd(a):
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16() \
            .float().numpy()

    def conv(v, w, b):
        vp = np.pad(v.astype(np.float64), ((1, 1),) * 3 + ((0, 0),))
        out = np.zeros(v.shape[:3] + (w.shape[-1],))
        for dz in range(3):
            for dy in range(3):
                for dx in range(3):
                    out += vp[dz:dz + spatial, dy:dy + spatial,
                              dx:dx + spatial] @ w[dz, dy, dx].astype(
                                  np.float64)
        return np.maximum(out + b, 0.0)

    xr = rnd(x[0])
    t = rnd(conv(xr, rnd(w1), b1))
    want = rnd(conv(t, rnd(w2), b2) + xr)
    got = _f32(fc.fused_residual_tail_plain(
        torch.from_numpy(x), w1, b1, w2, b2, spatial=spatial,
        channels=channels, dtype=torch.bfloat16))[0]
    assert bf16_steps(got, want).max() <= 1.0
    assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("spatial,channels,slab", [(16, 16, 4), (16, 16, 8)])
def test_slab_matches_whole_volume_and_jax(spatial, channels, slab):
    x, w1, b1, w2, b2 = _operands(spatial, channels, n=1)
    kw = dict(spatial=spatial, channels=channels, dtype=torch.float32)
    whole = fc.fused_residual_tail_plain(torch.from_numpy(x), w1, b1, w2, b2,
                                         **kw)
    got = fc.fused_residual_tail_slab(torch.from_numpy(x), w1, b1, w2, b2,
                                      slab=slab, **kw)
    assert torch.equal(got, whole)  # seams included, bit for bit
    want = jpc.fused_residual_tail_slab(
        jnp.asarray(x), w1, b1, w2, b2, spatial=spatial, channels=channels,
        slab=slab, interpret=True, dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("slab", [4, 8])
def test_slab_zero_input_is_pure_border_effect(slab):
    """All-zero input, non-zero biases: the intermediate is relu(b1) inside
    the volume and ZERO outside it, so the output is constant per channel in
    the interior and differs at faces, edges and corners — at the volume's
    D faces only if the slab variant zeroes the intermediate of its halo
    slices that lie outside the volume."""
    spatial, channels = 16, 16
    _, w1, _, w2, _ = _operands(spatial, channels, n=1)
    rng = np.random.default_rng(5)
    b1 = (0.2 + rng.random(channels)).astype(np.float32)
    b2 = (0.2 + rng.random(channels)).astype(np.float32)
    x = np.zeros((1,) + (spatial,) * 3 + (channels,), np.float32)
    kw = dict(spatial=spatial, channels=channels, dtype=torch.float32)
    got = fc.fused_residual_tail_slab(torch.from_numpy(x), w1, b1, w2, b2,
                                      slab=slab, **kw)
    whole = fc.fused_residual_tail(torch.from_numpy(x), w1, b1, w2, b2, **kw)
    assert torch.equal(got, whole)
    want = jpc.fused_residual_tail_slab(
        jnp.asarray(x), w1, b1, w2, b2, spatial=spatial, channels=channels,
        slab=slab, interpret=True, dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    g = got.numpy()[0]
    inner = g[2:-2, 2:-2, 2:-2]
    np.testing.assert_allclose(inner, np.broadcast_to(inner[0, 0, 0],
                                                      inner.shape),
                               rtol=1e-5, atol=1e-6)
    # a D face, an edge and a corner differ from the interior, and the two
    # D faces mirror nothing (the taps are not symmetric) but both are
    # border values
    mid = spatial // 2
    for pos in ((0, mid, mid), (spatial - 1, mid, mid), (0, 0, mid),
                (0, 0, 0), (spatial - 1, spatial - 1, spatial - 1)):
        assert np.abs(g[pos] - inner[0, 0, 0]).max() > 1e-3, pos
    # seams are interior: the slices on both sides of every seam are equal
    for seam in range(slab, spatial, slab):
        if 2 <= seam - 1 and seam < spatial - 2:
            np.testing.assert_allclose(g[seam - 1, 2:-2, 2:-2],
                                       g[seam, 2:-2, 2:-2], rtol=1e-5,
                                       atol=1e-6)


def test_pack_tail_weights_tap_order_and_layouts():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((3, 3, 3, 5, 7)).astype(np.float32)
    p = fc.pack_tail_weights(k, torch.float32)
    assert p.shape == (27, 5, 7) and p.is_contiguous()
    t = 0
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                np.testing.assert_array_equal(p[t].numpy(), k[dz, dy, dx])
                t += 1
    oidhw = torch.from_numpy(k.transpose(4, 3, 0, 1, 2).copy())
    assert torch.equal(fc.pack_tail_weights(oidhw, torch.float32, oidhw=True),
                       p)
    pb = fc.pack_tail_weights(k)  # the default type is bf16, as in JAX
    assert pb.dtype == torch.bfloat16
    assert torch.equal(pb, p.bfloat16())
    # no lane folding, no block-diagonal copies: 27 * cin * cout numbers
    assert pb.numel() == k.size
    with pytest.raises(ValueError, match="3x3x3"):
        fc.pack_tail_weights(k[:2])


# c3p's six stage shapes, and the two that c3 adds
@pytest.mark.parametrize("spatial,channels,slab_kernel", [
    (32, 16, False), (16, 32, False), (8, 64, False), (16, 64, False),
    (32, 32, False), (64, 16, True), (32, 64, True), (64, 32, True)])
def test_tail_dispatch_rule_is_the_jax_one(monkeypatch, spatial, channels,
                                           slab_kernel):
    calls = []
    monkeypatch.setattr(fc, "fused_residual_tail",
                        lambda *a, **k: calls.append(("whole", k)))
    monkeypatch.setattr(fc, "fused_residual_tail_slab",
                        lambda *a, **k: calls.append(("slab", k)))
    fc._tail(None, None, None, None, None, spatial, channels, torch.float32)
    rows, _ = jpc.fold_shape(spatial, channels)
    assert slab_kernel == (rows > jpc.MAX_FUSED_ROWS)
    assert fc.MAX_FUSED_ROWS == jpc.MAX_FUSED_ROWS
    assert calls == [("slab" if slab_kernel else "whole",
                      dict(spatial=spatial, channels=channels,
                           dtype=torch.float32))]
    assert spatial % 8 == 0 and 8 % fc.TILE_DEPTH == 0  # default slab fits
    assert channels in fc.KERNEL_CHANNELS


def _stack_pair(name, filters, in_shape, seed=0):
    jt = JAX_TRANSFORMS[name](filters)
    rng = np.random.default_rng(seed)
    if in_shape[-1] == 1:
        x = (rng.random(in_shape) < 0.08).astype(np.float32)
    else:
        x = rng.standard_normal(in_shape).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jt.init(jax.random.PRNGKey(seed), x))["params"]
    tt = TRANSFORMS[name](filters)
    tt.load_state_dict(params_from_jax(params))
    return jt, params, tt, x


STACKS = [("AnalysisTransformProgressiveV2", (2, 16, 16, 16, 1)),
          ("AnalysisTransformV2", (2, 16, 16, 16, 1)),
          ("SynthesisTransformProgressiveV2", (2, 2, 2, 2, 64)),
          ("SynthesisTransformV2", (2, 2, 2, 2, 64))]


@pytest.mark.parametrize("name,in_shape", STACKS)
def test_block_stack_apply_matches_jax(name, in_shape):
    jt, params, tt, x = _stack_pair(name, 64, in_shape)
    want = jpc.fused_block_stack_apply(
        params, jnp.asarray(x), filters=64, widths=jt.widths,
        synthesis=jt.synthesis, dtype=jnp.float32, interpret=True)
    with torch.no_grad():
        got = fc.fused_block_stack_apply(tt, torch.from_numpy(x),
                                         dtype=torch.float32)
        module = tt(torch.from_numpy(x).permute(0, 4, 1, 2, 3)) \
            .permute(0, 2, 3, 4, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # and the fused path equals the port's own module
    np.testing.assert_allclose(got.numpy(), module.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_block_stack_apply_takes_the_slab_kernel_past_the_row_limit(
        monkeypatch):
    """With the row limit lowered on both sides the 16³×16 synthesis tail
    goes to the slab variants; the result is unchanged."""
    name, in_shape = STACKS[2]
    jt, params, tt, x = _stack_pair(name, 64, in_shape)
    with torch.no_grad():
        ref = fc.fused_block_stack_apply(tt, torch.from_numpy(x),
                                         dtype=torch.float32)
    monkeypatch.setattr(fc, "MAX_FUSED_ROWS", 256)
    monkeypatch.setattr(jpc, "MAX_FUSED_ROWS", 256)
    seen = []
    slab_fn = fc.fused_residual_tail_slab
    monkeypatch.setattr(fc, "fused_residual_tail_slab", lambda *a, **k: (
        seen.append((k["spatial"], k["channels"])), slab_fn(*a, **k))[1])
    with torch.no_grad():
        got = fc.fused_block_stack_apply(tt, torch.from_numpy(x),
                                         dtype=torch.float32)
    assert seen == [(16, 16)]
    assert torch.equal(got, ref)
    want = jpc.fused_block_stack_apply(
        params, jnp.asarray(x), filters=64, widths=jt.widths,
        synthesis=True, dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name,in_shape", STACKS[::2])
def test_block_stack_apply_bf16_matches_jax(name, in_shape):
    jt, params, tt, x = _stack_pair(name, 64, in_shape)
    want = np.asarray(jpc.fused_block_stack_apply(
        params, jnp.asarray(x), filters=64, widths=jt.widths,
        synthesis=jt.synthesis, dtype=jnp.bfloat16,
        interpret=True).astype(jnp.float32))
    with torch.no_grad():
        got = fc.fused_block_stack_apply(tt, torch.from_numpy(x),
                                         dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    steps = bf16_steps(_f32(got), want)
    print(f"bf16 {name}: max {steps.max():.2f} steps, "
          f"{100 * (_f32(got) == want).mean():.2f}% equal")
    # several layers deep, a flipped rounding upstream moves whole
    # neighbourhoods by a step or two
    assert steps.max() <= 4.0
    assert (steps <= 1.0).mean() >= 0.99


def test_packed_tails_follow_the_parameters():
    """Packed once, packed anew after a weight load, equal to the packing
    of the flax tree."""
    name, in_shape = STACKS[0]
    _, params, tt, _ = _stack_pair(name, 64, in_shape)
    first = fc.packed_tails(tt, torch.float32)
    assert fc.packed_tails(tt, torch.float32) is first  # kept
    from_tree = tail_weights_from_jax(params, torch.float32)
    assert len(first) == len(from_tree) == 3
    for a, b in zip(first, from_tree):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert [t[0].shape[1] for t in first] == [16, 32, 64]
    state = {k: v + 1 for k, v in tt.state_dict().items()}
    tt.load_state_dict(state)
    second = fc.packed_tails(tt, torch.float32)
    assert second is not first
    assert torch.equal(second[0][0], first[0][0] + 1)
    bf = fc.packed_tails(tt, torch.bfloat16)
    assert bf[0][0].dtype == torch.bfloat16 and bf[0][1].dtype == torch.float32
    assert fc.packed_tails(tt, torch.float32) is second  # one per dtype


def _model_pair(dtype_j, dtype_t):
    jm = jax_build("c3p", dtype=dtype_j, conv_backend="pallas")
    tm = build_model("c3p", dtype=dtype_t, conv_backend="pallas")
    rng = np.random.default_rng(11)
    x = (rng.random((2, 16, 16, 16, 1)) < 0.05).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.PRNGKey(0), x, training=False))
    # lift the output bias so that x_hat is not all zero
    params["params"]["synthesis_t"]["ConvTranspose_0"]["bias"] += 0.55
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm.eval(), x


def test_model_pallas_backend_matches_jax_f32():
    """The JAX test's own bounds (tests/test_pallas_conv.py:126-147)."""
    jm, params, tm, x = _model_pair(None, None)
    want = jm.apply(params, x, method=jm.encode_syms)
    got = tm.encode_syms(torch.from_numpy(x))
    for k in ("y_sym", "z_sym"):
        same = np.mean(got[k].numpy() == np.asarray(want[k]))
        assert same > 0.999, (k, same)
    y_sym = np.asarray(want["y_sym"])
    dx = np.asarray(jm.apply(params, y_sym, method=jm.decode_y))
    dp = tm.decode_y(torch.from_numpy(y_sym))
    assert dp.dtype == torch.float32 and dp.shape == dx.shape
    np.testing.assert_allclose(dp.numpy(), dx, rtol=5e-3, atol=5e-4)
    # and against the port's own module backend
    tx = build_model("c3p")
    tx.load_state_dict(tm.state_dict())
    sx = tx.encode_syms(torch.from_numpy(x))
    for k in ("y_sym", "z_sym"):
        assert np.mean(got[k].numpy() == sx[k].numpy()) > 0.999
    np.testing.assert_allclose(dp.numpy(),
                               tx.decode_y(torch.from_numpy(y_sym)).numpy(),
                               rtol=5e-3, atol=5e-4)


def test_model_pallas_backend_matches_jax_bf16():
    """bf16 stacks: symbols are round(y) of bf16 values (3 significant
    digits), so a one-step difference in y near a .5 boundary flips a
    symbol by one; x_hat is a bf16 value in [0, 1] (step 2^-8 below 1)."""
    jm, params, tm, x = _model_pair(jnp.bfloat16, torch.bfloat16)
    want = jm.apply(params, x, method=jm.encode_syms)
    got = tm.encode_syms(torch.from_numpy(x))
    for k in ("y_sym", "z_sym"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == np.int32
        assert np.abs(g - w).max() <= 1, k
        assert np.mean(g == w) > 0.99, (k, np.mean(g == w))
    y_sym = np.asarray(want["y_sym"])
    dx = np.asarray(jm.apply(params, y_sym, method=jm.decode_y))
    dp = tm.decode_y(torch.from_numpy(y_sym)).numpy()
    assert dp.dtype == np.float32
    print(f"bf16 x_hat: max abs diff {np.abs(dp - dx).max():.3g}, "
          f"{100 * (dp == dx).mean():.2f}% equal")
    assert np.abs(dp - dx).max() <= 2.0 ** -7  # two steps below 1
    assert (dp == dx).mean() >= 0.99


def test_model_xla_backend_bf16_matches_jax():
    """``dtype`` alone (module / cuDNN backend): the flax modules' bf16."""
    jm = jax_build("c3p", dtype=jnp.bfloat16)
    tm = build_model("c3p", dtype=torch.bfloat16).eval()
    rng = np.random.default_rng(12)
    x = (rng.random((2, 16, 16, 16, 1)) < 0.05).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), x, training=False))
    tm.load_state_dict(params_from_jax(params))
    want = jm.apply(params, x, method=jm.encode_syms)
    got = tm.encode_syms(torch.from_numpy(x))
    for k in ("y_sym", "z_sym"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert np.abs(g - w).max() <= 1, k
        assert np.mean(g == w) > 0.99, (k, np.mean(g == w))
    z_sym = np.asarray(want["z_sym"])
    sigma, _ = jm.apply(params, z_sym, method=jm.decode_z)
    t_sigma, _ = tm.decode_z(torch.from_numpy(z_sym))
    assert t_sigma.dtype == torch.float32
    np.testing.assert_allclose(t_sigma.numpy(), np.asarray(sigma), rtol=2e-2,
                               atol=1e-3)
    y_sym = np.asarray(want["y_sym"])
    dx = np.asarray(jm.apply(params, y_sym, method=jm.decode_y))
    dp = tm.decode_y(torch.from_numpy(y_sym)).numpy()
    assert np.abs(dp - dx).max() <= 2.0 ** -7
    assert (dp == dx).mean() >= 0.99


def test_unknown_conv_backend_and_dtype_raise():
    with pytest.raises(ValueError, match="conv_backend"):
        build_model("c3p", conv_backend="cudnn")
    x = torch.zeros(1, 4, 4, 4, 16)
    _, w1, b1, w2, b2 = _operands(4, 16, n=1)
    with pytest.raises(ValueError, match="dtype"):
        fc.fused_residual_tail(x, w1, b1, w2, b2, spatial=4, channels=16,
                               dtype=torch.float16)
    with pytest.raises(ValueError, match="multiple of slab"):
        fc.fused_residual_tail_slab(x, w1, b1, w2, b2, spatial=4,
                                    channels=16, slab=3, dtype=torch.float32)
    with pytest.raises(ValueError, match="weights"):
        fc.fused_residual_tail(x, w1[..., :8], b1, w2, b2, spatial=4,
                               channels=16, dtype=torch.float32)

"""Port transforms and model vs flax ``apply`` on the CPU, same weights.

Weights come from numpy (flax init, or the committed asset) and cross via
``params_from_jax``. f32 conv outputs of order 1 agree to max-abs 1e-4:
XLA:CPU and ATen sum the conv products in different orders. Integer
outputs are equal except where the JAX pre-round value lies within 1e-4 of
a .5 boundary (symbols) or σ within 1e-5 relative of a scale-table entry
(CDF-row indexes).
"""

from pathlib import Path

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.models.transforms import Conv, ConvTranspose
from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree, params_from_jax

ASSET = (Path(__file__).resolve().parent.parent
         / "pcc_geo_cnn_v2_tpu/assets/bench_c3p.msgpack.gz")
ATOL = 1e-4


def _cfg(name, nf):
    from pcc_geo_cnn_v2_tpu.models.configs import MODEL_CONFIGS

    return dict(MODEL_CONFIGS[name], num_filters=nf)


def _ndhwc(t):
    return t.permute(0, 2, 3, 4, 1).detach().numpy()


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)


def _models(name, nf, block, seed=0):
    cfg = _cfg(name, nf)
    jm = jax_build(cfg)
    x = np.zeros((1, block, block, block, 1), np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), x, training=False))
    tm = build_model(cfg)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


def _blocks(n, block, seed, p=0.08):
    rng = np.random.default_rng(seed)
    return (rng.random((n, block, block, block, 1)) < p).astype(np.float32)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [4, 8])
@pytest.mark.parametrize("kernel", [3, 2])
def test_single_layer_matches_flax(transpose, stride, size, kernel):
    rng = np.random.default_rng(size * 10 + stride)
    cls, tcls = ((nn.ConvTranspose, ConvTranspose) if transpose
                 else (nn.Conv, Conv))
    layer = cls(5, (kernel,) * 3, strides=(stride,) * 3, padding="SAME")
    x = rng.standard_normal((2, size, size, size, 3)).astype(np.float32)
    p = jax.tree_util.tree_map(np.asarray,
                               layer.init(jax.random.PRNGKey(0), x))
    want = np.asarray(layer.apply(p, x))
    name = "ConvTranspose_0" if transpose else "Conv_0"
    t = tcls(3, 5, kernel, stride)
    t.load_state_dict({k.split(".", 1)[1]: v for k, v in
                       params_from_jax({name: p["params"]}).items()})
    got = _ndhwc(t(_ncdhw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_single_layer_bf16_matches_flax(transpose, stride):
    """``dtype=bfloat16`` as flax computes it: operands cast to bf16, f32
    sums rounded once, bias added in bf16, result bf16 — both as the
    layer's own type and as the type of one call. Sums differ in order, so
    an element may round the other way: at most one bf16 step (2^-8
    relative), and rarely."""
    import jax.numpy as jnp

    rng = np.random.default_rng(stride)
    cls, tcls = ((nn.ConvTranspose, ConvTranspose) if transpose
                 else (nn.Conv, Conv))
    layer = cls(5, (3,) * 3, strides=(stride,) * 3, padding="SAME",
                dtype=jnp.bfloat16)
    x = rng.standard_normal((2, 8, 8, 8, 3)).astype(np.float32)
    p = jax.tree_util.tree_map(np.array,
                               layer.init(jax.random.PRNGKey(0), x))
    p["params"]["bias"] += rng.standard_normal(5).astype(np.float32)
    want = layer.apply(p, x)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    name = "ConvTranspose_0" if transpose else "Conv_0"
    state = {k.split(".", 1)[1]: v for k, v in
             params_from_jax({name: p["params"]}).items()}
    typed = tcls(3, 5, 3, stride, dtype=torch.bfloat16)
    plain = tcls(3, 5, 3, stride)
    for t in (typed, plain):
        t.load_state_dict(state)
        assert t.weight.dtype == torch.float32  # parameters stay f32
    with torch.no_grad():
        outs = [typed(_ncdhw(x)), plain(_ncdhw(x), dtype=torch.bfloat16)]
    assert torch.equal(*outs) and outs[0].dtype == torch.bfloat16
    got = outs[0].permute(0, 2, 3, 4, 1).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -9)
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("name", ["c3p", "c3"])
@pytest.mark.parametrize("part", ["analysis_t", "synthesis_t",
                                  "hyper_analysis_t", "hyper_synthesis_t"])
def test_transforms_match_flax(name, part):
    B, nf = 16, 8
    jm, params, tm = _models(name, nf, B)
    rng = np.random.default_rng(1)
    shapes = {"analysis_t": (2, B, B, B, 1),
              "synthesis_t": (2, B // 8, B // 8, B // 8, nf),
              "hyper_analysis_t": (2, B // 8, B // 8, B // 8, nf),
              "hyper_synthesis_t": (2, B // 16, B // 16, B // 16, nf)}
    x = (_blocks(2, B, 1) if part == "analysis_t" else
         rng.standard_normal(shapes[part]).astype(np.float32))
    want = np.asarray(jm.apply(params, x,
                               method=lambda m, v: getattr(m, part)(v)))
    with torch.no_grad():
        got = _ndhwc(getattr(tm, part)(_ncdhw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _check_symbols(got, want_pre):
    """Integer symbols equal except at JAX pre-round values within 1e-4 of
    a .5 boundary."""
    want = np.round(want_pre).astype(np.int32)
    frac = np.abs(want_pre - np.floor(want_pre) - 0.5)
    borderline = frac < 1e-4
    assert np.array_equal(got[~borderline], want[~borderline])
    return borderline.mean()


def _check_model(jm, params, tm, x):
    medians = params["params"]["entropy_bottleneck"]["quantiles"][:, 1]
    y = np.asarray(jm.apply(params, x, method=lambda m, v: m.analysis_t(v)))
    z = np.asarray(jm.apply(params, y,
                            method=lambda m, v: m.hyper_analysis_t(v)))
    got = tm.encode_syms(torch.from_numpy(x))
    _check_symbols(got["y_sym"].numpy(), y)
    _check_symbols(got["z_sym"].numpy(), z - medians)

    want_y = np.asarray(jm.apply(params, x, method=jm.encode_syms)["y_sym"])
    want_z = np.asarray(jm.apply(params, x, method=jm.encode_syms)["z_sym"])
    sigma, idx = jm.apply(params, want_z, method=jm.decode_z)
    t_sigma, t_idx = tm.decode_z(torch.from_numpy(np.array(want_z)))
    np.testing.assert_allclose(t_sigma.numpy(), np.asarray(sigma), atol=ATOL,
                               rtol=0)
    table = np.asarray(tm.conditional.scale_table[:-1], np.float32)
    near = np.any(np.abs(np.asarray(sigma)[..., None] - table)
                  <= 1e-5 * table, axis=-1)
    assert np.array_equal(t_idx.numpy()[~near], np.asarray(idx)[~near])

    x_hat = np.asarray(jm.apply(params, want_y, method=jm.decode_y))
    t_x_hat = tm.decode_y(torch.from_numpy(np.array(want_y))).numpy()
    assert t_x_hat.shape == x_hat.shape and t_x_hat.dtype == np.float32
    np.testing.assert_allclose(t_x_hat, x_hat, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["c3p", "c3"])
def test_model_entry_points_match_flax(name):
    jm, params, tm = _models(name, 8, 16)
    _check_model(jm, params, tm, _blocks(3, 16, 2))


def test_full_width_c3p_asset_block():
    """The flagship at full width (64 filters) on one 64³ block."""
    jm = jax_build("c3p")
    params = load_asset_tree(ASSET)
    tm = build_model("c3p")
    tm.load_state_dict(params_from_jax(params))
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud

    pts = figure_cloud(5, 128, with_normals=False)
    blocks, _ = partition_octree(pts, [0, 0, 0], [128] * 3, 1)
    b = max(blocks, key=len).astype(np.int64)
    x = np.zeros((1, 64, 64, 64, 1), np.float32)
    x[0, b[:, 0], b[:, 1], b[:, 2], 0] = 1.0
    _check_model(jm, params, tm, x)

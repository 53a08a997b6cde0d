"""The port's V1 transforms, the ``concat`` residual mode and the c1 / c2
models against flax on the CPU, same weights (numpy, through
``params_from_jax``).

- V1 analysis / synthesis and the concat-mode V2 stacks with seeded random
  weights: f32 outputs within atol 1e-5;
- the k9 stride-2 layers' geometry: SAME pads (3, 4) at 64, parity classes
  of 5 and 4 taps, each layer against flax;
- c1 and c2 with the committed ``assets/rd`` weights on a 16³ block: y
  symbols equal to JAX ``encode_syms``, x_hat within atol 1e-5, the
  factorized-prior CDF tables equal.
"""

from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.models import transforms as jtr
from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
from pcc_geo_cnn_v2_tpu.models.entropy import (
    build_factorized_cdf as jax_factorized_cdf,
)
from pcc_geo_cnn_v2_tpu.models.entropy import (
    refine_factorized_quantiles as jax_refine,
)
from pcc_geo_cnn_v2_tpu_torch.models import transforms as ttr
from pcc_geo_cnn_v2_tpu_torch.models.codec_models import (
    CompressionModelV1,
    CompressionModelV2,
)
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.models.entropy import (
    build_factorized_cdf,
    refine_factorized_quantiles,
)
from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree, params_from_jax

RD = Path(__file__).resolve().parent.parent / "pcc_geo_cnn_v2_tpu/assets/rd"
ATOL = 1e-5


def _ndhwc(t):
    return t.permute(0, 2, 3, 4, 1).detach().numpy()


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)


def _occupancy(n, block, seed, p=0.08):
    rng = np.random.default_rng(seed)
    return (rng.random((n, block, block, block, 1)) < p).astype(np.float32)


def _load(module, params):
    module.load_state_dict(params_from_jax(params))
    return module.eval()


def _against_flax(jmod, tmod, x, seed=0):
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(seed), x))
    want = np.asarray(jmod.apply(params, x))
    with torch.no_grad():
        got = _ndhwc(_load(tmod, params)(_ncdhw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    return got


def test_v1_geometry():
    assert ttr.same_pads(64, 9, 2) == (3, 4)
    assert ttr.same_pads(16, 5, 2) == (1, 2)
    pad_a, _ = ttr.transpose_pads(9, 2)
    assert [len(ttr._parity_taps(9, 2, pad_a, r)[0]) for r in (0, 1)] \
        == [4, 5]
    pad_a, _ = ttr.transpose_pads(5, 2)
    assert [len(ttr._parity_taps(5, 2, pad_a, r)[0]) for r in (0, 1)] \
        == [2, 3]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("size", [5, 8])
def test_k9_stride2_layer_matches_flax(transpose, size):
    rng = np.random.default_rng(size)
    cin, cout = (4, 1) if transpose else (1, 4)
    x = rng.standard_normal((2, size, size, size, cin)).astype(np.float32)
    cls, tcls = ((nn.ConvTranspose, ttr.ConvTranspose) if transpose
                 else (nn.Conv, ttr.Conv))
    layer = cls(cout, (9, 9, 9), strides=(2, 2, 2), padding="SAME")
    p = jax.tree_util.tree_map(np.asarray,
                               layer.init(jax.random.PRNGKey(1), x))
    want = np.asarray(layer.apply(p, x))
    name = "ConvTranspose_0" if transpose else "Conv_0"
    t = tcls(cin, cout, 9, 2)
    t.load_state_dict({k.split(".", 1)[1]: v for k, v in
                       params_from_jax({name: p["params"]}).items()})
    with torch.no_grad():
        got = _ndhwc(t(_ncdhw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("block", [16, 32])
def test_v1_analysis_matches_flax(block):
    nf = 8
    _against_flax(jtr.AnalysisTransformV1(nf), ttr.AnalysisTransformV1(nf),
                  _occupancy(2, block, block))


@pytest.mark.parametrize("block", [16, 32])
def test_v1_synthesis_matches_flax(block):
    nf = 8
    rng = np.random.default_rng(block)
    y = rng.standard_normal((2, block // 8, block // 8, block // 8, nf))
    got = _against_flax(jtr.SynthesisTransformV1(nf),
                        ttr.SynthesisTransformV1(nf), y.astype(np.float32))
    assert got.shape == (2, block, block, block, 1) and (got >= 0).all()


@pytest.mark.parametrize("name", ["AnalysisTransformV2",
                                  "AnalysisTransformProgressiveV2",
                                  "SynthesisTransformV2",
                                  "SynthesisTransformProgressiveV2"])
def test_concat_mode_matches_flax(name):
    nf, block = 8, 16
    jmod = getattr(jtr, name)(nf, residual_mode="concat")
    tmod = ttr.TRANSFORMS[name](nf, residual_mode="concat")
    if name.startswith("Analysis"):
        x = _occupancy(2, block, 3)
    else:
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 2, 2, 2, nf)).astype(np.float32)
    _against_flax(jmod, tmod, x)
    with pytest.raises(ValueError, match="residual_mode"):
        ttr.TRANSFORMS[name](nf, residual_mode="mul")


def test_concat_stack_is_not_fused():
    """The fused-conv backend takes ``add`` stacks only (as the JAX
    model's ``_stack``): a concat stack runs its modules."""
    m = CompressionModelV2(8, conv_backend="pallas")
    assert m._fused(m.analysis_t)
    m.analysis_t = ttr.AnalysisTransformV2(8, residual_mode="concat")
    assert not m._fused(m.analysis_t)


def test_build_model_v1_and_v2_with_v1_transforms():
    c1, c2 = build_model("c1"), build_model("c2", conv_backend="pallas")
    assert isinstance(c1, CompressionModelV1) and c1.num_filters == 32
    assert isinstance(c2, CompressionModelV2)
    assert isinstance(c2.analysis_t, ttr.AnalysisTransformV1)
    assert not c2._fused(c2.analysis_t) and not c2._fused(c2.synthesis_t)
    with pytest.raises(ValueError, match="kind"):
        build_model(dict(model="v3", num_filters=8))


def _asset(name):
    return load_asset_tree(RD / name / "2.00e-04.msgpack.gz")


def _block16(seed):
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud

    pts = figure_cloud(seed, 64, with_normals=False)
    blocks, _ = partition_octree(pts, [0, 0, 0], [64] * 3, 2)
    b = max(blocks, key=len).astype(np.int64)
    x = np.zeros((1, 16, 16, 16, 1), np.float32)
    x[0, b[:, 0], b[:, 1], b[:, 2], 0] = 1.0
    return x


@pytest.mark.parametrize("name", ["c1", "c2"])
def test_committed_asset_matches_jax(name):
    params = _asset(name)
    jm = jax_build(name)
    tm = build_model(name)
    tm.load_state_dict(params_from_jax(params))
    x = _block16(7)
    want = jax.tree_util.tree_map(
        np.asarray, jm.apply(params, jnp.asarray(x), method=jm.encode_syms))
    got = tm.encode_syms(torch.from_numpy(x))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)
    y = np.array(want["y_sym"])
    if name == "c1":
        x_hat = np.asarray(jm.apply(params, y, method=jm.decode))
        t_x_hat = tm.decode(torch.from_numpy(y)).numpy()
    else:
        x_hat = np.asarray(jm.apply(params, y, method=jm.decode_y))
        t_x_hat = tm.decode_y(torch.from_numpy(y)).numpy()
    assert t_x_hat.shape == x_hat.shape == (1, 16, 16, 16, 1)
    np.testing.assert_allclose(t_x_hat, x_hat, atol=ATOL, rtol=0)
    assert (y != 0).any()


@pytest.mark.parametrize("name", ["c1", "c2"])
def test_committed_asset_cdf_tables_equal_jax(name):
    eb = dict(_asset(name)["params"]["entropy_bottleneck"])
    eb_t, eb_j = dict(eb), dict(eb)
    eb_t["quantiles"] = refine_factorized_quantiles(eb)["quantiles"]
    eb_j["quantiles"] = np.asarray(jax_refine(eb)["quantiles"])
    np.testing.assert_array_equal(eb_t["quantiles"], eb_j["quantiles"])
    got, want = build_factorized_cdf(eb_t), jax_factorized_cdf(eb_j)
    assert got.rows == want.rows == 32
    for field in ("cdf", "cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)))

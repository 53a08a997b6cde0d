"""The port's training graph against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, and the same noise, drawn
with ``jax.random`` from the keys the JAX loss splits and passed to the
port, go through both. Weights are the committed assets (``bench_c3p``,
``rd/{c2,c1}/2.00e-04``) on both sides: flax and torch initialisers draw
different numbers, so a parity from an init would prove nothing.
Tolerances: loss and mbpov 1e-5 relative; likelihoods 1e-6 + 1e-5·|p| per
element; every parameter leaf's gradient within 1e-3 of that leaf's
largest |g| (XLA:CPU and oneDNN sum conv products in other orders); the
optimizer 1e-7 of optax on identical gradients, plus one f32 rounding of
the parameter.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pcc_geo_cnn_v2_tpu.models import entropy as jent
from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
from pcc_geo_cnn_v2_tpu.ops import losses as jloss
from pcc_geo_cnn_v2_tpu.ops.voxel import voxelize as jax_voxelize
from pcc_geo_cnn_v2_tpu.training import TrainConfig as JaxTrainConfig
from pcc_geo_cnn_v2_tpu.training import _label_params, make_loss_fn
from pcc_geo_cnn_v2_tpu.utils.data import BlockDataset, synthetic_blocks
from pcc_geo_cnn_v2_tpu_torch.models import entropy as tent
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.ops import losses as tloss
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import voxelize
from pcc_geo_cnn_v2_tpu_torch.training import init_params, make_optimizer
from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree, params_from_jax

ASSETS = Path(__file__).resolve().parent.parent / "pcc_geo_cnn_v2_tpu/assets"
WEIGHTS = {"c3p": ASSETS / "bench_c3p.msgpack.gz",
           "c2": ASSETS / "rd/c2/2.00e-04.msgpack.gz",
           "c1": ASSETS / "rd/c1/2.00e-04.msgpack.gz"}
REL = 1e-5
LIK_ATOL, LIK_RTOL = 1e-6, 1e-5
GRAD_TOL = 1e-3
BLOCK, BATCH = 16, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops: one intra-op thread (the tier-1 run has six
    workers on the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _assert_grads(got, want, what):
    """Each leaf within GRAD_TOL of its largest |g|."""
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].detach().numpy() if got[name] is not None \
            else np.zeros_like(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, (what, name, err, scale)


# -- lower_bound -------------------------------------------------------------


@pytest.mark.parametrize("x, g, passes", [
    (2.0, 1.0, True),     # above the bound: passes
    (2.0, -1.0, True),
    (0.5, -1.0, True),    # below, but the gradient would raise x: passes
    (0.5, 1.0, False),    # below and pushing further down: stopped
])
def test_lower_bound_gradient_cases(x, g, passes):
    bound = 1.0
    xt = torch.tensor([x], requires_grad=True)
    y = tent.lower_bound(xt, bound)
    assert float(y.detach()) == max(x, bound)
    y.backward(torch.tensor([g]))
    _, vjp = jax.vjp(lambda v: jent.lower_bound(v, bound), jnp.array([x]))
    want = float(vjp(jnp.array([g]))[0][0])
    assert float(xt.grad[0]) == want == (g if passes else 0.0)


# -- the entropy models on the committed c3p weights -------------------------


def _eb_tree():
    return load_asset_tree(WEIGHTS["c3p"])["params"]["entropy_bottleneck"]


def _port_eb(tree):
    eb = tent.FactorizedPrior(tree["quantiles"].shape[0])
    eb.load_state_dict({k: _t(v) for k, v in tree.items()})
    return eb


def test_factorized_likelihood_and_gradients_match_flax():
    tree = _eb_tree()
    c = tree["quantiles"].shape[0]
    rng = np.random.default_rng(0)
    y = (rng.standard_normal((2, 3, 3, 3, c)) * 2.0).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jm = jent.FactorizedPrior(c)
    flat_shape = (c, 1, y.size // c)
    noise = np.asarray(jax.random.uniform(key, flat_shape, jnp.float32,
                                          -0.5, 0.5))
    noise = np.moveaxis(noise.reshape((c,) + y.shape[:-1]), 0, -1)

    def jax_fn(params, y):
        yt, p = jm.apply({"params": params}, y, True, key)
        return jnp.sum(jnp.log(p)), (yt, p)

    (_, (yt_j, p_j)), (gp_j, gy_j) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(tree, jnp.asarray(y))
    eb = _port_eb(tree)
    yt = torch.from_numpy(y).requires_grad_(True)
    y_tilde, p = eb(yt, True, torch.from_numpy(noise))
    torch.sum(torch.log(p)).backward()
    np.testing.assert_array_equal(y_tilde.detach().numpy(), yt_j)
    np.testing.assert_allclose(p.detach().numpy(), p_j, rtol=LIK_RTOL,
                               atol=LIK_ATOL)
    _assert_grads({k: v.grad for k, v in eb.named_parameters()}
                  | {"y": yt.grad}, dict(gp_j, y=gy_j), "factorized")

    # inference quantization around the medians
    _, p_inf = eb(torch.from_numpy(y), False)
    _, p_inf_j = jm.apply({"params": tree}, jnp.asarray(y), False)
    np.testing.assert_allclose(p_inf.detach().numpy(), p_inf_j,
                               rtol=LIK_RTOL, atol=LIK_ATOL)


def test_aux_loss_and_its_gradient_move_only_the_quantiles():
    tree = dict(_eb_tree())
    # off the refined quantiles, so that the aux loss has a gradient
    tree["quantiles"] = tree["quantiles"] + np.float32(0.37)
    jm = jent.FactorizedPrior(tree["quantiles"].shape[0])
    aux_j, g_j = jax.value_and_grad(
        lambda p: jm.apply({"params": p}, method=jm.aux_loss))(tree)
    eb = _port_eb(tree)
    aux = eb.aux_loss()
    aux.backward()
    assert abs(float(aux) - float(aux_j)) <= REL * abs(float(aux_j))
    for name, param in eb.named_parameters():
        if name == "quantiles":
            _assert_grads({name: param.grad}, {name: g_j[name]}, "aux")
        else:  # stop_params: no gradient into the density
            assert param.grad is None or not param.grad.any(), name
            assert not np.asarray(g_j[name]).any(), name


def test_gaussian_likelihood_and_gradients_match_jax():
    rng = np.random.default_rng(1)
    y = (rng.standard_normal((2, 4, 4, 4, 8)) * 3).astype(np.float32)
    # scales below the table's first entry exercise lower_bound
    sigma = np.exp(rng.uniform(-4, 3, y.shape)).astype(np.float32)
    gc_j = jent.GaussianConditional()
    gc = tent.GaussianConditional()

    def jax_fn(y, s):
        p = gc_j.likelihood(y, s)
        return jnp.sum(jnp.log(p)), p

    (_, p_j), (gy_j, gs_j) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(y),
                                              jnp.asarray(sigma))
    yt = torch.from_numpy(y).requires_grad_(True)
    st = torch.from_numpy(sigma).requires_grad_(True)
    p = gc.likelihood(yt, st)
    torch.sum(torch.log(p)).backward()
    np.testing.assert_allclose(p.detach().numpy(), p_j, rtol=LIK_RTOL,
                               atol=LIK_ATOL)
    _assert_grads({"y": yt.grad, "sigma": st.grad},
                  {"y": gy_j, "sigma": gs_j}, "gaussian")
    assert (np.asarray(gs_j)[sigma < gc.scale_table[0]] == 0).any()


# -- the losses --------------------------------------------------------------


def _loss_inputs(seed):
    """Occupancy and predictions with values exactly at the clip bounds
    (f32 1e-3 and 0.999), at 0 and at 1, at occupied and empty voxels."""
    rng = np.random.default_rng(seed)
    x = (rng.random((2, 8, 8, 8, 1)) < 0.3).astype(np.float32)
    xt = rng.random(x.shape).astype(np.float32)
    flat = xt.reshape(-1)
    special = np.array([1e-3, 0.999, 0.0, 1.0], np.float32)
    flat[:64] = np.resize(special, 64)
    return x, xt


@pytest.mark.parametrize("seed", [0, 1])
def test_focal_loss_and_metrics_at_the_clip_bounds(seed):
    x, xt = _loss_inputs(seed)
    fl_j, g_j = jax.value_and_grad(
        lambda p: jloss.focal_loss(jnp.asarray(x), p))(jnp.asarray(xt))
    pt = torch.from_numpy(xt).requires_grad_(True)
    fl = tloss.focal_loss(torch.from_numpy(x), pt)
    fl.backward()
    assert abs(float(fl) - float(fl_j)) <= REL * abs(float(fl_j))
    np.testing.assert_allclose(pt.grad.numpy(), g_j, rtol=1e-5, atol=1e-7)
    # the ties take half of the gradient, as jnp.clip's
    at_bound = (xt == np.float32(1e-3)) | (xt == np.float32(0.999))
    assert at_bound.any() and np.asarray(g_j)[at_bound].any()
    m_j = jloss.binary_classification_metrics(jnp.asarray(x), jnp.asarray(xt))
    m = tloss.binary_classification_metrics(torch.from_numpy(x),
                                            torch.from_numpy(xt))
    assert sorted(m) == sorted(m_j)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-6)


def test_rd_loss_logs_match():
    x, xt = _loss_inputs(2)
    rng = np.random.default_rng(3)
    liks = [rng.uniform(1e-9, 1, (2, 1, 1, 1, 8)).astype(np.float32)
            for _ in range(2)]
    loss_j, logs_j = jloss.rd_loss(jnp.asarray(x), jnp.asarray(xt),
                                   [jnp.asarray(p) for p in liks], 1e-4)
    loss, logs = tloss.rd_loss(torch.from_numpy(x), torch.from_numpy(xt),
                               [torch.from_numpy(p) for p in liks], 1e-4)
    assert sorted(logs) == sorted(logs_j)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(logs_j[k]),
                                   rtol=REL)
    assert float(loss) == float(logs["loss"])


# -- the whole training graph on the committed weights -----------------------


def _points(seed):
    blocks = synthetic_blocks(BATCH, block_size=BLOCK, seed=seed, kind="mix")
    return BlockDataset(blocks)._pack(np.arange(BATCH))


def _jax_noise(model, params, x, key, is_v2):
    """The noises the JAX modules draw from the keys of ``make_loss_fn``,
    in NDHWC (the factorized prior draws on its ``[C, 1, M]`` view and
    maps back with its ``restore``)."""
    r1, r2 = jax.random.split(key)
    out = model.apply(params, x, training=True, noise_rng=r1,
                      **({"noise_rng2": r2} if is_v2 else {}))
    fp_in = out["z"] if is_v2 else out["y"]
    c = fp_in.shape[-1]
    flat = jax.random.uniform(r1, (c, 1, fp_in.size // c), jnp.float32,
                              -0.5, 0.5)
    fp_noise = np.moveaxis(np.asarray(flat).reshape((c,) + fp_in.shape[:-1]),
                           0, -1)
    if not is_v2:
        return out, {"noise_y": fp_noise}
    y_noise = np.asarray(jax.random.uniform(r2, out["y"].shape, jnp.float32,
                                            -0.5, 0.5))
    return out, {"noise_z": fp_noise, "noise_y": y_noise}


@pytest.mark.parametrize("config", ["c3p", "c2", "c1"])
def test_training_step_matches_jax_on_committed_weights(config):
    tree = load_asset_tree(WEIGHTS[config])
    params = {"params": tree["params"]}
    jm = jax_build(config)
    is_v2 = config != "c1"
    cfg = JaxTrainConfig(block_size=BLOCK, batch_size=BATCH, lmbda=2e-4)
    points = _points(seed=7)
    key = jax.random.PRNGKey(11)
    x = jax_voxelize(jnp.asarray(points), BLOCK)
    out_j, noise = _jax_noise(jm, params, x, key, is_v2)
    (total_j, logs_j), grads_j = jax.value_and_grad(
        make_loss_fn(jm, cfg), has_aux=True)(params, jnp.asarray(points), key)

    tm = build_model(config)
    tm.load_state_dict(params_from_jax(tree))
    xt = voxelize(torch.from_numpy(points), BLOCK)
    np.testing.assert_array_equal(xt.numpy(), x)
    out = tm(xt, training=True,
             **{k: torch.from_numpy(v) for k, v in noise.items()})
    liks = [out["y_likelihoods"]] + ([out["z_likelihoods"]] if is_v2 else [])
    loss, logs = tloss.rd_loss(xt, out["x_tilde"], liks, cfg.lmbda)
    aux = tm.aux_loss()
    (loss + aux).backward()

    for k in ("y_likelihoods", "z_likelihoods"):
        if k in out:
            np.testing.assert_allclose(out[k].detach().numpy(), out_j[k],
                                       rtol=LIK_RTOL, atol=LIK_ATOL)
    for k in ("loss", "mbpov", "focal_loss"):
        assert abs(float(logs[k]) - float(logs_j[k])) \
            <= REL * abs(float(logs_j[k])), (k, float(logs[k]),
                                              float(logs_j[k]))
    assert abs(float(loss + aux) - float(total_j)) <= REL * abs(
        float(total_j))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    _assert_grads({k: p.grad for k, p in tm.named_parameters()},
                  {k: v.numpy() for k, v in want.items()}, config)


# -- the optimizer -----------------------------------------------------------


def test_adam_groups_match_optax_multi_transform_on_identical_gradients():
    tree = load_asset_tree(WEIGHTS["c1"])
    params = jax.tree_util.tree_map(jnp.asarray, {"params": tree["params"]})
    tx = optax.multi_transform({"main": optax.adam(1e-4),
                                "aux": optax.adam(1e-3)},
                               _label_params(params))
    opt_state = tx.init(params)
    tm = build_model("c1")
    tm.load_state_dict(params_from_jax(tree))
    opt = make_optimizer(tm)
    rng = np.random.default_rng(5)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape)
                       * 10.0 ** rng.integers(-6, 1)).astype(np.float32),
            jax.tree_util.tree_map(np.asarray, params))
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, grad in params_from_jax(g).items():
            tm.get_parameter(name).grad = grad
        opt.step()
    # 1e-7, plus the one rounding of p + update at the parameter's own
    # magnitude (one f32 spacing: 9.5e-7 at the quantiles' ±10)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.detach().numpy() - w)
        assert (err <= 1e-7 + np.spacing(np.abs(w))).all(), (name,
                                                             err.max())
    lrs = {len(g["params"]): g["lr"] for g in opt.param_groups}
    assert lrs == {1: 1e-3, len(list(tm.parameters())) - 1: 1e-4}


# -- the init ----------------------------------------------------------------


def test_init_follows_flax_distributions():
    model = build_model("c3p")
    init_params(model, torch.Generator().manual_seed(0))
    eb = model.entropy_bottleneck
    dims = (1, 3, 3, 3, 1)
    scale = 10.0 ** (1 / 4)
    for name, p in model.named_parameters():
        v = p.detach().numpy()
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight":
            fan_in = v[0].size
            std = np.sqrt(1.0 / fan_in)
            # a truncated normal of variance 1/fan_in, cut at ±2 / 0.8796 std
            assert np.abs(v).max() <= 2 * std / 0.87962566103423978 + 1e-7
            assert abs(v.std() / std - 1) < 0.05 + 3 / np.sqrt(v.size), name
            assert abs(v.mean()) < 4 * std / np.sqrt(v.size), name
        elif leaf == "bias" and not name.startswith("entropy_bottleneck"):
            assert not v.any(), name
    for k in range(4):
        m = getattr(eb, f"matrix_{k}").detach().numpy()
        assert (m == np.float32(np.log(np.expm1(1 / scale / dims[k + 1])))
                ).all()
        b = getattr(eb, f"bias_{k}").detach().numpy()
        assert b.min() >= -0.5 and b.max() < 0.5
        if k < 3:
            assert not getattr(eb, f"factor_{k}").detach().any()
    biases = np.concatenate([getattr(eb, f"bias_{k}").detach().numpy().ravel()
                             for k in range(4)])
    assert abs(biases.mean()) < 4 / np.sqrt(12 * biases.size)
    assert abs(biases.std() - 1 / np.sqrt(12)) < 0.02
    np.testing.assert_array_equal(
        eb.quantiles.detach().numpy(),
        np.tile(np.array([[-10, 0, 10]], np.float32), (64, 1)))
    # flax's own init of the same model: the same fixed leaves
    jm = jax_build("c3p")
    fp = jm.init(jax.random.PRNGKey(0),
                 jnp.zeros((1, BLOCK, BLOCK, BLOCK, 1)), training=True,
                 noise_rng=jax.random.PRNGKey(1),
                 noise_rng2=jax.random.PRNGKey(2))["params"]
    for k in range(4):
        np.testing.assert_array_equal(
            getattr(eb, f"matrix_{k}").detach().numpy(),
            fp["entropy_bottleneck"][f"matrix_{k}"])
    np.testing.assert_array_equal(eb.quantiles.detach().numpy(),
                                  fp["entropy_bottleneck"]["quantiles"])

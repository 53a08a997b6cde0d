"""Data-parallel training (``training.Trainer(group=...)``) on the CPU.

Two ranks in two processes over ``gloo`` train c3p on the committed
``bench_c3p`` weights, at 16³ and a global batch of 4 (two rows a rank),
against:

- the single-process port step on the whole batch, with the same noise
  (drawn from the (seed, step) generator for the global batch): loss and
  the other logs within 1e-6 relative (the ranks add their shares in
  another order), every gradient leaf within 1e-3 of its largest |g|, the
  bound of ``tests/test_torch_train_parity.py``;
- the JAX mesh step, ``make_train_step(model, cfg, mesh=make_mesh(2))`` on
  the conftest's virtual devices, with JAX's noise passed to the port as
  the parity tests pass it: loss within 1e-5 relative and every gradient
  leaf within 1e-3 of its largest |g| (XLA:CPU and oneDNN sum conv
  products in other orders), the parity tests' bounds.

The ranks' parameters are bit-identical after the step, rank 0 alone
writes the log, the checkpoints and the ``done`` marker, and a global
batch that the world size does not divide raises. A last test shows that
averaging the ranks' own losses, as ``DistributedDataParallel`` does,
gives another loss and other gradients: the global-denominator rule is
what these tests hold.
"""

import multiprocessing
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
from pcc_geo_cnn_v2_tpu.ops.voxel import voxelize as jax_voxelize
from pcc_geo_cnn_v2_tpu.parallel import mesh as jax_mesh
from pcc_geo_cnn_v2_tpu.training import TrainConfig as JaxTrainConfig
from pcc_geo_cnn_v2_tpu.training import TrainState, create_train_state
from pcc_geo_cnn_v2_tpu.training import make_loss_fn as jax_make_loss_fn
from pcc_geo_cnn_v2_tpu.training import make_train_step
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.ops import losses as tloss
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import voxelize
from pcc_geo_cnn_v2_tpu_torch.parallel import mesh
from pcc_geo_cnn_v2_tpu_torch.training import TrainConfig, Trainer, draw_noise
from pcc_geo_cnn_v2_tpu_torch.utils.data import BlockDataset, synthetic_blocks
from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree, params_from_jax

ASSET = (Path(__file__).resolve().parent.parent
         / "pcc_geo_cnn_v2_tpu/assets/bench_c3p.msgpack.gz")
BLOCK, BATCH, WORLD = 16, 4, 2
DP_REL, JAX_REL, GRAD_TOL = 1e-6, 1e-5, 1e-3
JOIN_S = 600


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops: one intra-op thread (the tier-1 run has six
    workers on the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return TrainConfig(block_size=BLOCK, batch_size=BATCH, **kw)


def _points():
    blocks = synthetic_blocks(BATCH, block_size=BLOCK, seed=7, kind="mix")
    return BlockDataset(blocks)._pack(np.arange(BATCH))


def _trainer(directory, group=None):
    return Trainer(build_model("c3p"), _cfg(), directory, warm_start=ASSET,
                   device="cpu", group=group)


def _step_record(trainer, logs):
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": {n: p.grad.clone()
                      for n, p in trainer.model.named_parameters()},
            "params": {k: v.clone()
                       for k, v in trainer.model.state_dict().items()}}


def _rank_main(rank, init_method, out_dir, points, jax_noise):
    """One rank: a step on the trainer's own noise, a step on JAX's noise,
    an indivisible batch, and ``fit`` in a shared directory."""
    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    out = {}
    with mesh.process_group(rank, WORLD, init_method) as (group, device):
        assert device == torch.device("cpu")
        t = _trainer(out_dir / f"own_{rank}", group)
        out["own"] = _step_record(t, t.step_batch(points, step=1))
        t = _trainer(out_dir / f"jax_{rank}", group)
        noise = {k: t._rows(torch.from_numpy(v))
                 for k, v in jax_noise.items()}
        out["jax"] = _step_record(t, t._update(
            torch.from_numpy(t._rows(points)), noise))
        try:
            t.step_batch(points[:3], step=2)
        except ValueError as e:
            out["indivisible"] = str(e)
        cfg = _cfg(max_steps=2, val_every=2, log_every=1, val_batches=1)
        t = Trainer(build_model("c3p"), cfg, out_dir / "fit",
                    warm_start=ASSET, device="cpu", group=group)
        out["fit"] = t.fit(iter([points] * 2), lambda: iter([points]))
    torch.save(out, out_dir / f"rank{rank}.pt")


def _jax_noise(model, params, x, key):
    """The noises the JAX c3p draws from the keys of ``make_loss_fn``, in
    NDHWC (``tests/test_torch_train_parity.py``)."""
    r1, r2 = jax.random.split(key)
    out = model.apply(params, x, training=True, noise_rng=r1, noise_rng2=r2)
    c = out["z"].shape[-1]
    flat = jax.random.uniform(r1, (c, 1, out["z"].size // c), jnp.float32,
                              -0.5, 0.5)
    z = np.moveaxis(np.asarray(flat).reshape((c,) + out["z"].shape[:-1]),
                    0, -1)
    y = np.asarray(jax.random.uniform(r2, out["y"].shape, jnp.float32, -0.5,
                                      0.5))
    return {"noise_z": z, "noise_y": y}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' records, the single-process port step, and JAX's mesh
    step and sharded gradients."""
    tmp = tmp_path_factory.mktemp("dp")
    points = _points()
    params = {"params": load_asset_tree(ASSET)["params"]}
    jm = jax_build("c3p")
    key = jax.random.PRNGKey(11)
    jax_noise = _jax_noise(jm, params, jax_voxelize(jnp.asarray(points),
                                                    BLOCK), key)

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, f"file://{tmp}/rendezvous", str(tmp), points, jax_noise))
        for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
    assert not alive, "a rank did not finish"
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]

    single = _trainer(tmp / "single")
    own = _step_record(single, single.step_batch(points, step=1))

    cfg = JaxTrainConfig(block_size=BLOCK, batch_size=BATCH)
    dp = jax_mesh.make_mesh(WORLD)
    rep, data = jax_mesh.replicated(dp), jax_mesh.batch_sharding(dp)
    grad_fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm, cfg),
                                         has_aux=True),
                      in_shardings=(rep, data, rep))
    (_, logs_j), grads_j = grad_fn(params, jnp.asarray(points), key)
    state = create_train_state(jm, jax.random.PRNGKey(0), cfg)
    state = TrainState.create(apply_fn=jm.apply, params=params, tx=state.tx)
    _, step_logs = make_train_step(jm, cfg, mesh=dp)(
        state, jnp.asarray(points), key)
    grads_j = params_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    return dict(ranks=ranks, own=own, tmp=tmp, jax_logs=logs_j,
                jax_step_logs=step_logs, jax_grads=grads_j)


def _assert_grads(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = torch.as_tensor(np.asarray(w))
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got[name] - w).abs().max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_two_ranks_equal_the_single_process_step(runs):
    want = runs["own"]
    for rank in runs["ranks"]:
        got = rank["own"]
        assert sorted(got["logs"]) == sorted(want["logs"])
        for k, v in want["logs"].items():
            assert abs(got["logs"][k] - v) <= DP_REL * abs(v), (k, got[
                "logs"][k], v)
        _assert_grads(got["grads"], want["grads"])


def test_ranks_hold_bit_identical_parameters(runs):
    a, b = runs["ranks"]
    for step in ("own", "jax"):
        for k, v in a[step]["params"].items():
            assert torch.equal(v, b[step]["params"][k]), (step, k)
        for k, v in a[step]["grads"].items():
            assert torch.equal(v, b[step]["grads"][k]), (step, k)
    # and the step moved them
    before = params_from_jax(load_asset_tree(ASSET))
    assert sum(not torch.equal(a["own"]["params"][k], v)
               for k, v in before.items()) > len(before) // 2


def test_matches_the_jax_mesh_step(runs):
    for rank in runs["ranks"]:
        got = rank["jax"]
        for logs in (runs["jax_logs"], runs["jax_step_logs"]):
            for k in ("loss", "mbpov", "focal_loss", "num_occupied_voxels"):
                want = float(logs[k])
                assert abs(got["logs"][k] - want) <= JAX_REL * abs(want), \
                    (k, got["logs"][k], want)
        _assert_grads(got["grads"], runs["jax_grads"])


def test_rank_zero_alone_writes(runs):
    fit_dir = runs["tmp"] / "fit"
    assert [r["fit"] for r in runs["ranks"]][0] == runs["ranks"][1]["fit"]
    assert (fit_dir / "done").exists()
    assert sorted(p.name for p in fit_dir.glob("ckpt_*")) == ["ckpt_2"]
    lines = (fit_dir / "train_log.jsonl").read_text().splitlines()
    # steps 1 and 2 and one validation, each once (not once a rank)
    assert len(lines) == 3
    for rank in range(WORLD):
        for d in (f"own_{rank}", f"jax_{rank}"):
            assert not list((runs["tmp"] / d).iterdir())  # step_batch only


def test_an_indivisible_batch_raises(runs):
    for rank in runs["ranks"]:
        assert "does not divide" in rank["indivisible"]
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_rows(np.zeros((5, 2)), 0, 2)
    a = np.arange(12).reshape(6, 2)
    assert np.array_equal(np.concatenate(
        [mesh.shard_rows(a, r, 3) for r in range(3)]), a)


@pytest.mark.parametrize("n, multiple", [(5, 2), (6, 3), (1, 4), (8, 8)])
def test_pad_to_multiple_matches_jax(n, multiple):
    a = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got, got_n = mesh.pad_to_multiple(a, multiple)
    want, want_n = jax_mesh.pad_to_multiple(a, multiple)
    assert got_n == want_n and np.array_equal(got, want)


def test_averaged_per_rank_losses_would_differ():
    """The loss and gradient ``DistributedDataParallel`` would take — the
    mean of the ranks' own RD losses, each over its own occupied count —
    against the global batch's: far outside the bounds above."""
    points = torch.from_numpy(_points())
    model = build_model("c3p")
    model.load_state_dict(params_from_jax(load_asset_tree(ASSET)))
    noise = draw_noise(model, BATCH, BLOCK, torch.Generator().manual_seed(3))

    def loss_and_grads(rows, denominators_global):
        model.zero_grad()
        total = 0.0
        n_global = voxelize(points, BLOCK).sum() if denominators_global \
            else None
        for r in rows:
            x = voxelize(points[r], BLOCK)
            out = model(x, training=True,
                        **{k: v[r] for k, v in noise.items()})
            loss, _ = tloss.rd_loss(x, out["x_tilde"],
                                    [out["y_likelihoods"],
                                     out["z_likelihoods"]], 1e-4,
                                    num_occupied=n_global)
            total = total + loss
        if not denominators_global:
            total = total / len(rows)
        total.backward()
        return float(total.detach()), {n: p.grad.clone()
                              for n, p in model.named_parameters()
                              if p.grad is not None}

    halves = [slice(0, BATCH // 2), slice(BATCH // 2, BATCH)]
    whole, g_whole = loss_and_grads([slice(0, BATCH)], False)
    shares, g_shares = loss_and_grads(halves, True)
    mean, g_mean = loss_and_grads(halves, False)
    assert abs(shares - whole) <= DP_REL * abs(whole)
    assert abs(mean - whole) > 1e3 * DP_REL * abs(whole)
    worst = max(float((g_mean[n] - g).abs().max())
                / max(float(g.abs().max()), 1e-30)
                for n, g in g_whole.items())
    assert worst > GRAD_TOL

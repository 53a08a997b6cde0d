"""The dry run (``pcc_geo_cnn_v2_tpu_torch/dryrun.py``) on the CPU.

- ``entry(device="cpu")``'s loss against JAX ``entry()``'s within 1e-5
  relative (``tests/test_torch_train_parity.py``'s bound): JAX's
  parameters carried across with ``weights.params_from_jax`` and JAX's
  noise drawn from the keys its loss splits, passed in NDHWC.
- ``dryrun_multichip(2, device="cpu")``: both legs over two gloo ranks.
- ``spawn_ranks`` fails the run when a rank fails or hangs.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import entry as jax_entry
from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
from pcc_geo_cnn_v2_tpu.ops.voxel import voxelize as jax_voxelize
from pcc_geo_cnn_v2_tpu_torch import dryrun

REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops: one intra-op thread (the tier-1 run has six
    workers on the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_entry_matches_jax_entry():
    fn_j, (params, points, key) = jax_entry()
    want = float(jax.jit(fn_j)(params, points, key))
    params = jax.tree_util.tree_map(np.asarray, params)
    noise = _jax_noise(jax_build("c3p"), params, jax_voxelize(points, 64),
                       key)
    fn, (model, pts, noise_t) = dryrun.entry("cpu", params=params,
                                             noise=noise)
    assert np.array_equal(pts.numpy(), np.asarray(points))
    got = fn(model, pts, noise_t).item()
    assert abs(got - want) <= REL * abs(want), (got, want)


def test_entry_defaults_are_seeded():
    fn, args = dryrun.entry("cpu")
    fn2, args2 = dryrun.entry("cpu")
    a, b = fn(*args).item(), fn2(*args2).item()
    assert np.isfinite(a) and a == b
    assert tuple(args[2]["noise_y"].shape) == (1, 8, 8, 8, 64)
    assert tuple(args[2]["noise_z"].shape) == (1, 4, 4, 4, 64)


def test_dryrun_multichip_two_ranks(capsys):
    ranks = dryrun.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("dryrun_multichip(2): loss=")
    assert out[0].endswith("(gloo on cpu) OK")
    assert out[1] == ("dryrun_multichip(2): sp-sharded encode of a 32^3 "
                      "block over group sp=2 OK")
    assert len({r["digest"] for r in ranks}) == 1
    sp = ranks[0]["sp"]
    assert sorted(sp["mismatch"]) == ["y_sym", "z_sym"]
    assert max(sp["mismatch"].values()) < 5e-4


def _hang(rank):
    time.sleep(600)


def test_a_failing_rank_fails_the_run():
    # rank r exits with code r
    with pytest.raises(RuntimeError, match=r"exit codes \[0, 1\]"):
        dryrun.spawn_ranks(os._exit, 2, timeout_s=120)


def test_a_hanging_rank_fails_the_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] did not "
                       r"finish in 5 s"):
        dryrun.spawn_ranks(_hang, 2, timeout_s=5)
    assert time.monotonic() - t0 < 60


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("this check is about a host without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)

"""The port's trainer on the CPU: data, protocol, checkpoints, export.

- ``BlockDataset.batches`` and ``synthetic_blocks`` equal the JAX
  package's for the same seeds;
- the training protocol on the JAX tests' ``TINY`` model (v2 with V1
  transforms, 8 filters), block 16, batch 4: the loss falls over 30 steps
  and the aux optimizer moves the quantiles; ``fit`` prunes checkpoints
  to ``keep_checkpoints``, writes ``train_log.jsonl`` and the done marker,
  and a rerun on the directory resumes and skips; warm start from a
  training directory and from an asset;
- a resumed ``fit_blocks`` run is bit-equal to an uninterrupted one;
- the validation loss is the RD loss without the aux loss;
- ``save_asset`` re-serialises the committed ``bench_c3p`` asset byte for
  byte and flax reads what it writes;
- ``cli.train --device cpu`` on PLY blocks, then ``cli.compress`` /
  ``cli.decompress`` from the training directory, bit-exact.
"""

import dataclasses
import functools
import gzip
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.utils import data as jdata
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.training import (
    TrainConfig,
    Trainer,
    load_params,
)
from pcc_geo_cnn_v2_tpu_torch.utils import data as tdata
from pcc_geo_cnn_v2_tpu_torch.weights import (
    load_asset_tree,
    params_from_jax,
    params_to_jax,
    save_asset,
)

ASSETS = Path(__file__).resolve().parent.parent / "pcc_geo_cnn_v2_tpu/assets"
TINY = dict(model="v2", num_filters=8, analysis="AnalysisTransformV1",
            synthesis="SynthesisTransformV1")
CFG = TrainConfig(batch_size=4, block_size=16, lmbda=3e-4, max_steps=30,
                  val_every=10, val_batches=2, log_every=10,
                  early_stop_patience=1000)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops: one intra-op thread (the tier-1 run has six
    workers on the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=24, seed=1):
    return tdata.BlockDataset(tdata.synthetic_blocks(n, block_size=16,
                                                     seed=seed),
                              max_points=512)


def _state(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def _equal_states(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- data ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["shell", "plane", "cylinder", "uniform",
                                  "mix"])
def test_synthetic_blocks_equal_jax(kind):
    got = tdata.synthetic_blocks(6, block_size=16, seed=3, kind=kind)
    want = jdata.synthetic_blocks(6, block_size=16, seed=3, kind=kind)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n, shuffle, repeat", [(10, True, True),
                                                (3, True, True),
                                                (10, False, False)])
def test_block_batches_equal_jax(n, shuffle, repeat):
    blocks = jdata.synthetic_blocks(n, block_size=16, seed=5, kind="mix")
    got = tdata.BlockDataset(blocks, max_points=300).batches(
        4, seed=9, repeat=repeat, shuffle=shuffle)
    want = jdata.BlockDataset(blocks, max_points=300).batches(
        4, seed=9, repeat=repeat, shuffle=shuffle)
    for _, g, w in zip(range(7), got, want):
        np.testing.assert_array_equal(g, w)
    assert tdata.train_val_split_by_dir(["a/val/x", "b/y", "c_val/z"]) == \
        jdata.train_val_split_by_dir(["a/val/x", "b/y", "c_val/z"])


# -- the protocol on TINY ------------------------------------------------------


def test_loss_decreases_and_aux_moves_the_quantiles(tmp_path):
    trainer = Trainer(build_model(TINY), CFG, tmp_path / "run", seed=0,
                      device="cpu")
    q0 = trainer.model.entropy_bottleneck.quantiles.detach().clone()
    it = _data().batches(CFG.batch_size, seed=0)
    losses = [float(trainer.step_batch(next(it), step)["loss"])
              for step in range(1, 31)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert not torch.allclose(q0, trainer.model.entropy_bottleneck.quantiles)


def test_fit_protocol_checkpoints_done_marker_and_warm_start(tmp_path):
    ds = _data()
    cfg = CFG
    trainer = Trainer(build_model(TINY), cfg, tmp_path / "run", seed=0,
                      device="cpu")
    best = trainer.fit(ds.batches(cfg.batch_size, seed=2),
                       lambda: ds.batches(cfg.batch_size, seed=3,
                                          repeat=False, shuffle=False))
    run = tmp_path / "run"
    assert best is not None and np.isfinite(best)
    assert (run / "done").exists()
    ckpts = sorted(p.name for p in run.glob("ckpt_*"))
    assert 1 <= len(ckpts) <= 2 and not list(run.glob("*.tmp"))
    log = [json.loads(line) for line in
           (run / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log if r["split"] == "train"] == [1, 10, 20,
                                                                  30]
    assert [r["step"] for r in log if r["split"] == "val"] == [10, 20, 30]
    assert {"loss", "mbpov", "aux_loss", "bc_f1", "steps_per_sec"} <= set(
        log[0])
    # a rerun resumes from the latest checkpoint and skips training
    again = Trainer(build_model(TINY), cfg, run, seed=0, device="cpu")
    assert again.start_step == int(
        Trainer.latest_checkpoint(run).name.split("_")[1]) > 0
    assert again.fit(None, None) is None
    # warm start: params only, step 0, from the directory and from an asset
    warm = Trainer(build_model(TINY), cfg, tmp_path / "run2", seed=1,
                   device="cpu", warm_start=run)
    assert warm.start_step == 0
    _equal_states(_state(warm), _state(again))
    asset = tmp_path / "w.msgpack.gz"
    save_asset(params_to_jax(again.model.state_dict()), asset)
    warm_asset = Trainer(build_model(TINY), cfg, tmp_path / "run3", seed=1,
                         device="cpu", warm_start=asset)
    _equal_states(_state(warm_asset), _state(again))


def test_checkpoints_are_pruned_to_keep_checkpoints(tmp_path):
    trainer = Trainer(build_model(TINY), CFG, tmp_path / "run", seed=0,
                      device="cpu")
    for step in (5, 10, 15, 20):
        trainer.save(step)
    assert sorted(p.name for p in (tmp_path / "run").glob("ckpt_*")) == \
        ["ckpt_15", "ckpt_20"]
    assert Trainer.latest_checkpoint(tmp_path / "run").name == "ckpt_20"


def test_resumed_fit_blocks_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    ds, val = _data(), _data(6, seed=2)
    cfg = dataclasses.replace(CFG, max_steps=10, val_every=5)
    straight = Trainer(build_model(TINY), cfg, tmp_path / "a", seed=4,
                       device="cpu")
    straight.fit_blocks(ds, val)
    first = Trainer(build_model(TINY), dataclasses.replace(cfg, max_steps=5),
                    tmp_path / "b", seed=4, device="cpu")
    first.fit_blocks(ds, val)
    (tmp_path / "b" / "done").unlink()  # as if the run had been cut at 5
    resumed = Trainer(build_model(TINY), cfg, tmp_path / "b", seed=4,
                      device="cpu")
    assert resumed.start_step == 5
    _equal_states(_state(resumed), _state(first))
    for group_a, group_b in zip(resumed.opt.state_dict()["state"].values(),
                                first.opt.state_dict()["state"].values()):
        for key in group_a:
            assert torch.equal(group_a[key], group_b[key]), key
    resumed.fit_blocks(ds, val)
    _equal_states(_state(resumed), _state(straight))


def test_val_loss_excludes_the_aux_loss(tmp_path):
    trainer = Trainer(build_model(TINY), CFG, tmp_path / "run", seed=0,
                      device="cpu")
    val = trainer.device_data(_data(6, seed=2))
    eb = trainer.model.entropy_bottleneck
    with torch.no_grad():  # the quantiles enter the aux loss only
        before, aux_before = (trainer.val_loss_blocks(val, 10),
                              float(eb.aux_loss()))
        eb.quantiles.mul_(3.0)
        after, aux_after = (trainer.val_loss_blocks(val, 10),
                            float(eb.aux_loss()))
    assert abs(aux_after - aux_before) > 10 * abs(before)
    assert before == after
    logs = trainer.eval_batch(val[:4].to(torch.int32), 10, 0)
    assert float(logs["loss"]) == pytest.approx(
        CFG.lmbda * float(logs["focal_loss"]) + float(logs["mbpov"]),
        rel=1e-6)


# -- export ----------------------------------------------------------------------


def test_save_asset_rewrites_the_committed_asset_and_flax_reads_it(tmp_path):
    from pcc_geo_cnn_v2_tpu.cli.common import load_params_asset
    from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build

    src = ASSETS / "bench_c3p.msgpack.gz"
    raw = gzip.decompress(src.read_bytes())
    tree = load_asset_tree(src)
    out = tmp_path / "a.msgpack.gz"
    save_asset(tree, out)
    assert gzip.decompress(out.read_bytes()) == raw
    # through the port's modules and back: the same bytes
    save_asset(params_to_jax(params_from_jax(tree)), out)
    assert gzip.decompress(out.read_bytes()) == raw
    got = load_params_asset(jax_build("c3p"), out)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path])


def test_cli_train_then_compress_and_decompress_from_the_directory(
        tmp_path, monkeypatch):
    from pcc_geo_cnn_v2_tpu_torch.cli import compress, decompress, train
    from pcc_geo_cnn_v2_tpu_torch.utils import pc_io

    # read the PLYs in this process: no fork of a process running threads
    monkeypatch.setattr(pc_io, "load_points", functools.partial(
        pc_io.load_points, processes=0))
    blocks_dir = tmp_path / "blocks"
    blocks_dir.mkdir()
    for i, b in enumerate(tdata.synthetic_blocks(12, block_size=16,
                                                 seed=8, kind="mix")):
        pc_io.write_ply(blocks_dir / f"b{i:02d}.ply", b.astype(np.float32))
    run = tmp_path / "run"
    train.main([str(blocks_dir / "*.ply"), str(run), "--model_config", "c2",
                "--device", "cpu", "--resolution", "16", "--batch_size",
                "4", "--max_steps", "4", "--val_every", "2",
                "--val_batches", "1", "--warm_start",
                str(ASSETS / "rd/c2/2.00e-04.msgpack.gz")])
    assert (run / "done").exists()
    tree = load_params(run)
    state = params_from_jax(tree)
    assert "analysis_t.Conv_0.weight" in state
    cloud = np.unique(np.concatenate([
        b + np.array(o) * 16 for b, o in zip(
            tdata.synthetic_blocks(4, block_size=16, seed=9, kind="mix"),
            [(0, 0, 0), (1, 0, 0), (0, 1, 1), (1, 1, 0)])]), axis=0)
    ply = tmp_path / "in.ply"
    pc_io.write_ply(ply, cloud.astype(np.float32))
    common = ["--checkpoint_dir", str(run), "--model_config", "c2",
              "--device", "cpu", "--batch_blocks", "4"]
    compress.main(["--input_files", str(ply), "--output_files",
                   str(tmp_path / "c.bin"), "--dec_files",
                   str(tmp_path / "enc.ply"), "--resolution", "32",
                   "--octree_level", "1"] + common)
    decompress.main(["--input_files", str(tmp_path / "c.bin"),
                     "--output_files", str(tmp_path / "dec.ply")] + common)
    enc = pc_io.load_points([tmp_path / "enc.ply"])[0]
    dec = pc_io.load_points([tmp_path / "dec.ply"])[0]
    assert len(dec) > 0
    np.testing.assert_array_equal(dec, enc)

"""A tiny round of every driver on the CPU (the kernels' plain versions):
the last line has the contract's shape, a sound run is correct, and a run
whose program answers wrongly is not."""

from __future__ import annotations

import json

import numpy as np
import pytest

from bench_cases import TINY

CELLS = ("c3p.encode.d1", "c2.decode", "c3p.decode", "c3p.train")


def _round(bench_run, capsys, cell, trace, seed=3_000_000_019, hooks=None):
    rc = bench_run.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", "0.5", "--trace", str(trace)],
                        device="cpu", overrides=TINY, hooks=hooks)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_round_has_contract_shape(bench_run, capsys, one_thread, cell,
                                  trace):
    from benchlib import core

    line = _round(bench_run, capsys, cell, trace)
    assert list(line)[-1] == "checked"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    spec = core.load_cell(cell)
    if trace:
        names = {m["name"] for m in spec["per_layer"]}
        assert set(line["metrics"]) <= names
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        names = {m["name"] for m in spec["end_to_end"]}
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    for name, c in line["checked"].items():
        assert c["value"] <= c["limit"], name


def _shift_first_block(blocks):
    blocks = list(blocks)
    blocks[0] = blocks[0] + 1
    return blocks


def _alter_thresholds(data_list):
    return [[(strings, (thr + 7) % 32) for strings, thr in dl]
            for dl in data_list]


@pytest.mark.parametrize("cell,where", [
    ("c3p.encode.d1", "encoder"), ("c3p.decode", "decoder"),
    ("c2.decode", "decoder")])
def test_altered_answer_is_not_correct(bench_run, capsys, one_thread,
                                       monkeypatch, cell, where):
    """An answer altered where the program produces it: the encoder's
    threshold indices, or the decoder's points of one block, changed
    after set-up, inside the timed path."""
    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec

    def broken(run, state):
        if where == "encoder":
            real = BlockCodec.compress_blocks_device_opt

            def compress(self, *a, **k):
                data_list, meta = real(self, *a, **k)
                return _alter_thresholds(data_list), meta

            monkeypatch.setattr(BlockCodec, "compress_blocks_device_opt",
                                compress)
        else:
            real = BlockCodec.decompress_blocks
            monkeypatch.setattr(
                BlockCodec, "decompress_blocks",
                lambda self, *a, **k: _shift_first_block(real(self, *a, **k)))

    line = _round(bench_run, capsys, cell, 0, hooks={"prepared": broken})
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checked"].values())


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_training_fault_is_not_correct(bench_run, capsys, one_thread,
                                       fault):
    """A training step that leaves out half of its batch, or returns its
    state unchanged, planted in the program for the whole run."""
    from benchlib import core

    undo = core.load_module("drivers", "train").FAULTS[fault]()
    try:
        line = _round(bench_run, capsys, "c3p.train", 0)
    finally:
        undo()
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checked"].values())


@pytest.mark.parametrize("fault", ["k2_half", "hyper_scale"])
def test_encode_fault_is_not_correct(bench_run, capsys, one_thread, fault):
    """K2's full-cloud D1 sums over half of the blocks, or the hyper
    synthesis's scales altered in the model that encoder and decoder
    share, planted in the program for the whole run: the streams still
    decode to the encoder's points, and the check reads the fault."""
    from benchlib import core

    undo = core.load_module("drivers", "encode").FAULTS[fault]()
    try:
        line = _round(bench_run, capsys, "c3p.encode.d1", 0)
    finally:
        undo()
    assert line["correct"] is False
    checked = line["checked"]
    assert checked["pts_mismatch"]["value"] <= checked["pts_mismatch"][
        "limit"]
    name = {"k2_half": "psnr_gap_db", "hyper_scale": "idx_mismatch"}[fault]
    assert checked[name]["value"] > checked[name]["limit"]

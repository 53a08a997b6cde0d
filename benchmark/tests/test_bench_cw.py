"""A tiny round of ``c3p_cw.decode`` on the CPU (the kernels' plain
versions): the last line has the contract's shape, a sound run is
correct, and each of the driver's planted faults is not; the cell's
readers and its conv count."""

from __future__ import annotations

import json

import numpy as np
import pytest

from bench_cases import TINY

CELL = "c3p_cw.decode"


def _round(bench_run, capsys, trace, seed=3_000_000_021):
    rc = bench_run.main(["--workload", CELL, "--seed", str(seed),
                         "--seconds", "0.5", "--trace", str(trace)],
                        device="cpu", overrides=TINY)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_cw_round_is_correct(bench_run, capsys, one_thread, trace):
    from benchlib import core

    line = _round(bench_run, capsys, trace)
    assert list(line)[-1] == "checked"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checked"]) == {"pts_mismatch", "idx_mismatch"}
    spec = core.load_cell(CELL)
    if trace:
        # the CPU trace has no convolution kernels on a device timeline
        assert {"slice_ms.decode", "slice_rans_ms.decode"} <= set(
            line["metrics"]) <= {m["name"] for m in spec["per_layer"]}
        assert line["metrics"]["slice_ms.decode"]["value"] >= line[
            "metrics"]["slice_rans_ms.decode"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"decode_rate", "setup_s"}
    for m in line["metrics"].values():
        assert np.isfinite(m["value"])


@pytest.mark.parametrize("fault", ["lrp_off", "support_last",
                                   "sigma_scale"])
def test_cw_fault_is_not_correct(bench_run, capsys, one_thread, fault):
    """Each fault planted in the model that encoder and decoder share, for
    the whole run: the streams still decode, and the check reads it."""
    from benchlib import core

    undo = core.load_module("drivers", "decode_cw").FAULTS[fault]()
    try:
        line = _round(bench_run, capsys, 0)
    finally:
        undo()
    assert line["correct"] is False and line["failed"] == 0
    checked = line["checked"]
    over = {k for k, c in checked.items() if c["value"] > c["limit"]}
    if fault == "lrp_off":
        assert "pts_mismatch" in over
    elif fault == "support_last":
        assert over
    else:
        assert checked["idx_mismatch"]["value"] > 0.99
        assert "pts_mismatch" not in over


def test_cw_conv_count_by_hand():
    from benchlib import workcount, workcount_cw

    cfg = json.loads((core_dir() / "configs/c3p_cw.json").read_text())
    extra = workcount_cw.pass_work(cfg, "decode")[0] - workcount.pass_work(
        cfg, "decode")[0]
    # 8³ latent voxels, k3: Σ over the 8 slices of the mean, scale and
    # residual nets (Cin = 64 + 8·min(k, 4), + 8 for the residual), and
    # the second hyper synthesis (4³ → 4³, 4³ → 8³ on input voxels, 8³)
    nets = sum(c0 * 48 + 48 * 32 + 32 * 8 for k in range(8)
               for c0 in [64 + 8 * min(k, 4)] * 2 + [72 + 8 * min(k, 4)])
    hyper = 2 * 27 * 64 * 64 * (64 + 64 + 512)
    assert extra == 2 * 27 * 512 * nets + hyper
    assert len(workcount_cw.layers(cfg)) == 26 + 3 + 72


def core_dir():
    from benchlib import core

    return core.BENCH_DIR


def test_cw_readers_read_the_cw_records_alone():
    from benchlib import core

    rec = ("decompress_blocks_cw(3 blocks): ...",
           (3, 0.1, 0.2, 0.01, 0.02, 0.03, 0.4, 0.05), 0.0)
    plain = ("decompress_blocks(3 blocks): ...",
             (3, 0.1, 0.2, 0.3, 0.4, 0.05), 0.0)
    ctx = {"kind": "decode", "log": [rec, rec, plain],
           "work": {"requests": 2}}
    slices = core.load_module("metrics", "slice_ms.decode").read(ctx)
    rans = core.load_module("metrics", "slice_rans_ms.decode").read(ctx)
    assert slices == pytest.approx(60.0) and rans == pytest.approx(20.0)
    ctx["log"] = [plain]
    assert core.load_module("metrics", "slice_ms.decode").read(ctx) is None

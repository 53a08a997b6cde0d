"""The control on the card: the plain reference with TF32 convolutions put
in the program's place fails every cell's check, and the program on the
same seed passes it (one seed, a short window at the cell's own load)."""

from __future__ import annotations

import json

import pytest

CELLS = ("c3p.encode.d1", "c2.decode", "c3p.decode", "c3p.train")


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes(card, capsys, cell):
    import importlib.util

    from benchlib import core

    spec = importlib.util.spec_from_file_location(
        "bench_control", core.BENCH_DIR / "control.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seed = 2_147_485_021
    assert mod.main(["--workload", cell, "--seconds", "4", "--seeds",
                     str(seed), "--control-seeds", str(seed)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = core.load_cell(cell)["limits"]
    assert all(summary["lower"][k] <= lim for k, lim in limits.items())
    # the control has no PSNR of its own, so not every number has a reading
    assert any(v > limits[k] for k, v in summary["upper"].items())

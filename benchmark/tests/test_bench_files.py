"""Every configuration, mix, driver, metric and limit file is found by the
name ``BENCHMARK.json`` gives it, and a new cell and a new metric come in
as new files alone."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in SPEC["end_to_end"] + SPEC["per_layer"]}
               ) == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    from benchlib import core

    spec = core.load_cell(cell)
    w = spec["workload"]
    conf = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert (ROOT / conf["file"]).is_file()
    assert (ROOT / spec["config"]["weights"]).is_file()
    assert spec["limits"], "every cell has its correctness limits"
    assert core.load_module("drivers", spec["mix"]["driver"]).KIND
    for m in spec["per_layer"]:
        assert callable(core.load_module("metrics", m["name"]).read)
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]


def test_every_file_is_named_by_the_benchmark():
    used = {("configs", c["file"].split("/")[-1][:-5])
            for c in SPEC["configs"]}
    used |= {("traffic", w["traffic"]) for w in SPEC["workloads"]}
    used |= {("limits", w["name"]) for w in SPEC["workloads"]}
    used |= {("metrics", m["name"]) for m in SPEC["per_layer"]}
    for kind in ("configs", "traffic", "limits", "metrics"):
        for f in (BENCH / kind).iterdir():
            if f.suffix in (".json", ".py"):
                assert (kind, f.name[:-len(f.suffix)]) in used, f


def test_new_cell_and_metric_by_new_files_alone(tmp_path):
    """A copy of the harness gains a traffic mix, a metric, limits and
    their entries; nothing that was there is edited."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    mix = json.loads((BENCH / "traffic/decode.json").read_text())
    mix["clients"] = 1
    (tmp_path / "benchmark/traffic/decode.serial.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark/limits/c3p.decode.serial.json").write_text(
        (BENCH / "limits/c3p.decode.json").read_text())
    (tmp_path / "benchmark/metrics/requests.decode.py").write_text(
        "def read(ctx):\n    return float(ctx['work']['requests'])\n")
    spec["workloads"].append({"name": "c3p.decode.serial", "config": "c3p",
                              "traffic": "decode.serial", "chips": 1,
                              "why": "one client"})
    spec["per_layer"].append({"name": "requests.decode", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "codec", "moves": "decode_rate",
                              "workloads": ["c3p.decode.serial"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys; sys.path.insert(0, 'benchmark')\n"
        "from benchlib import core\n"
        "c = core.load_cell('c3p.decode.serial')\n"
        "assert c['mix']['clients'] == 1 and c['limits']\n"
        "names = [m['name'] for m in c['per_layer']]\n"
        "assert 'requests.decode' in names, names\n"
        "r = core.load_module('metrics', 'requests.decode')\n"
        "print(r.read({'work': {'requests': 7}}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "7.0"

"""No process of the benchmark loads JAX or the JAX package, compared by
whole top-level names, and the reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pcc_geo_cnn_v2_tpu"}


def _top_levels(code):
    out = subprocess.run(
        [sys.executable, "-c", "import sys, json\n" + code +
         "\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_levels(
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('r', 'benchmark/run.py')\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "from benchlib import core, codec_cells\n"
        "import json as j\n"
        "b = j.load(open('BENCHMARK.json'))\n"
        "for w in b['workloads']:\n"
        "    c = core.load_cell(w['name'])\n"
        "    core.load_module('drivers', c['mix']['driver'])\n"
        "for m in b['per_layer']:\n"
        "    core.load_module('metrics', m['name'])\n"
        "import pcc_geo_cnn_v2_tpu_torch.codec, pcc_geo_cnn_v2_tpu_torch.models.configs\n"
        "import pcc_geo_cnn_v2_tpu_torch.utils.octree, pcc_geo_cnn_v2_tpu_torch.coding.syntax\n"
        "import reference.model, reference.judge\n"
        "import control\n")
    assert "pcc_geo_cnn_v2_tpu_torch" in names  # the program is loaded
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_levels("sys.path.insert(0, 'benchmark')\n"
                        "import reference.model, reference.judge\n")
    assert not names & (FORBIDDEN | {"pcc_geo_cnn_v2_tpu_torch"})


def test_forbidden_names_compared_whole():
    sys.path.insert(0, str(BENCH))
    from benchlib.core import forbidden_loaded

    assert forbidden_loaded(["pcc_geo_cnn_v2_tpu_torch.codec", "numpy",
                             "jaxtyping"]) == []
    assert forbidden_loaded(["pcc_geo_cnn_v2_tpu.codec", "jax.numpy",
                             "optax"]) == ["jax.numpy", "optax",
                                           "pcc_geo_cnn_v2_tpu.codec"]

"""Tests of the benchmark harness. Run them with

    python -m pytest benchmark/tests -q

Tests marked ``chip`` need a CUDA card and skip without one; on the card
run ``python -m pytest benchmark/tests -q -m chip``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, never at
    import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def one_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def bench_run():
    """``run.py``'s ``main`` as a function."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_run_main",
                                                  BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

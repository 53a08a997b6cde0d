"""The benchmark's per-layer readers of the codec's log records
(``benchmark/metrics/{entropy_ms,select_ms,sweep_rerun_share}.encode.py``)
on hand-made traced-run contexts: each returns its definition's value,
and None in another kind of cell or with nothing to read."""

import importlib.util
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent / "benchmark"


def _reader(name):
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location(
        f"reader_{name.replace('.', '_')}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _encode(blocks, device, entropy, select):
    return (f"compress_blocks_device_opt({blocks} blocks): device "
            f"{device:.2f}s, entropy {entropy:.2f}s, select {select:.2f}s",
            (blocks, device, entropy, select), 0.0)


def _overflow(blocks):
    return (f"bucket sweep overflow: re-sweeping {blocks} block(s) at "
            "K = B³", (blocks,), 0.0)


def _decode():
    return ("decompress_blocks(300 blocks): ...",
            (300, 0.1, 0.01, 0.2, 0.3, 0.02), 0.0)


def _ctx(kind, log, requests):
    return {"kind": kind, "log": log,
            "work": {"requests": requests, "blocks": 0, "points": 0}}


# three clouds completed: 300, 250 and 200 blocks, 4 + 2 blocks re-swept
LOG = [_encode(300, 0.5, 0.25, 0.125), _overflow(4), _overflow(2),
       _encode(250, 0.4, 0.2, 0.1), _encode(200, 0.3, 0.15, 0.075),
       _decode()]


@pytest.mark.parametrize("name, value", [
    ("entropy_ms.encode", 1e3 * (0.25 + 0.2 + 0.15) / 3),
    ("select_ms.encode", 1e3 * (0.125 + 0.1 + 0.075) / 3),
    ("sweep_rerun_share.encode", 100.0 * 6 / 750)])
def test_reader_gives_its_definition(name, value):
    assert _reader(name)(_ctx("encode", LOG, 3)) == pytest.approx(value)


@pytest.mark.parametrize("name", ["entropy_ms.encode", "select_ms.encode",
                                  "sweep_rerun_share.encode"])
def test_reader_finds_nothing(name):
    read = _reader(name)
    assert read(_ctx("decode", LOG, 3)) is None
    assert read(_ctx("train", [], 3)) is None
    assert read(_ctx("encode", [_decode()], 3)) is None
    assert read(_ctx("encode", [], 0)) is None


def test_no_overflow_reads_zero():
    read = _reader("sweep_rerun_share.encode")
    assert read(_ctx("encode", [_encode(300, 0.5, 0.25, 0.125)], 1)) == 0.0

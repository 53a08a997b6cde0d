"""``tools/torch_trace_spans.py`` on a tiny encode cell on the CPU, every
thread profiled: both clients' ``pcc.`` ranges reach the dump; and its
kernel attribution on hand-made events: a kernel belongs to the innermost
range of the thread that launched it. In a subprocess: the benchmark
refuses to run in a process that holds JAX."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent.parent


def test_tool_dumps_the_port_ranges_of_a_traced_run(tmp_path):
    out = tmp_path / "report.json"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "tools/torch_trace_spans.py", str(out),
         "--all-threads", "--cpu", "--", "--workload", "c3p.encode.d1",
         "--seed", "3000000019", "--seconds", "0.5", "--trace", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    report = json.loads(out.read_text())
    w0, w1 = report["window_s"]
    ranges = report["ranges"]
    for name in ("octree.partition", "codec.encode", "codec.entropy_encode",
                 "codec.select", "transforms.conv_transpose"):
        assert any(r[0] == name for r in ranges), name
    # two clients, each on its own thread, and every range in the window
    assert len({r[1] for r in ranges if r[0] == "codec.encode"}) == 2
    assert all(w0 <= r[2] < r[3] <= w1 for r in ranges)
    assert report["annotations"] == []  # no device on the CPU


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_trace_spans", ROOT / "tools/torch_trace_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _event(name, start, end, children=(), kernels=(), thread=1,
           device=DeviceType.CPU):
    return SimpleNamespace(
        name=name, device_type=device, thread=thread,
        time_range=SimpleNamespace(start=start, end=end),
        cpu_children=list(children),
        kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels])


def test_kernels_go_to_the_innermost_range_of_their_thread():
    """An op inside ``codec.decode_y`` inside ``codec.decode``: its kernel
    is the inner range's alone; the outer range keeps its own op's kernel,
    not its annotation; a range outside the window is left out and one
    across its edge is clipped (µs in, s out)."""
    tool = _tool()
    conv = _event("aten::conv3d", 30, 40, kernels=[("implicit_gemm", 7)])
    copy = _event("aten::copy_", 12, 14,
                  kernels=[("Memcpy HtoD", 2), ("pcc.codec.decode", 90)])
    inner = _event("pcc.codec.decode_y", 20, 50, children=[conv])
    outer = _event("pcc.codec.decode", 10, 60, children=[copy, inner])
    early = _event("pcc.octree.partition", 0, 5, thread=2)
    note = _event("pcc.codec.decode", 11, 61, device=DeviceType.CUDA)
    family = {"implicit_gemm": "conv", "Memcpy HtoD": "copy"}.get
    got = tool.program_ranges([early, outer, inner, conv, copy, note],
                              8, 55, family)
    assert got == [("codec.decode", 1, 10e-6, 55e-6, {"copy": 2e-6}),
                   ("codec.decode_y", 1, 20e-6, 50e-6, {"conv": 7e-6})]

#!/usr/bin/env python3
"""One traced run of a benchmark cell, with the port's ``pcc.`` ranges
dumped raw.

    python3 tools/torch_trace_spans.py OUT.json [--all-threads] -- \\
        --workload <cell> --seed <n> --seconds <s> --trace 1

Runs ``benchmark/run.py`` as the benchmark does (its result line is
printed as usual) and writes OUT.json: the traced window, each host
``pcc.`` range (``utils/trace.span``) that overlaps it (name, thread,
start and end in s on the profiler's clock, clipped to the window, and
the device seconds by kernel family of the kernels launched inside it,
walked through ``cpu_children`` and stopping at nested ``pcc.`` ranges,
so a kernel belongs to the innermost range open on the thread that
launched it; kernels launched from C with no aten op around them, K1
and K2, carry no such link), and the device-side annotations of those
ranges (name, start, end), which are not device work.

The benchmark's profiler records only the thread that starts it, so the
clients' ranges reach its trace only with ``--all-threads``
(``profile_all_threads``). A measurement tool beside the benchmark, not
part of it: run it from the root of a checkout, on a CUDA card
(``--cpu`` rehearses a tiny cell on the CPU).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path.cwd()
PREFIX = "pcc."


def program_ranges(events, w0, w1, family):
    """[(name, thread, start s, end s, {family: device s})] of the host
    ``pcc.`` ranges that overlap the window [w0, w1] (µs), clipped to
    it."""
    from torch.autograd import DeviceType

    out = []
    for e in events:
        if e.device_type == DeviceType.CUDA or not e.name.startswith(PREFIX):
            continue
        lo, hi = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if hi <= lo:
            continue
        fams, stack = {}, list(e.cpu_children)
        while stack:
            c = stack.pop()
            if c.name.startswith(PREFIX):
                continue
            for k in c.kernels:
                if not k.name.startswith(PREFIX):
                    f = family(k.name)
                    fams[f] = fams.get(f, 0.0) + k.duration / 1e6
            stack.extend(c.cpu_children)
        out.append((e.name[len(PREFIX):], e.thread, lo / 1e6, hi / 1e6,
                    fams))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cut = argv.index("--")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--all-threads", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse a tiny cell on the CPU")
    args = ap.parse_args(argv[:cut])
    sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]
    import torch.profiler
    from torch.autograd import DeviceType

    spec = importlib.util.spec_from_file_location("bench_run",
                                                  ROOT / "benchmark/run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    real_profile, profs = torch.profiler.profile, []

    def profile(*a, **k):
        if args.all_threads:
            from torch._C._profiler import _ExperimentalConfig

            k["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        profs.append(real_profile(*a, **k))
        return profs[-1]

    torch.profiler.profile = profile
    try:
        if args.cpu:
            sys.path.insert(0, str(ROOT / "benchmark/tests"))
            from bench_cases import TINY

            rc = run.main(argv[cut + 1:], device="cpu", overrides=TINY)
        else:
            rc = run.main(argv[cut + 1:])
    finally:
        torch.profiler.profile = real_profile
    report = {"all_threads": args.all_threads, "argv": argv[cut + 1:]}
    if profs:
        events = profs[-1].events()
        win = [e for e in events if e.name == run.bench_trace.WINDOW_SPAN
               and e.device_type != DeviceType.CUDA][0]
        w0, w1 = win.time_range.start, win.time_range.end
        report["window_s"] = [w0 / 1e6, w1 / 1e6]
        report["ranges"] = program_ranges(events, w0, w1,
                                          run.bench_trace.family)
        report["annotations"] = [
            (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            for e in events if e.device_type == DeviceType.CUDA
            and e.name.startswith(PREFIX)]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())

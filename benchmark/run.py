"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads, warms up, measures for ``--seconds`` (the requests in flight then
finish inside the window), checks a sample of the window's answers against
the plain reference, and prints one JSON line as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checked``: each compared number with its limit (also the last lines of
standard error). It exits non-zero and prints no result without a CUDA
card, or with a module of JAX or of the JAX package loaded.

The cell's files are found by name: see ``benchmark/README.md``.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from benchlib import core, workcount  # noqa: E402
from benchlib import tracing as bench_trace  # noqa: E402


def process_start():
    """Wall time at which this process started (its start in clock ticks
    after boot, against the uptime), or the first line's time."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def card_info(fields="name,power.limit"):
    """``fields`` of card 0 as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "nvidia-smi gave nothing"


def host_load():
    """(process CPU seconds, involuntary context switches, 1-minute load
    average, the machine's busy and stolen CPU ticks) now: the host's
    share of a window's noise. Stolen ticks are those the hypervisor gave
    to another machine on the same cores."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        load = float(Path("/proc/loadavg").read_text().split()[0])
        cpu = [int(v) for v in
               Path("/proc/stat").read_text().split("\n")[0].split()[1:]]
        busy = sum(cpu) - cpu[3] - cpu[4]
        steal = cpu[7] if len(cpu) > 7 else 0
    except (OSError, ValueError, IndexError):
        load, busy, steal = float("nan"), 0, 0
    return ru.ru_utime + ru.ru_stime, ru.ru_nivcsw, load, busy, steal


def per_layer(cell, ctx):
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell["per_layer"]:
        value = core.load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, device="cuda", overrides=None, hooks=None):
    """One run; returns the exit code. ``device``, ``overrides`` and
    ``hooks`` serve the harness's own tests (the CPU, tiny clouds, a
    broken program); the command line takes none of them."""
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = core.load_cell(args.workload)
    chips = cell["workload"]["chips"]

    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s); torch sees {have}",
              file=sys.stderr)
        return 3
    run = core.Run(cell, args.seed, args.seconds, bool(args.trace), device,
                   overrides)
    if device == "cuda":
        torch.cuda.set_device(0)
        run.log(f"card: {card_info()}; peaks f32 "
                f"{workcount.PEAK_FLOPS / 1e12:g} TFLOP/s, HBM "
                f"{workcount.PEAK_BYTES / 1e12:g} TB/s (H100 SXM data sheet)")
    torch.manual_seed(run.seed)
    driver = core.load_module("drivers", run.mix["driver"])
    run.capture_program_log(run.mix.get("program_logs", []))
    state = driver.prepare(run)
    if hooks and "prepared" in hooks:
        hooks["prepared"](run, state)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start
    run.log(f"setup {setup_s:.3f} s; window of {run.seconds:g} s")

    prof = None
    if run.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    host0 = host_load()
    run.log_capture.on = True
    try:
        with (torch.profiler.record_function(bench_trace.WINDOW_SPAN)
              if run.trace else contextlib.nullcontext()):
            host_t0 = time.perf_counter()
            result = driver.measure(run, state)
            host_window = (host_t0, time.perf_counter())
    finally:
        run.log_capture.on = False
        if prof is not None:
            prof.__exit__(None, None, None)
    host1 = host_load()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    records = result["records"]
    failed = sum("error" in r for r in records)
    run.log(f"window {result['window_s']:.3f} s, {len(records)} requests, "
            f"{failed} failed")
    run.log(f"host in the window: process CPU {host1[0] - host0[0]:.3f} s "
            f"on {os.cpu_count()} cores, {host1[1] - host0[1]} involuntary "
            f"context switches, load average {host0[2]:.2f} before and "
            f"{host1[2]:.2f} after; the machine: {host1[3] - host0[3]} busy "
            f"and {host1[4] - host0[4]} stolen CPU ticks of "
            f"{os.sysconf('SC_CLK_TCK')} a second")
    if device == "cuda":
        run.log("card after the window (SM clock, temperature, power, "
                "clock event reasons): " + card_info(
                    "clocks.sm,temperature.gpu,power.draw,"
                    "clocks_event_reasons.active"))
    red = (bench_trace.reduce(prof, run.spans, host_window)
           if prof is not None else None)
    prof = None

    driver.collect(run, state, result)
    driver.release(run, state)
    numbers = driver.judge(run, state, result)
    bad = core.forbidden_loaded()
    if bad:
        print(f"modules of JAX or of the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 4

    checked = [(k, numbers[k], run.limits[k]) for k in sorted(numbers)
               if k in run.limits]
    correct = (failed == 0 and len(checked) == len(numbers) > 0
               and all(v <= lim for _, v, lim in checked))
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device), "count": chips,
           "memory_peak_bytes": int(peak)}
    breakdown = None
    if red is None:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in result["metrics"].items()
                   if any(m["name"] == k for m in cell["end_to_end"])}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        ctx = {"kind": driver.KIND, "config": run.config, "mix": run.mix,
               "work": result["work"], "trace": red,
               "log": run.log_capture.records}
        metrics = per_layer(cell, ctx)
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = red["window_s"]
        breakdown = {"device_ops": red["device_ops"],
                     "idle_gaps": red["idle_gaps"]}
    for k, v in numbers.items():
        lim = run.limits.get(k)
        run.log(f"check {k}: {v!r} (limit {lim!r})")
    print(core.result_line(correct, len(records), failed, metrics, dev,
                           checked, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

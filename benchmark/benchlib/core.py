"""The harness's core: finding a cell's files by name, the run's context
(seed, spans, log capture, cache directories), the closed loop of clients
that makes a measured window, the check of loaded modules, and the result
line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``); the
mix names its driver (``drivers/<driver>.py``); each per-layer metric is a
reader ``metrics/<metric>.py``; a cell's correctness limits are
``limits/<cell>.json``. Nothing here knows a cell, a mix or a metric by
name.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import logging
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

__all__ = ["BENCH_DIR", "ROOT", "CACHE", "FORBIDDEN", "forbidden_loaded",
           "load_cell", "load_module", "Run", "closed_loop", "client_pool",
           "result_line"]

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
# every cache of a run, inside the checkout at a fixed path
CACHE = ROOT / ".bench_cache"
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pcc_geo_cnn_v2_tpu")


def forbidden_loaded(modules=None):
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``pcc_geo_cnn_v2_tpu_torch`` is not ``pcc_geo_cnn_v2_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name):
    """A cell's entry, configuration, mix and limits, and the per-layer
    metrics that list it: dict(workload, config, mix, limits, per_layer,
    end_to_end)."""
    bench = _read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[name]
    config = _read_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    mix = _read_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    limits_file = BENCH_DIR / "limits" / f"{name}.json"
    limits = _read_json(limits_file) if limits_file.exists() else {}

    def listed(metric):
        return name in metric.get("workloads", [name])

    return {"workload": cell, "config": config, "mix": mix,
            "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
            "per_layer": [m for m in bench["per_layer"] if listed(m)]}


def load_module(kind, name):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Capture(logging.Handler):
    """Keeps the program's log records of the measured window (their raw
    arguments, at full precision) without printing them."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []
        self.lock_records = threading.Lock()
        self.on = False

    def emit(self, record):
        if self.on:
            with self.lock_records:
                self.records.append((record.getMessage(), record.args,
                                     record.created))


class Run:
    """One run of one cell: its seed, device, the traced flag, the
    benchmark's host spans around its calls into the program (while
    tracing) and the program's captured log."""

    def __init__(self, cell, seed, seconds, trace, device="cuda",
                 overrides=None):
        self.cell = cell
        self.config = dict(cell["config"], **(overrides or {}).get(
            "config", {}))
        self.mix = dict(cell["mix"], **(overrides or {}).get("mix", {}))
        self.limits = cell["limits"]
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = device
        self.rng = np.random.default_rng(self.seed)
        self.log_capture = _Capture()
        self.cache_dir = CACHE
        self.spans = []
        self._spans_lock = threading.Lock()

    @contextlib.contextmanager
    def _timed(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._spans_lock:
                self.spans.append((name, threading.get_ident(), t0,
                                   time.perf_counter()))

    def span(self, name):
        """A host span of the traced run: (name, thread, start, end) on
        the host's ``perf_counter``; nothing when not tracing."""
        return self._timed(name) if self.trace else contextlib.nullcontext()

    def log(self, *parts):
        print(*parts, file=sys.stderr, flush=True)

    def capture_program_log(self, logger_names):
        for n in logger_names:
            lg = logging.getLogger(n)
            lg.setLevel(logging.INFO)
            lg.propagate = False
            lg.addHandler(self.log_capture)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(pool, clients, items, fn, deadline, device):
    """Clients that each send their next request when their last one is
    done: request i serves ``items[i % len(items)]`` (a shared counter, so
    the order is fixed, the client that takes it is not). A client stops
    taking requests at ``deadline`` (``time.perf_counter`` seconds; None:
    after one pass over ``items``) and finishes the one it holds. Each
    client thread runs under a CUDA stream of its own, made once (its
    fetches then wait for its own work only).

    :return: list of dict(i, item, t0, t1, out) or dict(..., error).
    """
    import torch

    lock = threading.Lock()
    counter = [0]
    stop_at = len(items) if deadline is None else None
    records = []
    local = pool.streams

    def client():
        if torch.device(device).type == "cuda" and not hasattr(local,
                                                               "stream"):
            local.stream = torch.cuda.Stream(device)
        ctx = (torch.cuda.stream(local.stream) if hasattr(local, "stream")
               else contextlib.nullcontext())
        mine = []
        with ctx:
            while True:
                with lock:
                    i = counter[0]
                    if (stop_at is not None and i >= stop_at) or (
                            deadline is not None
                            and time.perf_counter() >= deadline):
                        break
                    counter[0] += 1
                item = i % len(items)
                t0 = time.perf_counter()
                try:
                    out = fn(items[item])
                    _sync_stream(device)
                    mine.append({"i": i, "item": item, "t0": t0,
                                 "t1": time.perf_counter(), "out": out})
                except Exception as exc:  # a failed request is counted
                    import traceback

                    traceback.print_exc()
                    mine.append({"i": i, "item": item, "t0": t0,
                                 "t1": time.perf_counter(),
                                 "error": repr(exc)})
        return mine

    futures = [pool.submit(client) for _ in range(clients)]
    for fut in futures:
        records.extend(fut.result())
    _sync(device)
    return sorted(records, key=lambda r: r["i"])


def _sync_stream(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def client_pool(clients):
    """The client threads of a run: one pool for warm-up and window, so
    that the window's threads have made their streams and handles
    (``streams``: each thread's own CUDA stream)."""
    pool = ThreadPoolExecutor(clients, thread_name_prefix="client")
    pool.streams = threading.local()
    return pool


def result_line(correct, attempted, failed, metrics, device, checked,
                breakdown=None):
    """The contract's last line: ``checked`` ([(name, value, limit)]) goes
    last, under its own key."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in checked}
    return json.dumps(out)


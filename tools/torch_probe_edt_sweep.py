#!/usr/bin/env python3
"""Where K5's time goes, CTA by CTA, and what its constants are worth.

    python3 tools/torch_probe_edt_sweep.py [--variants instr lane16 ...]
        [--chunks 0 1 4] [--reps 5]

Rebuilds ``csrc/edt_sweep.cu`` with one change at a time (a text
substitution; the tool stops if the source no longer has the text) into
its own library, runs the flagship cloud's path-B K5 calls
(``tools/torch_bench_edt_sweep.py``'s ``cloud_calls``) through each, and
checks every variant's outputs equal the unchanged kernel's:

- ``instr``: per pass-3 CTA, its duration and its mask build's (the
  card's ``globaltimer``), the warp searches and their 32-entry steps, and
  the size of its brute-force list; printed for each chunk of
  ``--chunks``: the spread of CTA durations and the longest CTAs;
- the others time every chunk of the cloud (median of bursts of four,
  as the bench tool) beside the unchanged kernel, each with one constant
  set to another value: ``threads<N>`` (threads a pass-3 CTA),
  ``brute<N>`` (voxels of a brute-force list), ``lane<N>`` (spiral
  entries a lane takes alone).

Needs a CUDA device; exits non-zero without one or when a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke as cs  # noqa: E402  (the timer)
import torch_bench_edt_sweep as bench  # noqa: E402  (the cloud's calls)

# per-CTA records: [0] block | t << 16 | m << 32, [1] ns, [2] mask ns,
# [3] warp searches, [4] warp steps, [5] brute list size
INSTR_DECL = """__device__ unsigned long long k5_rec[1 << 16][6];
__device__ __forceinline__ unsigned long long k5_now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
"""
INSTR = [
    ("typedef unsigned long long u64;\n",
     "typedef unsigned long long u64;\n" + INSTR_DECL),
    ("    const int n = it & 0xffff, t = it >> 16;\n",
     "    const int n = it & 0xffff, t = it >> 16;\n"
     "    const unsigned long long t_beg = k5_now();\n"),
    ("    __syncthreads();\n    const int nc = n_cand;",
     "    __syncthreads();\n    if (threadIdx.x == 0)"
     " k5_rec[blockIdx.x][2] = k5_now() - t_beg;\n"
     "    const int nc = n_cand;"),
    ("                const int src = __ffs(u) - 1;\n",
     "                const int src = __ffs(u) - 1;\n"
     "                if (lane == 0)"
     " atomicAdd(&k5_rec[blockIdx.x][3], 1ull);\n"),
    ("    for (int base = e; base < n_entries; base += 32) {\n",
     "    for (int base = e; base < n_entries; base += 32) {\n"
     "        if (lane == 0) atomicAdd(&k5_rec[blockIdx.x][4], 1ull);\n"),
    ("        ab[(int64_t)n * T + t] = __ull2float_rn(s);\n    }\n}",
     "        ab[(int64_t)n * T + t] = __ull2float_rn(s);\n"
     "        k5_rec[blockIdx.x][0] = n | ((u64)t << 16) | ((u64)m << 32);"
     "\n        k5_rec[blockIdx.x][1] = k5_now() - t_beg;\n"
     "        k5_rec[blockIdx.x][5] = brute ? nc : 0;\n    }\n}"),
    ('}  // extern "C"',
     "int pcc_k5_records(void* host, int count) {\n"
     "    cudaDeviceSynchronize();\n"
     "    return (int)cudaMemcpyFromSymbol(host, k5_rec,"
     " (size_t)count * 48);\n}\n"
     "int pcc_k5_records_zero() {\n    void* p;\n"
     "    cudaGetSymbolAddress(&p, k5_rec);\n"
     "    return (int)cudaMemset(p, 0, sizeof(k5_rec));\n}\n"
     '}  // extern "C"'),
]
# the constants a variant sets, and the values tried
CONSTANTS = {"threads": ("AB_THREADS", (256, 512)),
             "brute": ("BRUTE_MAX", (1024, 2048, 4096)),
             "lane": ("LANE_ENTRIES", (4, 8, 16, 32))}


def variants(src):
    """{name: [(old text, new text)]}: ``instr`` and, for each constant,
    every value of ``CONSTANTS`` but the source's own."""
    out = {"instr": INSTR}
    for short, (name, values) in CONSTANTS.items():
        now = int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
        for v in values:
            if v != now:
                out[f"{short}{v}"] = [(f"constexpr int {name} = {now};",
                                       f"constexpr int {name} = {v};")]
    return out


def build(names):
    """{variant: ctypes handle}, each built from the edited source."""
    from pcc_geo_cnn_v2_tpu_torch import native
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    src = (kernels.CSRC / "edt_sweep.cu").read_text()
    edits = variants(src)
    jobs = {}
    for v in names:
        text = src
        for old, new in edits[v]:
            if text.count(old) != 1:
                raise SystemExit(f"{v}: the source no longer has {old!r}")
            text = text.replace(old, new)
        path = native.BUILD_DIR / f"k5_probe_{v}.cu"
        native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        jobs[f"k5_probe_{v}"] = (path, kernels._nvcc_cmd)
    native.build(jobs, force=True)
    libs = {}
    for v in names:
        lib = ctypes.CDLL(str(native.BUILD_DIR / f"libk5_probe_{v}.so"))
        kernels._bind("edt_sweep")(lib)
        if v == "instr":
            lib.pcc_k5_records.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.pcc_k5_records.restype = ctypes.c_int
            lib.pcc_k5_records_zero.argtypes = []
            lib.pcc_k5_records_zero.restype = ctypes.c_int
        libs[v] = lib
    return libs


def with_lib(lib, fn):
    """Run ``fn`` with K5's wrapper bound to ``lib``."""
    from pcc_geo_cnn_v2_tpu_torch import native

    saved = native._libs.get("edt_sweep")
    native._libs["edt_sweep"] = lib
    try:
        return fn()
    finally:
        native._libs["edt_sweep"] = saved


def report_ctas(lib, call, label):
    """One call through the instrumented kernel; its CTAs' records."""
    from pcc_geo_cnn_v2_tpu_torch.ops import edt_sweep as es

    x_hat, occ, dt, t_end, thr = call
    lib.pcc_k5_records_zero()
    with_lib(lib, lambda: es.edt_sweep_sums(x_hat, occ, dt, thr, t_end))
    grid = x_hat.shape[0] * thr.shape[0]
    rec = np.zeros((grid, 6), np.uint64)
    if lib.pcc_k5_records(ctypes.c_void_p(rec.ctypes.data), grid):
        raise SystemExit("could not read the records")
    rec = rec[rec[:, 1] > 0]
    blk = (rec[:, 0] & 0xffff).astype(int)
    thr_i = ((rec[:, 0] >> 16) & 0xffff).astype(int)
    m = (rec[:, 0] >> 32).astype(int)
    us, mask_us = rec[:, 1] / 1e3, rec[:, 2] / 1e3
    print(f"{label}: {len(rec)} CTAs; µs mean {us.mean():.1f}, median "
          f"{np.median(us):.1f}, p99 {np.percentile(us, 99):.1f}, max "
          f"{us.max():.1f}; mask build µs mean {mask_us.mean():.1f}; warp "
          f"searches {int(rec[:, 3].sum())}, steps {int(rec[:, 4].sum())}; "
          f"brute-force CTAs {int((rec[:, 5] > 0).sum())}", flush=True)
    for i in np.argsort(-us)[:8]:
        print(f"   block {blk[i]} t {thr_i[i]}: {m[i]} occupied voxels, "
              f"{us[i]:.1f} µs (mask {mask_us[i]:.1f}), warp searches "
              f"{int(rec[i, 3])}, steps {int(rec[i, 4])}, brute list "
              f"{int(rec[i, 5])}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    names = list(variants((kernels.CSRC / "edt_sweep.cu").read_text()))
    ap.add_argument("--variants", nargs="+", default=names, choices=names)
    ap.add_argument("--chunks", type=int, nargs="+", default=[0, 1, 4])
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from pcc_geo_cnn_v2_tpu_torch.ops import edt_sweep as es

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.time()
    kernels.load("edt_sweep")
    libs = build(a.variants)
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s",
          flush=True)
    calls, thr = bench.cloud_calls("cuda")
    calls = [(*c, thr) for c in calls]

    def run(call):
        return es.edt_sweep_sums(call[0], call[1], call[2], call[4],
                                 call[3])

    ref = [run(c) for c in calls]
    for v, lib in libs.items():
        for i, c in enumerate(calls):
            got = with_lib(lib, lambda: run(c))
            torch.cuda.synchronize()
            if not all(torch.equal(g, r) for g, r in zip(got, ref[i])):
                raise SystemExit(f"{v} differs from the kernel on chunk {i}")
    print("every variant equal to the kernel on every chunk", flush=True)
    if "instr" in libs:
        for i in a.chunks:
            report_ctas(libs["instr"], calls[i], f"chunk {i}")
    timed = {"kernel": None, **{v: lib for v, lib in libs.items()
                                if v != "instr"}}
    sums = dict.fromkeys(timed, 0.0)
    for i, c in enumerate(calls):
        row = []
        for v, lib in timed.items():
            fn = (lambda: run(c)) if lib is None else \
                (lambda: with_lib(lib, lambda: run(c)))
            ms = cs.time_ms(fn, a.reps, burst=4)
            sums[v] += ms
            row.append(f"{v} {ms:.3f}")
        print(f"chunk {i}: " + ", ".join(row) + " ms", flush=True)
    print("sum over the cloud's launches (ms): " + ", ".join(
        f"{v} {t:.3f}" for v, t in sums.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

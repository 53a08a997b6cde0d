#!/usr/bin/env python3
"""Check and time K5 (exact-EDT sweep sums) on one GPU, launch by launch,
on path B's own inputs.

    python3 tools/torch_bench_edt_sweep.py [--reps 5]
        [--baseline path/to/other/edt_sweep.cu]

Runs the flagship cloud of ``chip_smoke.py`` (10-bit ``figure_cloud``,
octree level 4, c3p with ``bench_c3p.msgpack.gz``, 32-block chunks) through
the model and takes each chunk's K5 call as path B makes it
(``edt_sweep_sums`` with t_end = min(first_empty, t_small), sparse_k 256):
7 launches for one cloud.

- checks K5 (``edt_sweep.edt_sweep_sums``) and, with ``--baseline``,
  another K5 source with the earlier C interface
  (``pcc_edt_sweep(x_hat, occ, dt_int32, thr, first_empty, t_end, scratch,
  cnt, ba, ab, N, size, T, stream)`` and ``pcc_edt_sweep_group()``, called
  through the earlier wrapper's steps; built here with the package's nvcc
  flags) against the plain version on the first chunk (max error 0);
- times each wrapper call (median of ``--reps`` bursts of four calls
  between CUDA events, warm L2) and prints the ms of each launch and the
  sum over the cloud;
- runs the cloud's calls once more under ``torch.profiler`` and splits
  each version's device time by kernel name, with the CUDA launches a
  call.

Needs a CUDA device; exits non-zero without one or when a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the cloud and the timer)


def build_baseline(src):
    """Build ``src`` into ``libk5_bench_baseline.so``; its ctypes handle."""
    from pcc_geo_cnn_v2_tpu_torch import native
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    native.build({"k5_bench_baseline": (src, kernels._nvcc_cmd())},
                 force=True)
    lib = ctypes.CDLL(str(native.BUILD_DIR / "libk5_bench_baseline.so"))
    lib.pcc_edt_sweep.argtypes = \
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.pcc_edt_sweep.restype = ctypes.c_int
    lib.pcc_edt_sweep_group.argtypes = []
    lib.pcc_edt_sweep_group.restype = ctypes.c_int
    return lib


def baseline_call(lib, x_hat, occ, dt, thr, t_end):
    """The earlier wrapper's steps around the baseline's C entry."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import edt_sweep as es
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    n, size, T = x_hat.shape[0], x_hat.shape[-1], thr.shape[0]

    def go():
        first_empty = es.sweep_bounds(x_hat, thr, 0)[0]
        te = torch.minimum(t_end, first_empty).contiguous()
        occ_u8 = (occ > 0).to(torch.uint8).contiguous()
        dt_i = es._dt_int(dt).contiguous()
        scratch = torch.empty(n, lib.pcc_edt_sweep_group(), size ** 3,
                              dtype=torch.uint8, device=x_hat.device)
        cnt = torch.zeros(n, T, dtype=torch.int32, device=x_hat.device)
        ba = torch.zeros(n, T, dtype=torch.int64, device=x_hat.device)
        ab = torch.zeros(n, T, dtype=torch.int64, device=x_hat.device)
        err = lib.pcc_edt_sweep(
            x_hat.data_ptr(), occ_u8.data_ptr(), dt_i.data_ptr(),
            thr.data_ptr(), first_empty.data_ptr(), te.data_ptr(),
            scratch.data_ptr(), cnt.data_ptr(), ba.data_ptr(), ab.data_ptr(),
            n, size, T, kernels.stream_ptr(x_hat.device))
        kernels.check_launch(err, "baseline")
        return es._finish(ab, ba, cnt, te)
    return go


def cloud_calls(device):
    """[(x_hat, occ, dt_orig, t_end)] of one cloud's K5 calls on path B, in
    the codec's order (one per 32-block chunk), and the thresholds."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.ops import edt_sweep as es
    from pcc_geo_cnn_v2_tpu_torch.ops.edt import squared_edt
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import (
        flatten_blocks,
        pack_coords,
        voxelize,
    )
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
    from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

    points = figure_cloud(cs.CLOUD_SEED, cs.RESOLUTION, with_normals=True)[0]
    blocks, _ = partition_octree(points, [0, 0, 0], [cs.RESOLUTION] * 3,
                                 cs.LEVEL)
    codec = BlockCodec(build_model("c3p"), load_asset_tree(cs.ASSET),
                       block_size=cs.BLOCK, batch_blocks=cs.BATCH,
                       device=device)
    budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                 64)
    flat, offsets = flatten_blocks(blocks)
    flat_dev = torch.as_tensor(pack_coords(flat, cs.BLOCK), device=device)
    thr = codec.thr_dev
    out = []
    for lo in range(0, len(blocks), cs.BATCH):
        hi = min(lo + cs.BATCH, len(blocks))
        pts = codec.chunk_points(flat_dev, offsets, lo, hi, budget)
        x_hat = codec.encode_chunk(pts, hi - lo)["x_hat"][..., 0]
        x_hat = x_hat.to(torch.float32).contiguous()
        occ = voxelize(pts, cs.BLOCK)[..., 0]
        dt = squared_edt(occ > 0)
        first_empty, t_small, _ = es.sweep_bounds(x_hat, thr, 256)
        out.append((x_hat, occ, dt, torch.minimum(first_empty, t_small)))
    return out, thr


def kernel_split(calls):
    """Device µs by kernel name over one run of ``calls`` under
    torch.profiler: {name: (µs, launches)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = 0.0
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                us = float(getattr(evt, attr))
                break
        if us > 0 and evt.key not in out:
            out[evt.key] = (us, int(evt.count))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--baseline", type=Path,
                    help="another K5 source with the earlier C interface")
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from pcc_geo_cnn_v2_tpu_torch import native
    from pcc_geo_cnn_v2_tpu_torch.ops import edt_sweep as es
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.time()
    logs = native.build({"edt_sweep": (kernels.CSRC / "edt_sweep.cu",
                                       kernels._nvcc_cmd)}, force=True)
    for line in logs["edt_sweep"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    base = build_baseline(a.baseline) if a.baseline else None
    print(f"built in {time.time() - t0:.1f} s", flush=True)

    calls, thr = cloud_calls("cuda")
    def variants(args):
        out = {"K5": lambda: es.edt_sweep_sums(*args[:3], thr, args[3])}
        if base is not None:
            out["baseline"] = baseline_call(base, *args[:3], thr, args[3])
        return out

    x_hat, occ, dt, t_end = calls[0]
    t1 = time.time()
    ref = es.d1_sweep_sums_plain(x_hat, occ, dt, thr, t_end)
    torch.cuda.synchronize()
    print(f"plain version on chunk 0: {time.time() - t1:.1f} s", flush=True)
    for v, fn in variants(calls[0]).items():
        got = fn()
        torch.cuda.synchronize()
        for name, g, r in zip(("ab", "ba", "cnt"), got, ref):
            err = float((g - r).abs().max())
            assert err == 0, f"{v}: {name} differs from plain ({err})"
    print(f"chunk 0 ({len(t_end)} blocks, {int(t_end.sum())} (block, "
          f"threshold) EDTs): every version equal to the plain one",
          flush=True)

    rows = []
    for i, args in enumerate(calls):
        ms = {v: cs.time_ms(fn, a.reps, burst=4)
              for v, fn in variants(args).items()}
        rows.append(ms)
        n_occ = int((args[1] > 0).sum())
        ab = es.edt_sweep_sums(*args[:3], thr, args[3])[0]
        tidx = torch.arange(thr.shape[0], device=ab.device)[None, :]
        ab_edt = float(torch.where(tidx < args[3][:, None], ab, 0.0)
                       .double().sum())
        print(f"chunk {i}: {int(args[3].sum())} EDTs, {n_occ} occupied "
              f"voxels, AB over the EDTs {ab_edt:.4g} (mean distance² "
              f"{ab_edt / max(n_occ * int(args[3].sum()) / len(args[3]), 1):.1f}); "
              + ", ".join(f"{v} {t:.3f} ms" for v, t in ms.items()),
              flush=True)
    print("sum over the cloud's launches (ms):")
    for v in rows[0]:
        print(f"  {v}: {sum(r[v] for r in rows):.3f}")

    for v in rows[0]:
        fns = [variants(args)[v] for args in calls]
        split = kernel_split(fns)
        total = sum(us for us, _ in split.values())
        print(f"{v} under torch.profiler, device ms over the cloud "
              f"({len(calls)} calls):")
        per_call = defaultdict(int)
        for name, (us, cnt) in sorted(split.items(), key=lambda kv: -kv[1][0]):
            print(f"  {us / 1e3:9.3f} ms  {cnt:5d} launches  {name[:90]}")
            if "sweep" in name:
                per_call["kernel"] += cnt
        print(f"  total {total / 1e3:.3f} ms; K5 kernels launched "
              f"{per_call['kernel'] / len(calls):.1f} times a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())

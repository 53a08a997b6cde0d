#!/usr/bin/env python3
"""Check and time K1 (bucket prefix-min column sums) on one GPU, launch by
launch, on the main path's own inputs.

    python3 tools/torch_bench_bucket_colsums.py [--reps 5]
        [--baseline path/to/other/bucket_colsums.cu]

Runs the flagship cloud of ``chip_smoke.py`` (10-bit ``figure_cloud``,
octree level 4, c3p with ``bench_c3p.msgpack.gz``, 32-block chunks) through
the model, and takes every chunk's sweep at K = 32768 and every chunk's
overflow rerun at K = B³ — the launches the codec makes for one cloud:

- checks K1 (``bucket_sweep.bucket_colsums``) and, with ``--baseline``,
  another K1 source with the earlier C interface
  (``pcc_bucket_colsums(pts, pos, cnt0, npts, colsum, candmin, N, P, K,
  size, stream)``, int32 colsum zeroed and candmin filled by the caller;
  built here with the package's nvcc flags) against the plain version on
  the first chunk and on the first rerun (max error 0);
- times each (per launch, median of ``--reps`` bursts of four launches
  between CUDA events, warm L2) and prints the ms of each launch and the
  sum over the cloud's chunks and reruns.

Needs a CUDA device; exits non-zero without one or when a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the cloud and the timer)


def build_baseline(src):
    """Build ``src`` into ``libk1_bench_baseline.so``; its ctypes handle."""
    from pcc_geo_cnn_v2_tpu_torch import native
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    native.build({"k1_bench_baseline": (src, kernels._nvcc_cmd())},
                 force=True)
    lib = ctypes.CDLL(str(native.BUILD_DIR / "libk1_bench_baseline.so"))
    lib.pcc_bucket_colsums.argtypes = \
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pcc_bucket_colsums.restype = ctypes.c_int
    return lib


def cloud_launches(device):
    """[(label, pts, pos, cnt0 clamped, npts, K)] of one cloud's K1 launches
    in the codec's order: each chunk at K = 32768, then its overflowed
    blocks at K = B³."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import flatten_blocks, pack_coords
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
    out = []
    for lo in range(0, len(blocks), cs.BATCH):
        hi = min(lo + cs.BATCH, len(blocks))
        pts = codec.chunk_points(flat_dev, offsets, lo, hi, budget)
        x_hat = codec.encode_chunk(pts, hi - lo)["x_hat"]
        args = cs.sweep_args(codec, pts, x_hat, codec.bucket_k)
        out.append((f"chunk {lo // cs.BATCH}", *args[:2], *args[3:]))
        rows = torch.nonzero(args[2][:hi - lo] > codec.bucket_k).flatten()
        if len(rows):
            args = cs.sweep_args(codec, pts[rows], x_hat[rows],
                                 cs.BLOCK ** 3)
            out.append((f"rerun {lo // cs.BATCH} ({len(rows)} blocks)",
                        *args[:2], *args[3:]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--baseline", type=Path,
                    help="another K1 source with the earlier C interface")
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bsw
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.time()
    kernels.load("bucket_colsums")
    base = build_baseline(a.baseline) if a.baseline else None
    print(f"built in {time.time() - t0:.1f} s", flush=True)

    launches = cloud_launches("cuda")
    B = 64

    def baseline_call(pts, pos, cnt0, npts, K):
        def go():
            colsum = torch.zeros(pos.shape, dtype=torch.int32, device="cuda")
            candmin = torch.full(pos.shape, bsw.BIG, dtype=torch.int32,
                                 device="cuda")
            err = base.pcc_bucket_colsums(
                pts.data_ptr(), pos.data_ptr(), cnt0.data_ptr(),
                npts.data_ptr(), colsum.data_ptr(), candmin.data_ptr(),
                len(npts), pts.shape[1], K, B,
                kernels.stream_ptr(pos.device))
            kernels.check_launch(err, "baseline")
            return colsum.to(torch.int64) & 0xFFFFFFFF, candmin.to(torch.int64)
        return go

    def calls(pts, pos, cnt0, npts, K):
        out = {"K1": lambda: bsw.bucket_colsums(pts, pos, cnt0, npts, B)}
        if base is not None:
            out["baseline"] = baseline_call(pts, pos, cnt0, npts, K)
        return out

    first = {}
    for lab, *args in launches:
        first.setdefault(lab.split()[0], args)
    for kind, args in first.items():  # one chunk, one rerun
        ref = bsw.bucket_colsums_plain(*args[:4], B)
        for v, fn in calls(*args).items():
            got = fn()
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                assert torch.equal(g, r), f"{v} differs from plain on {kind}"
        print(f"{kind}: equal to the plain version", flush=True)

    rows = {}
    for lab, *args in launches:
        pts, pos, cnt0, npts, K = args
        ms = {v: cs.time_ms(fn, a.reps, burst=4)
              for v, fn in calls(*args).items()}
        pairs = int((npts.long() * cnt0.long()).sum())
        rows[lab] = ms
        print(f"{lab}: {len(npts)} blocks, {pairs} pairs; " + ", ".join(
            f"{v} {t:.3f} ms" for v, t in ms.items()), flush=True)
    print("sum over the cloud's launches (ms), chunks + reruns:")
    for v in rows[next(iter(rows))]:
        ch = sum(r[v] for lab, r in rows.items() if lab.startswith("chunk"))
        re = sum(r[v] for lab, r in rows.items() if lab.startswith("rerun"))
        print(f"  {v}: {ch:.3f} + {re:.3f} = {ch + re:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

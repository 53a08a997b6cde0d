#!/usr/bin/env python3
"""Check and time K3 (bucket prefix-min column sums with point-to-plane
terms) on one GPU, launch by launch, on path A's own inputs.

    python3 tools/torch_bench_bucket_colsums_d2.py [--reps 5]
        [--baseline path/to/old/bucket_colsums_d2.cu]
        [--variants path/to/other.cu ...]

Runs the flagship cloud of ``chip_smoke.py`` (10-bit ``figure_cloud`` with
normals, octree level 4, c3p with ``bench_c3p.msgpack.gz``, 32-block
chunks) through the model and takes every chunk's sweep at K = 32768 and
every chunk's overflow rerun at K = B³ — the K3 launches path A makes for
one cloud:

- checks K3 (``bucket_sweep.bucket_colsums_d2``) against its plain version
  on the first chunk and the first rerun (colsum, candmin, candplane
  equal; colplane within ``npts · 2^-20 + 1e-6 · |value|``);
- with ``--baseline``, builds another K3 source with the earlier C
  interface (``pcc_bucket_colsums_d2(pts, nrm, pos, cnt0, npts, dsum,
  dplane, key, candmin, candplane, N, P, K, size, stream)``; the caller
  zeroes dsum / dplane, fills key with -1 and candmin with BIG, and
  converts candmin to int64 and the 2^-20 fixed-point dplane to f32, as
  that source's wrapper did) and checks all four outputs of K3 bit-equal
  to its on every launch (colplane too: both sum plane² in fixed point,
  which does not depend on order);
- with ``--variants``, builds each source with K3's C interface and checks
  its four outputs bit-equal to K3's on every launch;
- times each (per launch, median of ``--reps`` bursts of four launches
  between CUDA events, warm L2) and prints the ms of each launch and the
  sum over the cloud's chunks and reruns; then the device time of one
  cloud's launches by kernel name under ``torch.profiler``.

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

_P, _I = ctypes.c_void_p, ctypes.c_int


def build(name, src, argtypes):
    """Build ``src`` into ``lib<name>.so``; its ctypes handle."""
    from pcc_geo_cnn_v2_tpu_torch import native
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    native.build({name: (src, kernels._nvcc_cmd())}, force=True)
    lib = ctypes.CDLL(str(native.BUILD_DIR / f"lib{name}.so"))
    for fn, types in argtypes.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def cloud_launches(device):
    """[(label, pts, nrm, pos, cnt0 clamped, npts, K)] of one cloud's K3
    launches in the codec's order: each chunk at K = 32768, then its
    overflowed blocks at K = B³."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import flatten_blocks, pack_coords
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
    from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

    points, normals = figure_cloud(cs.CLOUD_SEED, cs.RESOLUTION,
                                   with_normals=True)
    blocks, _ = partition_octree(np.hstack([points, normals]), [0, 0, 0],
                                 [cs.RESOLUTION] * 3, cs.LEVEL)
    codec = BlockCodec(build_model("c3p"), load_asset_tree(cs.ASSET),
                       block_size=cs.BLOCK, batch_blocks=cs.BATCH,
                       device=device)
    budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                 64)
    flat, offsets = flatten_blocks(blocks)
    flat_dev = torch.as_tensor(pack_coords(flat, cs.BLOCK), device=device)
    nrm_dev = torch.as_tensor(flatten_blocks(
        blocks, cols=(3, 4, 5), dtype=np.float32)[0], device=device)
    out = []
    for lo in range(0, len(blocks), cs.BATCH):
        hi = min(lo + cs.BATCH, len(blocks))
        pts = codec.chunk_points(flat_dev, offsets, lo, hi, budget)
        nrm = codec.chunk_normals(nrm_dev, offsets, lo, hi, budget)
        x_hat = codec.encode_chunk(pts, hi - lo)["x_hat"]
        args = cs.sweep_args(codec, pts, x_hat, codec.bucket_k)
        out.append((f"chunk {lo // cs.BATCH}", args[0], nrm.contiguous(),
                    args[1], *args[3:]))
        rows = torch.nonzero(args[2][:hi - lo] > codec.bucket_k).flatten()
        if len(rows):
            args = cs.sweep_args(codec, pts[rows], x_hat[rows],
                                 cs.BLOCK ** 3)
            out.append((f"rerun {lo // cs.BATCH} ({len(rows)} blocks)",
                        args[0], nrm[rows].contiguous(), args[1],
                        *args[3:]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--baseline", type=Path,
                    help="another K3 source with the earlier C interface")
    ap.add_argument("--variants", type=Path, nargs="*", default=[],
                    help="other K3 sources with the current C interface")
    a = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bsw
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.time()
    kernels.load("bucket_colsums_d2")
    base = build("k3_bench_baseline", a.baseline, {
        "pcc_bucket_colsums_d2": [_P] * 10 + [_I] * 4 + [_P]}) \
        if a.baseline else None
    variants = {f"variant {i} ({src.name})": build(
        f"k3_bench_variant{i}", src,
        kernels.KERNELS["bucket_colsums_d2"][1])
        for i, src in enumerate(a.variants)}
    print(f"built in {time.time() - t0:.1f} s", flush=True)

    launches = cloud_launches("cuda")
    B = cs.BLOCK

    def baseline_call(pts, nrm, pos, cnt0, npts, K):
        def go():
            shape = pos.shape
            dsum = torch.zeros(shape, dtype=torch.int64, device="cuda")
            dplane = torch.zeros(shape, dtype=torch.int64, device="cuda")
            key = torch.full(shape, -1, dtype=torch.int32, device="cuda")
            candmin = torch.full(shape, bsw.BIG, dtype=torch.int32,
                                 device="cuda")
            candplane = torch.zeros(shape, dtype=torch.float32,
                                    device="cuda")
            err = base.pcc_bucket_colsums_d2(
                pts.data_ptr(), nrm.data_ptr(), pos.data_ptr(),
                cnt0.data_ptr(), npts.data_ptr(), dsum.data_ptr(),
                dplane.data_ptr(), key.data_ptr(), candmin.data_ptr(),
                candplane.data_ptr(), len(npts), pts.shape[1], K, B,
                kernels.stream_ptr(pos.device))
            kernels.check_launch(err, "baseline")
            return (dsum, candmin.to(torch.int64),
                    (dplane.to(torch.float64) / 2.0 ** 20).to(torch.float32),
                    candplane)
        return go

    def variant_call(lib, pts, nrm, pos, cnt0, npts, K):
        def go():
            n, P = len(npts), pts.shape[1]
            out = [torch.empty(pos.shape, dtype=dt, device="cuda")
                   for dt in (torch.int64, torch.int64, torch.float32,
                              torch.float32)]
            work = torch.empty(lib.pcc_bucket_colsums_d2_work_ints(n, K),
                               dtype=torch.int32, device="cuda")
            plan = bsw.bucket_plan(n, P)
            err = lib.pcc_bucket_colsums_d2(
                pts.data_ptr(), nrm.data_ptr(), pos.data_ptr(),
                cnt0.data_ptr(), npts.data_ptr(),
                *(o.data_ptr() for o in out), work.data_ptr(), n, P, K, B,
                plan["threads"], plan["grid"][0],
                kernels.stream_ptr(pos.device))
            kernels.check_launch(err, "variant")
            return out
        return go

    def calls(pts, nrm, pos, cnt0, npts, K):
        out = {"K3": lambda: bsw.bucket_colsums_d2(pts, nrm, pos, cnt0,
                                                   npts, B)}
        if base is not None:
            out["baseline"] = baseline_call(pts, nrm, pos, cnt0, npts, K)
        for v, lib in variants.items():
            out[v] = variant_call(lib, pts, nrm, pos, cnt0, npts, K)
        return out

    first = {}
    for lab, *args in launches:
        first.setdefault(lab.split()[0], args)
    for kind, args in first.items():  # one chunk, one rerun
        got = bsw.bucket_colsums_d2(*args[:5], B)
        ref = bsw.bucket_colsums_d2_plain(*args[:5], B)
        torch.cuda.synchronize()
        for i in (0, 1, 3):
            assert torch.equal(got[i], ref[i]), \
                f"K3 {cs.K3_OUTPUTS[i]} differs from plain on {kind}"
        tol = args[4][:, None].double() * 2.0 ** -20 \
            + 1e-6 * ref[2].double().abs()
        assert bool(((got[2].double() - ref[2].double()).abs()
                     <= tol).all()), f"K3 colplane beyond tol on {kind}"
        print(f"{kind}: K3 equal to the plain version", flush=True)
    for lab, *args in launches:  # every launch: the others bit-equal K3
        fns = calls(*args)
        want = fns.pop("K3")()
        for v, fn in fns.items():
            got = fn()
            for name, g, w in zip(cs.K3_OUTPUTS, got, want):
                assert torch.equal(g, w), f"{v} {name} differs on {lab}"
    torch.cuda.synchronize()
    if len(calls(*launches[0][1:])) > 1:
        print(f"all four outputs bit-equal to K3's on all "
              f"{len(launches)} launches: "
              f"{', '.join(v for v in calls(*launches[0][1:]) if v != 'K3')}",
              flush=True)

    rows = {}
    for lab, *args in launches:
        pts, nrm, pos, cnt0, npts, K = args
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

    print("device ms of one cloud's launches by kernel name "
          "(torch.profiler):")
    for v in rows[next(iter(rows))]:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for lab, *args in launches:
                calls(*args)[v]()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if "cudaLaunch" not in e.key and e.count]
        us = lambda e: float(getattr(e, "self_device_time_total", 0.0)
                             or getattr(e, "self_cuda_time_total", 0.0))
        tot = sum(us(e) for e in evts)
        print(f"  {v}: {tot / 1e3:.3f} ms in all")
        for e in sorted(evts, key=us, reverse=True)[:6]:
            print(f"    {us(e) / 1e3:8.3f} ms  {e.count:4d}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

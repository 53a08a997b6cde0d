#!/usr/bin/env python3
"""Check and time K2 (full-cloud D1 sums) on one GPU, on the d1 path's own
inputs, beside an earlier K2 source with the chain around it.

    python3 tools/torch_bench_halo_edt.py [--reps 10]
        [--baseline path/to/old/halo_edt.cu]
        [--variants path/to/other.cu ...]

Runs the flagship cloud of ``chip_smoke.py`` (10-bit ``figure_cloud``,
octree level 4, c3p with ``bench_c3p.msgpack.gz``, 32-block chunks)
through the model and takes the encoder's packed occupancy and first
candidate masks of every block — the inputs of the d1 path's
``blockwise_d1_sums`` call — then:

- runs ``cloud_metrics.blockwise_d1_sums`` (K2 on the packed grids, one
  call a cloud);
- with ``--baseline``, builds another K2 source with the earlier C
  interface (``pcc_halo_edt(qry, tgt, kmax, scratch, sum, n, unres_cnt,
  unres, bs, H, size, halo, stream)`` over assembled halo volumes; the
  caller zeroes sum, n and unres_cnt) and runs the chain that fed it, 64
  blocks a step and direction: the neighbour gathers, ``query_core``,
  ``assemble_halo``, ``halo_kmax`` and the kernel; checks both give the
  same sums, counts and outlier coordinates;
- with ``--variants``, builds each source with K2's C interface and checks
  its stats and outlier masks bit-equal to K2's on the cloud;
- for each, prints the device time of one call by kernel name and the
  device operations (kernels, copies, fills) under ``torch.profiler``, the
  host ms of a call (median of ``--reps``, to a synchronize), and the K2
  kernels' own time a cloud (median of bursts of four between CUDA events:
  the one new call, each variant's; the baseline's 8 launches on volumes
  assembled beforehand).

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

import chip_smoke as cs  # noqa: E402  (the cloud, the timer, K2's inputs)

_P, _I = ctypes.c_void_p, ctypes.c_int


def cloud_inputs(device):
    """(origins, occupancy, first masks) of the flagship cloud, packed."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import flatten_blocks, pack_coords
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import (
        block_origins,
        partition_octree,
    )
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
    from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

    points = figure_cloud(cs.CLOUD_SEED, cs.RESOLUTION, with_normals=False)
    blocks, binstr = partition_octree(points, [0, 0, 0], [cs.RESOLUTION] * 3,
                                      cs.LEVEL)
    codec = BlockCodec(build_model("c3p"), load_asset_tree(cs.ASSET),
                       block_size=cs.BLOCK, batch_blocks=cs.BATCH,
                       device=device)
    budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                 64)
    flat, offsets = flatten_blocks(blocks)
    flat_dev = torch.as_tensor(pack_coords(flat, cs.BLOCK), device=device)
    occ, mask = [], []
    for lo in range(0, len(blocks), cs.BATCH):
        hi = min(lo + cs.BATCH, len(blocks))
        res = codec.encode_chunk(
            codec.chunk_points(flat_dev, offsets, lo, hi, budget), hi - lo)
        occ.append(res["occ"][:hi - lo])
        mask.append(res["masks"][0][:hi - lo])
    origins = np.stack(block_origins(binstr, [0, 0, 0],
                                     [cs.RESOLUTION] * 3, cs.LEVEL))
    return origins, torch.cat(occ), torch.cat(mask)


def baseline_d1_sums(lib, a_packed, b_packed, origins):
    """The earlier chain: 64 blocks a step and direction, gathered and
    assembled, with the coarse bound, into the baseline kernel; the
    outputs of ``blockwise_d1_sums``."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import cloud_metrics as cm
    from pcc_geo_cnn_v2_tpu_torch.ops import halo as hl

    size, halo, batch = cs.BLOCK, cs.HALO, cs.HALO_BATCH
    n, dev = len(origins), a_packed.device
    nb = cm.neighbor_table(origins, size)
    zero = torch.zeros(1, a_packed.shape[1], dtype=torch.uint8, device=dev)
    a_ext = torch.cat([a_packed[:n], zero])
    b_ext = torch.cat([b_packed[:n], zero])
    idx_all = torch.as_tensor(np.where(nb < 0, n, nb), dtype=torch.int64,
                              device=dev)
    totals = {"ab_sum": 0, "ba_sum": 0, "n_a": 0, "n_b": 0}
    unres = {"ab": [], "ba": []}
    for lo in range(0, n, batch):
        idx = idx_all[lo:lo + batch]
        if len(idx) < batch:  # fixed batch width: pad with empty blocks
            idx = torch.cat([idx, torch.full((batch - len(idx), 27), n,
                                             dtype=torch.int64, device=dev)])
        a_nb, b_nb = a_ext[idx], b_ext[idx]
        for tag, q_nb, t_nb in (("ab", a_nb, b_nb), ("ba", b_nb, a_nb)):
            qry = hl.query_core(q_nb, size)
            tgt = hl.assemble_halo(t_nb, size, halo)
            r = baseline_edt(lib, qry.contiguous(), tgt.contiguous(),
                             hl.halo_kmax(qry, tgt, halo))
            totals[f"{tag}_sum"] += int(r[0].sum())
            totals["n_a" if tag == "ab" else "n_b"] += int(r[1].sum())
            flagged = torch.nonzero(r[2][:n - lo]).flatten()
            if len(flagged):
                unres[tag].append((lo + flagged.cpu().numpy(),
                                   r[3][flagged].cpu().numpy()))
    out = dict(totals)
    for tag, key in (("ab", "outliers_a"), ("ba", "outliers_b")):
        coords = []
        for blk, rows in unres[tag]:
            bits = np.unpackbits(rows, axis=-1, bitorder="big")
            c = np.argwhere(bits.reshape(len(rows), size, size, size))
            coords.append(c[:, 1:] + origins[blk[c[:, 0]]])
        out[key] = np.concatenate(coords) if coords else np.zeros((0, 3))
    out["ab_sum"] = float(out["ab_sum"])
    out["ba_sum"] = float(out["ba_sum"])
    return out


def baseline_edt(lib, qry, tgt, kmax):
    """One launch of the baseline source: (sum, n, unres_cnt, unres)."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    bs, H, size, dev = tgt.shape[0], tgt.shape[1], qry.shape[1], tgt.device
    scratch = torch.empty(bs, size, H, H, dtype=torch.uint8, device=dev)
    s = torch.zeros(bs, dtype=torch.int64, device=dev)
    n = torch.zeros(bs, dtype=torch.int32, device=dev)
    cnt = torch.zeros(bs, dtype=torch.int32, device=dev)
    unres = torch.empty(bs, size ** 3 // 8, dtype=torch.uint8, device=dev)
    err = lib.pcc_halo_edt(
        qry.data_ptr(), tgt.data_ptr(), kmax.data_ptr(), scratch.data_ptr(),
        s.data_ptr(), n.data_ptr(), cnt.data_ptr(), unres.data_ptr(), bs, H,
        size, cs.HALO, kernels.stream_ptr(dev))
    kernels.check_launch(err, "baseline")
    return s, n, cnt, unres


def variant_call(lib, a_ext, b_ext, idx):
    """A call of another source with K2's C interface (partials sized for
    slabs of 8 x-planes, enough for any slab of 8 or more)."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import halo as hl
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    n, size, dev = idx.shape[0], cs.BLOCK, a_ext.device
    spiral = torch.as_tensor(hl.halo_spiral_table(cs.HALO), device=dev)

    def go():
        part = torch.empty(2, n, size // 8, 3, dtype=torch.int64, device=dev)
        stats = torch.empty(2, 3, n, dtype=torch.int64, device=dev)
        unres = torch.empty(2, n, size ** 3 // 8, dtype=torch.uint8,
                            device=dev)
        err = lib.pcc_halo_edt(
            a_ext.data_ptr(), b_ext.data_ptr(), a_ext.shape[0],
            idx.data_ptr(), spiral.data_ptr(), len(spiral), part.data_ptr(),
            stats.data_ptr(), unres.data_ptr(), n, size, cs.HALO,
            kernels.stream_ptr(dev))
        kernels.check_launch(err, "variant")
        return stats, unres
    return go


def profile_call(call):
    """(device ms in all, device operations, [(ms, count, name)] top 8)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    us = lambda e: float(getattr(e, "self_device_time_total", 0.0)  # noqa
                         or getattr(e, "self_cuda_time_total", 0.0))
    evts = sorted((e for e in prof.key_averages() if us(e) > 0), key=us,
                  reverse=True)
    return (sum(us(e) for e in evts) / 1e3, sum(e.count for e in evts),
            [(us(e) / 1e3, e.count, e.key[:80]) for e in evts[:8]])


def host_ms(call, reps):
    import torch

    call()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--baseline", type=Path,
                    help="another K2 source with the earlier C interface")
    ap.add_argument("--variants", type=Path, nargs="*", default=[],
                    help="other K2 sources with the current C interface")
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from pcc_geo_cnn_v2_tpu_torch import native
    from pcc_geo_cnn_v2_tpu_torch.ops import cloud_metrics as cm
    from pcc_geo_cnn_v2_tpu_torch.ops import halo as hl
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.time()
    kernels.load("halo_edt")
    base = None
    if a.baseline:
        native.build({"k2_bench_baseline": (a.baseline, kernels._nvcc_cmd())},
                     force=True)
        base = ctypes.CDLL(str(native.BUILD_DIR / "libk2_bench_baseline.so"))
        base.pcc_halo_edt.argtypes = [_P] * 8 + [_I] * 4 + [_P]
        base.pcc_halo_edt.restype = ctypes.c_int
    variants = {}
    for i, src in enumerate(a.variants):
        name = f"k2_bench_variant{i}"
        log = native.build({name: (src, kernels._nvcc_cmd())}, force=True)
        for line in log[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src.name}: {line.strip()}")
        lib = ctypes.CDLL(str(native.BUILD_DIR / f"lib{name}.so"))
        lib.pcc_halo_edt.argtypes = kernels.KERNELS["halo_edt"][1][
            "pcc_halo_edt"]
        lib.pcc_halo_edt.restype = ctypes.c_int
        variants[f"variant {i} ({src.name})"] = lib
    print(f"built in {time.time() - t0:.1f} s", flush=True)

    origins, occ, mask = cloud_inputs("cuda")
    n = len(origins)
    calls = {"K2": lambda: cm.blockwise_d1_sums(occ, mask, origins, cs.BLOCK,
                                                halo=cs.HALO)}
    if base is not None:
        calls["baseline"] = lambda: baseline_d1_sums(base, occ, mask, origins)
    outs = {v: fn() for v, fn in calls.items()}
    want = outs["K2"]
    for v, got in outs.items():
        for k in ("ab_sum", "ba_sum", "n_a", "n_b"):
            assert got[k] == want[k], (v, k, got[k], want[k])
        for k in ("outliers_a", "outliers_b"):
            assert np.array_equal(got[k], want[k]), (v, k)
    print(f"{n} blocks: sums AB {want['ab_sum']:.0f} BA {want['ba_sum']:.0f}, "
          f"{want['n_a']} + {want['n_b']} queries, "
          f"{len(want['outliers_a'])} + {len(want['outliers_b'])} outliers; "
          f"equal in every output: {', '.join(outs)}", flush=True)

    # the K2 kernels alone, a cloud
    a_ext, b_ext, idx = cs.k2_inputs(occ, mask, origins)
    kern = {"K2": lambda: hl.halo_d1_packed(a_ext, b_ext, idx,
                                            size=cs.BLOCK, halo=cs.HALO)}
    if base is not None:
        vols = []
        for lo in range(0, n, cs.HALO_BATCH):
            ix = idx[lo:lo + cs.HALO_BATCH].long()
            if len(ix) < cs.HALO_BATCH:
                ix = torch.cat([ix, torch.full(
                    (cs.HALO_BATCH - len(ix), 27), n, dtype=torch.int64,
                    device=ix.device)])
            for q_ext, t_ext in ((a_ext, b_ext), (b_ext, a_ext)):
                qry = hl.query_core(q_ext[ix], cs.BLOCK).contiguous()
                tgt = hl.assemble_halo(t_ext[ix], cs.BLOCK,
                                       cs.HALO).contiguous()
                vols.append((qry, tgt, hl.halo_kmax(qry, tgt, cs.HALO)))
        kern["baseline"] = lambda: [baseline_edt(base, *v) for v in vols]
    want = kern["K2"]()
    for v, lib in variants.items():
        kern[v] = variant_call(lib, a_ext, b_ext, idx)
        got = kern[v]()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), \
            f"{v}: stats or masks differ from K2's"
    if variants:
        print(f"stats and masks bit-equal to K2's: {', '.join(variants)}",
              flush=True)
    for v, fn in kern.items():
        ms = cs.time_ms(fn, a.reps, burst=4)
        print(f"{v} kernels a cloud: {ms:.4f} ms "
              f"({ms * cs.HALO_BATCH / n:.4f} ms per {cs.HALO_BATCH} blocks)",
              flush=True)

    for v, fn in calls.items():
        dev_ms, ops, top = profile_call(fn)
        print(f"{v}: the D1-sums call, {dev_ms:.3f} ms of device time in "
              f"{ops} device operations, host {host_ms(fn, a.reps):.3f} ms "
              f"a call", flush=True)
        for ms, cnt, key in top:
            print(f"    {ms:8.3f} ms  {cnt:5d}x  {key}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

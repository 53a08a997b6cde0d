#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's encode and decode paths.

    python3 tools/torch_profile_main_path.py [--seed 300] [--top 20]
        [--paths d1 A B C C_bf16 xla_bf16 c2 c1 host_fixed host_cut
         point_d2_cut train pipeline]

Runs the paths ``chip_smoke.py`` drives (10-bit ``figure_cloud`` with
normals, octree level 4, batch 32; c3p at full width with
``bench_c3p.msgpack.gz`` unless named) — the d1 path, path A (d1_mse +
d2_mse with normals, kernel K3), path B (``sweep_backend="pallas"``,
kernel K5), path C (``conv_backend="pallas"``, kernels K4a / K4b) in f32
and in bf16, the cuDNN backend in bf16 beside it, the d1 path of c2 and
c1 (V1 transforms, ``assets/rd/*/2.00e-04.msgpack.gz``), the
host-threshold encoder (``compress_blocks``) with ``fixed_threshold`` on
the whole cloud and adaptive on ``chip_smoke.cut_cloud``'s cut, and the
point-based d2 sweep (``sweep_backend="xla"``, normals) on the cut — each
once to warm up, then once under ``torch.profiler`` on one GPU, and prints
for each:

- the codec's host phase times (``logging`` INFO lines of
  ``pcc_geo_cnn_v2_tpu_torch.codec``),
- the wall time of encode and decode and the device-busy share (summed
  CUDA kernel time over wall time; kernels run on one stream),
- the top device kernels by total CUDA time, grouped into families
  (cuDNN convolution, sort, the port's K1–K5 kernels, other).

``train`` profiles the trainer instead: c3p at full width warm-started
from ``bench_c3p.msgpack.gz``, batch 32 of the cloud's 64³ blocks, f32.
After two warm-up steps it splits each of five steps into data (batch
indices, gather, noise), voxelize (timed alone on the step's batch; the
loss voxelizes again), forward and loss, backward and optimizer, by CUDA
events on the device's timeline, times each conv layer's forward and
backward in one more step (CUDA events from module hooks; the sub-pixel
transposed convs are one layer each), then profiles three steps as above
(wall, busy share, families, top kernels) and prints the peak memory.

``pipeline`` profiles the benchmark driver's timed window
(``pcc_geo_cnn_v2_tpu_torch/bench.py`` at its defaults: 8 held-out
clouds, c3p in bf16, batch 128, the bucket sweep) at 1 and at 3 clouds in
flight, on as many threads with a CUDA stream each.
Kernels of several streams overlap there, so the device is busy for the
union of the kernels' intervals on the trace, not their sum: both are
printed, with the idle share of the union, and the families.

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import gzip
import io
import logging
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from pcc_geo_cnn_v2_tpu_torch.utils import trace  # noqa: E402

SPAN_PREFIX = trace.PREFIX

FAMILIES = (("K1 bucket_colsums", ("bucket_colsums",)),
            ("K2 halo_edt", ("halo_edt",)),
            ("K3 bucket_colsums_d2", ("bucket_d2",)),
            ("K5 edt_sweep", ("edt_sweep",)),
            ("K4a fused_tail", ("tail_kernel",)),
            ("K4b fused_tail_slab", ("tail_slab_kernel",)),
            ("convolution", ("conv", "cudnn", "sm90_xmma", "implicit",
                             "gemm", "wgrad", "dgrad", "fprop")),
            ("sort", ("sort", "radix")),
            ("copy / fill", ("copy", "fill", "memset", "memcpy")))


D2 = dict(opt_metrics=("d1_mse", "d2_mse"), with_normals=True)
HOST = dict(method="compress_blocks")
# key → (title, model config, BlockCodec / build_model arguments, encode
# arguments; ``method`` names the encoder, ``cut`` takes the cut cloud)
PATHS = {
    "d1": ("d1 path", "c3p", {}, {}),
    "A": ("path A (d1_mse + d2_mse, normals)", "c3p", {}, D2),
    "B": ("path B (sweep_backend='pallas')", "c3p",
          dict(sweep_backend="pallas"), {}),
    "C": ("path C (conv_backend='pallas', f32)", "c3p",
          dict(conv_backend="pallas"), {}),
    "C_bf16": ("path C (conv_backend='pallas', bf16)", "c3p",
               dict(conv_backend="pallas", dtype="bfloat16"), {}),
    "xla_bf16": ("cuDNN backend in bf16 (conv_backend='xla')", "c3p",
                 dict(dtype="bfloat16"), {}),
    "c2": ("c2, d1 path", "c2", {}, {}),
    "c1": ("c1, d1 path", "c1", {}, {}),
    "host_fixed": ("host path, fixed_threshold", "c3p", {},
                   dict(HOST, fixed_threshold=True)),
    "host_cut": ("host path, adaptive sweep, the cut", "c3p", {},
                 dict(HOST, cut=True)),
    "point_d2_cut": ("point sweep (sweep_backend='xla'), d1_mse + d2_mse, "
                     "the cut", "c3p", dict(sweep_backend="xla"),
                     dict(D2, cut=True)),
}


def family(name):
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def device_us(evt):
    """Device µs of a profiler event; 0 for the port's span annotations
    (``utils/trace``: a ``pcc.`` range also appears on the device's
    timeline), which are not device work."""
    if evt.key.startswith(SPAN_PREFIX):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=300)
    ap.add_argument("--top", type=int, default=20)
    extra = ["train", "pipeline"]
    ap.add_argument("--paths", nargs="+", default=list(PATHS) + extra,
                    choices=list(PATHS) + extra)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    from chip_smoke import ASSET, CUT_BLOCKS, RD_ASSETS, V1_LAMBDA, cut_cloud
    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
    from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

    points, normals = figure_cloud(args.seed, 1024, with_normals=True)
    points6 = np.hstack([points, normals])
    blocks, binstr = partition_octree(points6, [0, 0, 0], [1024] * 3, 4)
    cut_pts, cut_blocks, cut_binstr = cut_cloud(blocks, binstr, CUT_BLOCKS)

    def make(config, sweep_backend="bucket", **model_kw):
        asset = (ASSET if config == "c3p"
                 else RD_ASSETS / config / f"{V1_LAMBDA}.msgpack.gz")
        return BlockCodec(build_model(config, **model_kw),
                          load_asset_tree(asset), block_size=64,
                          batch_blocks=32, sweep_backend=sweep_backend)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; {len(blocks)} blocks, the cut {CUT_BLOCKS}")
    for key in args.paths:
        if key in extra:
            rc = (profile_train(blocks, args.top) if key == "train" else
                  profile_pipeline(args.top))
            if rc:
                return rc
            continue
        name, config, codec_kw, kw = PATHS[key]
        if "dtype" in codec_kw:
            codec_kw = dict(codec_kw, dtype=getattr(torch, codec_kw["dtype"]))
        kw = dict(kw)
        cloud = ((cut_blocks, cut_binstr, cut_pts) if kw.pop("cut", False)
                 else (blocks, binstr, points6))
        rc = profile_path(name, make(config, **codec_kw), *cloud, kw,
                          args.top)
        if rc:
            return rc
    return 0


def profile_path(name, codec, blocks, binstr, points, kw, top):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pcc_geo_cnn_v2_tpu_torch.coding.syntax import (
        load_compressed_file,
        save_compressed_file,
    )

    kw = dict(kw)
    encode = getattr(codec, kw.pop("method", "compress_blocks_device_opt"))

    def run():
        t0 = time.time()
        data_list, _ = encode(blocks, binstr, points, 1024, 4, **kw)
        blobs = [gzip.compress(save_compressed_file(binstr, payload, 1024,
                                                    4))
                 for payload in data_list]
        torch.cuda.synchronize()
        t1 = time.time()
        for blob in blobs:
            payload = load_compressed_file(
                io.BytesIO(gzip.decompress(blob)))[3]
            codec.decompress_blocks(payload)
        torch.cuda.synchronize()
        return t1 - t0, time.time() - t1

    print(f"=== {name}: warm-up run:")
    run()
    print(f"=== {name}: profiled run:")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_enc, t_dec = run()
    print(f"wall: encode {t_enc:.3f} s ({len(blocks) / t_enc:.2f} blocks/s),"
          f" decode of every stream {t_dec:.3f} s")
    return summarize(prof, t_enc + t_dec, top)


def summarize(prof, wall, top):
    """Device busy share, families and top kernels of a profile."""
    from torch.autograd import DeviceType

    # device-side events only (CPU ops also carry their kernels' time)
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and device_us(e) > 0]
    if not kern:
        print("the profiler recorded no device kernels")
        return 1
    total_us = sum(device_us(e) for e in kern)
    print(f"device busy (kernel time summed over streams): "
          f"{total_us / 1e6:.3f} s of {wall:.3f} s wall "
          f"({100 * total_us / 1e6 / wall:.1f}%); idle "
          f"{100 - 100 * total_us / 1e6 / wall:.1f}%")
    fams = {}
    for e in kern:
        fams[family(e.key)] = fams.get(family(e.key), 0.0) + device_us(e)
    for fam, us in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:20s} {us / 1e3:10.3f} ms  "
              f"{100 * us / max(total_us, 1):5.1f}% of device time")
    print(f"top {top} device kernels:")
    for e in sorted(kern, key=lambda e: -device_us(e))[:top]:
        print(f"  {device_us(e) / 1e3:10.3f} ms  {e.count:6d}x  "
              f"{e.key[:110]}")
    return 0


def busy_union_ms(prof):
    """Milliseconds in which at least one device kernel, copy or fill ran:
    the union of their intervals on the trace (several streams overlap)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start
                   and not e.name.startswith(SPAN_PREFIX))
    total, end = 0.0, None
    for lo, hi in spans:
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total / 1e3


def profile_pipeline(top):
    """The bench's timed window under the profiler at its default cloud
    count, with 1 and with 3 clouds in flight."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import ASSET
    from pcc_geo_cnn_v2_tpu_torch import bench
    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec, deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

    deterministic_convs()
    clouds = bench.held_out_clouds(bench.NUM_CLOUDS, False)
    codec = BlockCodec(build_model("c3p", dtype=torch.bfloat16),
                       load_asset_tree(ASSET), block_size=64,
                       batch_blocks=128, sweep_backend="auto")
    for k in (1, 3):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        res = bench.run_pipeline(codec, clouds, bench.RESOLUTION, bench.LEVEL,
                                 lambda *a: None, workers=k, window=prof)
        wall = res["t_enc"] + res["t_dec"]
        union = busy_union_ms(prof)
        print(f"=== pipeline {k}: {len(clouds)} clouds, {res['blocks']} "
              f"blocks, encode {res['t_enc']:.3f} s, decode "
              f"{res['t_dec']:.3f} s under the profiler "
              f"({res['value']:.2f} blocks/s); device busy (union of the "
              f"streams' kernels) {union:.1f} ms of {1e3 * wall:.1f} ms, "
              f"idle {100 - 100 * union / 1e3 / wall:.1f}%; peak memory "
              f"{res['peak_bytes'] / 2**30:.3f} GiB; streams sha256 "
              f"{res['digest'][:16]}")
        rc = summarize(prof, wall, top)
        if rc:
            return rc
    return 0


def layer_times(tr, data, cfg, step=50):
    """Forward and backward ms of every conv layer in one training step,
    from CUDA events recorded by module hooks, largest backward first."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.models.transforms import Conv, ConvTranspose

    events, hooks = {}, []

    def record(name, key):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.setdefault(name, {})[key] = ev
        return hook

    for name, mod in tr.model.named_modules():
        if isinstance(mod, (Conv, ConvTranspose)):
            hooks += [mod.register_forward_pre_hook(record(name, "f0")),
                      mod.register_forward_hook(record(name, "f1")),
                      mod.register_full_backward_pre_hook(record(name, "b0")),
                      mod.register_full_backward_hook(record(name, "b1"))]
    try:
        tr.step_blocks(data, step)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    rows = []
    for name, ev in events.items():
        mod = tr.model.get_submodule(name)
        w = mod.weight.shape
        rows.append((ev["b0"].elapsed_time(ev["b1"]),
                     ev["f0"].elapsed_time(ev["f1"]), name,
                     f"{type(mod).__name__} k{mod.k} s{mod.s} "
                     f"{w[1]}->{w[0]}"))
    print(f"conv layers, one step (batch {cfg.batch_size}), ms: backward / "
          f"forward; total backward {sum(r[0] for r in rows):.3f}, forward "
          f"{sum(r[1] for r in rows):.3f}")
    for bwd, fwd, name, kind in sorted(rows, reverse=True):
        print(f"  {bwd:9.3f} / {fwd:8.3f}  {name:46s} {kind}")


def profile_train(blocks, top, steps=5, profiled=3):
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import ASSET
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import voxelize
    from pcc_geo_cnn_v2_tpu_torch.training import (
        TrainConfig,
        Trainer,
        draw_noise,
    )
    from pcc_geo_cnn_v2_tpu_torch.utils.data import BlockDataset

    cfg = TrainConfig(block_size=64, batch_size=32)
    phases = ("data", "voxelize", "forward + loss", "backward", "optimizer")
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(build_model("c3p"), cfg, tmp, seed=0, warm_start=ASSET)
        data = tr.device_data(BlockDataset(blocks))
        print(f"=== training c3p, batch {cfg.batch_size} of "
              f"{len(blocks)} blocks, f32: two warm-up steps")
        torch.cuda.reset_peak_memory_stats()
        for step in (1, 2):
            tr.step_blocks(data, step)
        torch.cuda.synchronize()
        times = []
        for step in range(3, 3 + steps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            t0 = time.time()
            ev[0].record()
            g = tr._generator(0, step)
            idx = torch.randint(0, len(data), (cfg.batch_size,),
                                generator=g, device=data.device)
            pts = data[idx].to(torch.int32)
            noise = draw_noise(tr.model, cfg.batch_size, cfg.block_size, g)
            ev[1].record()
            voxelize(pts, cfg.block_size)
            ev[2].record()
            tr.opt.zero_grad(set_to_none=True)
            total, _ = tr.loss_fn(pts, noise)
            ev[3].record()
            total.backward()
            ev[4].record()
            tr.opt.step()
            ev[5].record()
            torch.cuda.synchronize()
            times.append([ev[i].elapsed_time(ev[i + 1]) for i in range(5)]
                         + [1e3 * (time.time() - t0)])
        med = np.median(np.array(times), axis=0)
        print(f"median of {steps} steps, ms on the device's timeline "
              f"(between CUDA events):")
        for name, ms in zip(phases, med[:5]):
            print(f"  {name:16s} {ms:10.3f} ms  {100 * ms / med[5]:5.1f}% "
                  f"of the step")
        print(f"  step wall        {med[5]:10.3f} ms "
              f"({cfg.batch_size / med[5] * 1e3:.2f} blocks/s); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        layer_times(tr, data, cfg)
        print(f"=== training c3p: {profiled} steps under the profiler")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for step in range(100, 100 + profiled):
                tr.step_blocks(data, step)
            torch.cuda.synchronize()
            wall = time.time() - t0
        print(f"wall: {wall:.3f} s, {wall / profiled:.4f} s a step")
        return summarize(prof, wall, top)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's encode and decode paths.

    python3 tools/torch_profile_main_path.py [--seed 300] [--top 20]
        [--paths d1 A B C C_bf16 xla_bf16 c2 c1 host_fixed host_cut
         point_d2_cut]

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
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=300)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--paths", nargs="+", default=list(PATHS),
                    choices=list(PATHS))
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
    from torch.autograd import DeviceType
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
    wall = t_enc + t_dec
    # device-side events only (CPU ops also carry their kernels' time)
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and device_us(e) > 0]
    if not kern:
        print("the profiler recorded no device kernels")
        return 1
    total_us = sum(device_us(e) for e in kern)
    print(f"wall: encode {t_enc:.3f} s ({len(blocks) / t_enc:.2f} blocks/s),"
          f" decode of every stream {t_dec:.3f} s")
    print(f"device busy: {total_us / 1e6:.3f} s of {wall:.3f} s wall "
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


if __name__ == "__main__":
    sys.exit(main())

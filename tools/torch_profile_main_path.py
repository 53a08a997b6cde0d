#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's flagship encode and decode.

    python3 tools/torch_profile_main_path.py [--seed 300] [--top 20]

Runs the path ``chip_smoke.py`` drives (10-bit ``figure_cloud``, octree
level 4, c3p at full width with ``bench_c3p.msgpack.gz``, batch 32) once
to warm up, then once under ``torch.profiler`` on one GPU, and prints:

- the codec's host phase times (``logging`` INFO lines of
  ``pcc_geo_cnn_v2_tpu_torch.codec``),
- the wall time of encode and decode and the device-busy share (summed
  CUDA kernel time over wall time; kernels run on one stream),
- the top device kernels by total CUDA time, grouped into families
  (cuDNN convolution, sort, the port's K1/K2 kernels, other).

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import gzip
import io
import logging
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FAMILIES = (("K1 bucket_colsums", ("bucket_colsums",)),
            ("K2 halo_edt", ("halo_zpass", "halo_plane")),
            ("convolution", ("conv", "cudnn", "sm90_xmma", "implicit",
                             "gemm", "wgrad", "dgrad", "fprop")),
            ("sort", ("sort", "radix")),
            ("copy / fill", ("copy", "fill", "memset", "memcpy")))


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
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=300)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.coding.syntax import (
        load_compressed_file,
        save_compressed_file,
    )
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
    from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

    points = figure_cloud(args.seed, 1024, with_normals=False)
    blocks, binstr = partition_octree(points, [0, 0, 0], [1024] * 3, 4)
    codec = BlockCodec(build_model("c3p"), load_asset_tree(
        REPO / "pcc_geo_cnn_v2_tpu/assets/bench_c3p.msgpack.gz"),
        block_size=64, batch_blocks=32)

    def run():
        t0 = time.time()
        data_list, _ = codec.compress_blocks_device_opt(
            blocks, binstr, points, 1024, 4)
        blob = gzip.compress(save_compressed_file(binstr, data_list[0],
                                                  1024, 4))
        torch.cuda.synchronize()
        t1 = time.time()
        payload = load_compressed_file(io.BytesIO(gzip.decompress(blob)))[3]
        codec.decompress_blocks(payload)
        torch.cuda.synchronize()
        return t1 - t0, time.time() - t1

    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; {len(blocks)} blocks")
    print("warm-up run:")
    run()
    print("profiled run:")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_enc, t_dec = run()
    wall = t_enc + t_dec
    from torch.autograd import DeviceType

    # device-side events only (CPU ops also carry their kernels' time)
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and device_us(e) > 0]
    if not kern:
        print("the profiler recorded no device kernels")
        return 1
    total_us = sum(device_us(e) for e in kern)
    print(f"wall: encode {t_enc:.3f} s ({len(blocks) / t_enc:.2f} blocks/s),"
          f" decode {t_dec:.3f} s ({len(blocks) / t_dec:.2f} blocks/s)")
    print(f"device busy: {total_us / 1e6:.3f} s of {wall:.3f} s wall "
          f"({100 * total_us / 1e6 / wall:.1f}%); idle "
          f"{100 - 100 * total_us / 1e6 / wall:.1f}%")
    fams = {}
    for e in kern:
        fams[family(e.key)] = fams.get(family(e.key), 0.0) + device_us(e)
    for fam, us in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:20s} {us / 1e3:10.3f} ms  "
              f"{100 * us / max(total_us, 1):5.1f}% of device time")
    print(f"top {args.top} device kernels:")
    for e in sorted(kern, key=lambda e: -device_us(e))[:args.top]:
        print(f"  {device_us(e) / 1e3:10.3f} ms  {e.count:6d}x  "
              f"{e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""How far a fixed-threshold RD row moves with the convolutions' rounding.

    python3 tools/torch_probe_fixed_threshold.py [--run_id c1] [--seed 200]

On one GPU: ``tools/rd_eval --from-assets --fixed_threshold`` of the port
on ``figure_cloud(seed)`` (rows printed beside the committed
``results/rd_<run>_fixedthr.json``), then for every λ of the run the same
encode with the model's convolutions in f32 and in bf16 (host D1 PSNR and
decoded points of each), and how many voxels of the decoder's x_hat lie
within 1e-4, 1e-3, 1e-2 and 1e-1 of the middle threshold every block
takes. A row whose x_hat crowds the threshold moves with the arithmetic
of the convolutions, which differs between the card and the TPU that
wrote the committed rows.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_id", default="c1")
    ap.add_argument("--seed", type=int, default=200)
    args = ap.parse_args()

    import torch

    from chip_smoke import card_line
    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.native import load_host_lib
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import flatten_blocks, pack_coords
    from pcc_geo_cnn_v2_tpu_torch.tools import rd_eval
    from pcc_geo_cnn_v2_tpu_torch.tools.paths import ASSET_ROOT
    from pcc_geo_cnn_v2_tpu_torch.utils.metrics import compute_metrics
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import (
        departition_octree,
        partition_octree,
    )
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
    from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print("card:", card_line(), flush=True)
    kernels.build_all()
    load_host_lib("range_coder")
    load_host_lib("voxel_bits")
    config = args.run_id.split("-a")[0]
    name = "rd_" + args.run_id.replace("-", "_").replace(".", "")
    committed = json.loads(
        (REPO / "results" / f"{name}_fixedthr.json").read_text())
    rep = rd_eval.main(["--config", config, "--run_id", args.run_id,
                        "--from-assets", "--fixed_threshold", "--seeds",
                        str(args.seed), "--out",
                        f"results_torch/probe_{name}.json"])
    for r in rep["points"]:
        j = next(p for p in committed["points"] if p["lmbda"] == r["lmbda"]
                 and p["pc_name"] == r["pc_name"])
        print(f"row λ {r['lmbda']:g}: bpp {r['bpp']:.6f} (committed "
              f"{j['bpp']:.6f}, {r['bpp'] / j['bpp'] - 1:+.3e}), D1 "
              f"{r['d1_psnr']:.4f} (committed {j['d1_psnr']:.4f}, "
              f"{r['d1_psnr'] - j['d1_psnr']:+.4f})", flush=True)

    res, level, size, batch = 1024, 4, 64, 64
    pts, nrm = figure_cloud(args.seed, res, with_normals=True)
    blocks, binstr = partition_octree(pts, [0, 0, 0], [res] * 3, level)
    budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                 64)
    flat, offsets = flatten_blocks(blocks)
    flat_dev = torch.as_tensor(pack_coords(flat, size), device="cuda")
    for asset in sorted((ASSET_ROOT / args.run_id).glob("*.msgpack.gz")):
        params = load_asset_tree(asset)
        for dtype in (None, torch.bfloat16):
            codec = BlockCodec(build_model(config, dtype=dtype), params,
                               block_size=size, batch_blocks=batch,
                               device="cuda")
            thr = codec.thresholds[len(codec.thresholds) // 2]
            near = np.zeros(4, np.int64)
            for lo in range(0, len(blocks), batch):
                hi = min(lo + batch, len(blocks))
                chunk = codec.chunk_points(flat_dev, offsets, lo, hi, budget)
                x_hat = codec.canonical_chunk(chunk, hi - lo)["x_hat"]
                gap = (x_hat[:hi - lo, ..., 0] - thr).abs()
                near += np.array([int((gap < e).sum())
                                  for e in (1e-4, 1e-3, 1e-2, 1e-1)])
            data, _ = codec.compress_blocks(blocks, binstr, pts, res, level,
                                            fixed_threshold=True)
            dec = np.vstack(departition_octree(
                codec.decompress_blocks(data[0]), binstr, [0, 0, 0],
                [res] * 3, level))
            m = compute_metrics(pts, dec, res - 1, p1_n=nrm)
            print(f"{asset.name} {'bf16' if dtype else 'f32'}: D1 "
                  f"{m['d1_psnr']:.4f} dB, {len(dec)} decoded points; voxels "
                  f"within 1e-4 / 1e-3 / 1e-2 / 1e-1 of the threshold "
                  f"{thr:.5f}: {near.tolist()}", flush=True)


if __name__ == "__main__":
    main()

"""Train the weights of ``c3p_cw`` (c3p with the channel-wise context
model) and compare its coding with c3p's.

``train``: the modules ``c3p_cw`` adds to c3p (the mean hyper synthesis,
the scale hyper synthesis, which starts from c3p's, and the 24 slice
nets) are trained through ``training.Trainer.fit_blocks`` with c3p's own
modules loaded from its asset and frozen: λ 5e-5 and focal α 0.75 (the
rung of the asset), batch 32 of 64³ blocks, Adam at 1e-4 (1e-3 on the
quantiles, which are frozen with the z prior). The blocks are those of
``utils.scansim.figure_cloud`` seeds 400–459 for training and 460–463
for validation at 1024³, octree level 4 (disjoint from the benchmark's
300–307). ``--minutes`` bounds the steps' wall time. The best-validation
checkpoint's added modules are written as a flax asset, which
``weights.merge_trees`` lays over c3p's:

    python -m pcc_geo_cnn_v2_tpu_torch.tools.train_cw train models/c3p_cw \\
        --minutes 33 \\
        --asset pcc_geo_cnn_v2_tpu_torch/assets/c3p_cw/5.00e-05.msgpack.gz

``evaluate``: both models through the port's encoder
(``BlockCodec.compress_blocks_device_opt``, d1, full-cloud metrics) on
figures 300–307: one JSON line a model and cloud with its bpp (gzipped
container bits over input points), the encoder's D1 PSNR, the share of y
symbols coded through the range coder's overflow escape, whether the
stream decodes to the encoder's points, and whether the decoder's z and y
symbols and y scale rows are the fused encode's (``--debug``'s rule):

    python -m pcc_geo_cnn_v2_tpu_torch.tools.train_cw evaluate
"""

from __future__ import annotations

import argparse
import gzip
import json
import logging
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["BASE_ASSET", "CW_ASSET", "cloud_blocks", "train", "export",
           "escape_share", "evaluate", "main"]

REPO = Path(__file__).resolve().parents[2]
BASE_ASSET = (REPO / "pcc_geo_cnn_v2_tpu/assets/rd/c3p-a0.75"
              / "5.00e-05.msgpack.gz")
CW_ASSET = REPO / "pcc_geo_cnn_v2_tpu_torch/assets/c3p_cw/5.00e-05.msgpack.gz"
TRAIN_SEEDS = range(400, 460)
VAL_SEEDS = range(460, 464)
EVAL_SEEDS = range(300, 308)


def cloud_blocks(seed, resolution, level):
    """The octree blocks (local integer coordinates) of one figure."""
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud

    pts = figure_cloud(seed, resolution, with_normals=False)
    return partition_octree(pts, [0, 0, 0], [resolution] * 3, level)[0]


def _spawned(fn, seeds, *args, workers=None):
    """``fn(seed, *args)`` of every seed in spawned processes, in order."""
    seeds = list(seeds)
    workers = max(1, min(workers or os.cpu_count() or 1, len(seeds)))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        return list(pool.map(fn, seeds, *[[a] * len(seeds) for a in args]))


def _blocks(seeds, resolution, level, workers):
    """The blocks of every seed."""
    parts = _spawned(cloud_blocks, seeds, resolution, level, workers=workers)
    return [b for part in parts for b in part]


def train(out_dir, minutes, resolution=1024, level=4, device=None,
          train_seeds=TRAIN_SEEDS, val_seeds=VAL_SEEDS, base=BASE_ASSET,
          batch=32, lmbda=5e-5, alpha=0.75, seed=42, workers=None):
    """Train the added modules into ``out_dir`` (the trainer's checkpoints
    and ``train_log.jsonl``); returns the trainer."""
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.training import TrainConfig, Trainer
    from pcc_geo_cnn_v2_tpu_torch.utils.data import BlockDataset
    from pcc_geo_cnn_v2_tpu_torch.weights import (load_asset_tree,
                                                  params_from_jax)

    train_blocks = _blocks(train_seeds, resolution, level, workers)
    val_blocks = _blocks(val_seeds, resolution, level, workers)
    logger.info("%d training and %d validation blocks", len(train_blocks),
                len(val_blocks))
    model = build_model("c3p_cw")
    cfg = TrainConfig(lmbda=lmbda, alpha=alpha, batch_size=batch,
                      block_size=resolution >> level, max_steps=10 ** 9,
                      max_seconds=60.0 * minutes)
    trainer = Trainer(model, cfg, out_dir, seed=seed, device=device)
    if trainer.start_step == 0:
        missing, unexpected = trainer.model.load_state_dict(
            params_from_jax(load_asset_tree(base)), strict=False)
        if unexpected or any(not k.startswith(model.ADDED_PREFIXES)
                             for k in missing):
            raise ValueError(f"{base} is not c3p's: {unexpected or missing}")
    for name, p in trainer.model.named_parameters():
        p.requires_grad_(name.startswith(model.ADDED_PREFIXES))
    trainer.fit_blocks(BlockDataset(train_blocks), BlockDataset(val_blocks))
    return trainer


def export(out_dir, asset):
    """Write the added modules of ``out_dir``'s latest (best-validation)
    checkpoint as a flax asset."""
    from pcc_geo_cnn_v2_tpu_torch.models.codec_models import \
        CompressionModelCW
    from pcc_geo_cnn_v2_tpu_torch.training import load_params
    from pcc_geo_cnn_v2_tpu_torch.weights import save_asset

    params = load_params(out_dir)["params"]
    added = {k: v for k, v in params.items()
             if k.startswith(CompressionModelCW.ADDED_PREFIXES)}
    Path(asset).parent.mkdir(parents=True, exist_ok=True)
    save_asset({"params": added}, asset)
    return asset


def escape_share(y_sym, y_idx, table):
    """Share of the y symbols outside their scale-table row's regular
    buckets (coded through the overflow escape)."""
    b = np.asarray(y_sym, np.int64) - table.offset[y_idx]
    return float(np.mean((b < 0) | (b >= table.cdf_length[y_idx] - 2)))


def evaluate(device=None, seeds=EVAL_SEEDS, resolution=1024, level=4,
             batch_blocks=128, cw_asset=CW_ASSET, base=BASE_ASSET):
    """One dict a model and cloud (see the module docstring)."""
    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.coding.syntax import save_compressed_file
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
    from pcc_geo_cnn_v2_tpu_torch.weights import (load_asset_tree,
                                                  merge_trees)

    c3p = load_asset_tree(base)
    models = {"c3p": c3p,
              "c3p_cw": merge_trees(c3p, load_asset_tree(cw_asset))}
    clouds = dict(zip(seeds, _spawned(figure_cloud, seeds, resolution, 1.0,
                                      False)))
    rows = []
    for name, tree in models.items():
        codec = BlockCodec(build_model(name), tree,
                           block_size=resolution >> level, n_thresholds=256,
                           batch_blocks=batch_blocks, device=device,
                           sweep_backend="auto")
        for s, pts in clouds.items():
            blocks, binstr = partition_octree(pts, [0, 0, 0],
                                              [resolution] * 3, level)
            data_list, meta = codec.compress_blocks_device_opt(
                blocks, binstr, pts, resolution, level)
            raw = gzip.compress(save_compressed_file(
                binstr, data_list[0], resolution, level), mtime=0)
            syms = codec.encode_blocks(blocks)
            decoded, debug = codec.decompress_blocks(data_list[0],
                                                     return_debug=True)
            rows.append({
                "model": name, "figure": s, "points": len(pts),
                "blocks": len(blocks), "bpp": 8.0 * len(raw) / len(pts),
                "d1_psnr": float(meta[0]["metrics"]["d1_psnr"]),
                "escape_share": escape_share(syms["y_sym"], syms["y_idx"],
                                             codec.strings.y_table),
                "round_trip": all(np.array_equal(a, b) for a, b in zip(
                    decoded, meta[0]["x_hat_list"])),
                "symbols_equal": all(np.array_equal(syms[k], debug[k])
                                     for k in ("z_sym", "y_sym", "y_idx"))})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train")
    tr.add_argument("out_dir")
    tr.add_argument("--minutes", type=float, required=True)
    tr.add_argument("--asset", default=str(CW_ASSET))
    tr.add_argument("--device", default=None)
    ev = sub.add_parser("evaluate")
    ev.add_argument("--asset", default=str(CW_ASSET))
    ev.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.cmd == "train":
        train(args.out_dir, args.minutes, device=args.device)
        print(json.dumps({"asset": str(export(args.out_dir, args.asset)),
                          "bytes": Path(args.asset).stat().st_size}))
    else:
        evaluate(args.device, cw_asset=args.asset)


if __name__ == "__main__":
    main()

"""Train one (config, λ, α, γ) model on a glob of block PLYs.

The argv of ``pcc_geo_cnn_v2_tpu.cli.train`` plus ``--device``: same
positional args, flags and checkpoint-dir protocol (resume from the latest
``ckpt_<step>``, ``--warm_start``, best val-loss checkpoints, early stop,
``done`` marker). ``--warm_start`` also takes a ``.msgpack.gz`` asset.

Usage:
  python -m pcc_geo_cnn_v2_tpu_torch.cli.train "data/**/*.ply" \\
      ckpts/c3p-1e-4 --model_config c3p --lmbda 1e-4
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from pcc_geo_cnn_v2_tpu_torch.cli.common import (
    add_model_args,
    build_model_from_args,
)
from pcc_geo_cnn_v2_tpu_torch.models.configs import MODEL_CONFIGS
from pcc_geo_cnn_v2_tpu_torch.training import TrainConfig, Trainer
from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.data import BlockDataset

logger = logging.getLogger(__name__)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        prog="train",
        description="Train network",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("train_glob", help="Glob for training block PLYs.")
    parser.add_argument("checkpoint_dir", help="Checkpoint directory.")
    add_model_args(parser)
    parser.add_argument("--warm_start",
                        help="Checkpoint dir or .msgpack.gz asset for warm "
                             "start.")
    parser.add_argument("--resolution", type=int, default=64,
                        help="Block resolution.")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lmbda", type=float, default=1e-4)
    parser.add_argument("--alpha", type=float, default=0.9)
    parser.add_argument("--gamma", type=float, default=2.0)
    parser.add_argument("--max_steps", type=int, default=100_000)
    parser.add_argument("--val_every", type=int, default=500)
    parser.add_argument("--val_batches", type=int, default=10)
    parser.add_argument("--early_stop_patience", type=int, default=2000)
    parser.add_argument("--val_split", type=float, default=0.1,
                        help="Fraction of files for validation (by order).")
    parser.add_argument("--max_points", type=int, default=None,
                        help="Per-block point budget (default: dataset max).")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--profiling", action="store_true",
                        help="Write a torch.profiler trace of the run to "
                             "<checkpoint_dir>/profile.")
    parser.add_argument("--feed_loop", action="store_true",
                        help="Per-step host feeding (streaming datasets) "
                             "instead of the device-resident loop.")
    args = parser.parse_args(argv)

    if args.model_config not in MODEL_CONFIGS:
        parser.error(f"--model_config must be one of {list(MODEL_CONFIGS)}")
    model = build_model_from_args(args)

    files = pc_io.get_files(args.train_glob)
    if not files:
        parser.error(f"no files match {args.train_glob}")
    logger.info("loading %d block files", len(files))
    points = pc_io.load_points(files)
    n_val = max(int(len(points) * args.val_split), 1)
    train_ds = BlockDataset(points[:-n_val], max_points=args.max_points)
    val_ds = BlockDataset(points[-n_val:], max_points=train_ds.max_points)
    logger.info("train %d blocks, val %d blocks", len(train_ds), len(val_ds))

    cfg = TrainConfig(
        lmbda=args.lmbda, alpha=args.alpha, gamma=args.gamma,
        batch_size=args.batch_size, block_size=args.resolution,
        max_steps=args.max_steps, val_every=args.val_every,
        val_batches=args.val_batches,
        early_stop_patience=args.early_stop_patience,
    )
    trainer = Trainer(model, cfg, args.checkpoint_dir, seed=args.seed,
                      warm_start=args.warm_start, device=args.device)

    def run():
        if args.feed_loop:
            return trainer.fit(
                train_ds.batches(cfg.batch_size, seed=args.seed),
                lambda: val_ds.batches(cfg.batch_size, seed=args.seed + 1,
                                       repeat=False, shuffle=False))
        return trainer.fit_blocks(train_ds, val_ds)

    if args.profiling:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if trainer.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        out = Path(args.checkpoint_dir) / "profile"
        out.mkdir(parents=True, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            best = run()
        prof.export_chrome_trace(str(out / "trace.json"))
    else:
        best = run()
    logger.info("done, best val loss %s", best)


if __name__ == "__main__":
    main()

"""Encode point clouds: octree partition + batched block compression.

Same argv as ``pcc_geo_cnn_v2_tpu.cli.compress`` plus ``--device``:
gzipped bitstreams per (input × opt-metric group), ``.enc.metric.json``
sidecars, optional merged decode via ``--dec_files``. The threshold sweep
runs on the device (d1 metrics, and with ``--input_normals`` d2 metrics
too) unless ``--threshold_mode host``, ``--fixed_threshold`` or an opt
metric outside the device sweep's set sends the cloud to the host path
(``BlockCodec.compress_blocks``: KD-tree metrics per block), the JAX CLI's
rule.

    python -m pcc_geo_cnn_v2_tpu_torch.cli.compress --input_files in.ply \
        --output_files out.bin --checkpoint_dir \
        pcc_geo_cnn_v2_tpu/assets/bench_c3p.msgpack.gz --model_config c3p \
        --resolution 1024 --octree_level 4

With normals (a PLY holding nx, ny, nz per point) and one d1 plus one d2
opt metric, one output per metric:

    ... --input_files in.ply --input_normals in_normals.ply \
        --opt_metrics d1_mse d2_mse --output_files out_d1.bin out_d2.bin

The middle threshold for every block, with no sweep:

    ... --fixed_threshold

``--debug`` also writes ``<first output>.enc.debug.npz``, every array of
``BlockCodec.encode_blocks`` (the fused encode's symbols and x_hat), for
``decompress --debug`` to check the decoder's symbols against. With
several opt-metric groups there is one dump, under the first output, as
in the JAX CLI.
"""

from __future__ import annotations

import argparse
import gzip
import json
import logging
import os

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.cli.common import (
    add_model_args,
    build_model_from_args,
    load_params,
)
from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
from pcc_geo_cnn_v2_tpu_torch.coding.syntax import save_compressed_file
from pcc_geo_cnn_v2_tpu_torch.ops.threshold_sweep import (
    D1_METRICS,
    D2_METRICS,
)
from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.metrics import validate_opt_metrics
from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree

logger = logging.getLogger(__name__)


def _dedup_voxels(p):
    """Unique integer voxel coordinates (first occurrence kept): the
    sweep's point lists must match the occupancy grids exactly."""
    p = p.copy()
    p[:, :3] = np.round(p[:, :3])
    _, idx = np.unique(p[:, :3], axis=0, return_index=True)
    return p[np.sort(idx)] if len(idx) < len(p) else p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        prog="compress", description="Compress point clouds.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--input_files", nargs="+", required=True)
    parser.add_argument("--output_files", nargs="+", required=True,
                        help="One per input x opt-metric (when several).")
    parser.add_argument("--input_normals", nargs="+",
                        help="PLY files with nx ny nz per point; enables "
                             "d2 opt metrics.")
    parser.add_argument("--dec_files", nargs="*",
                        help="Write merged-decode PLYs at encode time.")
    parser.add_argument("--checkpoint_dir", required=True,
                        help="A .msgpack.gz weight asset or a training "
                             "directory (its latest ckpt_<step>).")
    add_model_args(parser)
    parser.add_argument("--opt_metrics", nargs="+", default=["d1_mse"])
    parser.add_argument("--max_deltas", nargs="+", default=[np.inf],
                        type=float)
    parser.add_argument("--fixed_threshold", action="store_true",
                        help="Every block at the middle threshold (host "
                             "path, no sweep).")
    parser.add_argument("--resolution", type=int, default=64)
    parser.add_argument("--octree_level", type=int, default=4)
    parser.add_argument("--batch_blocks", type=int, default=32)
    parser.add_argument("--threshold_mode", default="auto",
                        choices=["auto", "device", "host"],
                        help="auto: the device sweep where it covers the "
                             "opt metrics, else the host path.")
    parser.add_argument("--debug", action="store_true",
                        help="Dump encoder-side symbols for the decoder's "
                             "bit-exactness check.")
    args = parser.parse_args(argv)

    with_normals = args.input_normals is not None
    validate_opt_metrics(args.opt_metrics, with_normals=with_normals)
    use_device = (
        args.threshold_mode != "host"
        and not args.fixed_threshold
        and all(m in D1_METRICS + D2_METRICS for m in args.opt_metrics)
        and (with_normals or all(m in D1_METRICS for m in args.opt_metrics)))
    if args.threshold_mode == "device" and not use_device:
        parser.error("--threshold_mode device needs d1 / d2 opt metrics "
                     "and no --fixed_threshold")
    files_mult = len(args.opt_metrics) if len(args.opt_metrics) > 1 else 1
    assert files_mult * len(args.input_files) == len(args.output_files)
    if args.dec_files:
        assert files_mult * len(args.input_files) == len(args.dec_files)

    model = build_model_from_args(args)
    codec = BlockCodec(model, load_params(args.checkpoint_dir),
                       block_size=args.resolution // (2 ** args.octree_level),
                       batch_blocks=args.batch_blocks, device=args.device)
    points = pc_io.load_points(args.input_files)
    if with_normals:
        normals = [pc_io.read_ply(p, columns=["nx", "ny", "nz"])[0]
                   for p in args.input_normals]
        points = [np.hstack((p, n)) for p, n in zip(points, normals)]
    points = [_dedup_voxels(p) for p in points]
    for i, (infile, pts) in enumerate(zip(args.input_files, points)):
        blocks, binstr = partition_octree(
            pts, [0, 0, 0], [args.resolution] * 3, args.octree_level)
        logger.info("%s: %d blocks (device sweep: %s)", infile, len(blocks),
                    use_device)
        kw = dict(opt_metrics=tuple(args.opt_metrics),
                  max_deltas=tuple(args.max_deltas), with_normals=with_normals)
        if use_device:
            data_list, metadata = codec.compress_blocks_device_opt(
                blocks, binstr, pts, args.resolution, args.octree_level, **kw)
        else:
            data_list, metadata = codec.compress_blocks(
                blocks, binstr, pts, args.resolution, args.octree_level,
                fixed_threshold=args.fixed_threshold, **kw)
        assert len(data_list) == files_mult, (
            f"{len(data_list)} metric groups != {files_mult} output files")
        outs = [args.output_files[i * files_mult + j]
                for j in range(files_mult)]
        for j, (of, payload, meta) in enumerate(zip(outs, data_list,
                                                    metadata)):
            os.makedirs(os.path.dirname(of) or ".", exist_ok=True)
            with gzip.open(of, "wb") as f:
                f.write(save_compressed_file(binstr, payload,
                                             args.resolution,
                                             args.octree_level))
            with open(of + ".enc.metric.json", "w") as f:
                json.dump({k: v for k, v in meta["metrics"].items()
                           if np.isfinite(v)}, f, sort_keys=True, indent=4)
            if args.dec_files:
                pc_io.write_ply(args.dec_files[i * files_mult + j],
                                meta["blocks_full"][:, :3])
        if args.debug:
            np.savez_compressed(outs[0] + ".enc.debug.npz",
                                **codec.encode_blocks(blocks))
        logger.info("%s done -> %s", infile, ", ".join(outs))


if __name__ == "__main__":
    main()

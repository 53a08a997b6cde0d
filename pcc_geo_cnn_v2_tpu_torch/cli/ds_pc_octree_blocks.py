"""Split voxelized clouds into per-block PLYs named ``name_XXX.ply`` (port
of ``pcc_geo_cnn_v2_tpu.cli.ds_pc_octree_blocks``, the reference's
``ds_pc_octree_blocks.py``). These blocks are the training set.

    python -m pcc_geo_cnn_v2_tpu_torch.cli.ds_pc_octree_blocks \\
        ModelNet40_200_pc512 '**/*.ply' ModelNet40_200_pc512_oct3 \\
        --vg_size 512 --level 3
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing
from pathlib import Path

from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree

logger = logging.getLogger(__name__)


def split_one(args):
    in_path, out_dir, vg_size, level = args
    pts, _ = pc_io.read_ply(in_path, columns=["x", "y", "z"])
    blocks, _ = partition_octree(pts, [0, 0, 0], [vg_size] * 3, level)
    stem = Path(in_path).stem
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, block in enumerate(blocks):
        pc_io.write_ply(out_dir / f"{stem}_{i:03d}.ply", block[:, :3])
    logger.info("%s -> %d blocks", in_path, len(blocks))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="ds_pc_octree_blocks")
    parser.add_argument("input_dir")
    parser.add_argument("input_pattern", help="e.g. '**/*.ply'")
    parser.add_argument("output_dir")
    parser.add_argument("--vg_size", type=int, default=512)
    parser.add_argument("--level", type=int, default=3)
    parser.add_argument("--processes", type=int, default=None)
    args = parser.parse_args(argv)

    files = sorted(Path(args.input_dir).glob(args.input_pattern))
    if not files:
        parser.error("no clouds matched")
    work = []
    for f in files:
        rel_dir = (Path(args.output_dir)
                   / f.relative_to(args.input_dir)).parent
        work.append((str(f), str(rel_dir), args.vg_size, args.level))
    with multiprocessing.get_context("spawn").Pool(args.processes) as pool:
        pool.map(split_one, work)


if __name__ == "__main__":
    main()

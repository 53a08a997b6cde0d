"""Decode bitstreams back to point clouds.

Same argv as ``pcc_geo_cnn_v2_tpu.cli.decompress`` plus ``--device``:

    python -m pcc_geo_cnn_v2_tpu_torch.cli.decompress --input_files out.bin \
        --output_files dec.ply --checkpoint_dir \
        pcc_geo_cnn_v2_tpu/assets/bench_c3p.msgpack.gz --model_config c3p
"""

from __future__ import annotations

import argparse
import gzip
import logging
import os

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.cli.common import (
    add_model_args,
    build_model_from_args,
    load_params,
)
from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
from pcc_geo_cnn_v2_tpu_torch.coding.syntax import load_compressed_file
from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.octree import departition_octree

logger = logging.getLogger(__name__)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        prog="decompress", description="Decompress point clouds.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--input_files", nargs="+", required=True)
    parser.add_argument("--output_files", nargs="+", required=True)
    parser.add_argument("--checkpoint_dir", required=True,
                        help="A .msgpack.gz weight asset.")
    add_model_args(parser)
    parser.add_argument("--batch_blocks", type=int, default=32)
    args = parser.parse_args(argv)
    assert len(args.input_files) == len(args.output_files)

    model = build_model_from_args(args)
    params = load_params(args.checkpoint_dir)
    codec = None
    for infile, outfile in zip(args.input_files, args.output_files):
        with gzip.open(infile, "rb") as f:
            resolution, level, binstr, payload = load_compressed_file(f)
        block_size = resolution // (2 ** level)
        if codec is None or codec.block_size != block_size:
            codec = BlockCodec(model, params, block_size=block_size,
                               batch_blocks=args.batch_blocks,
                               device=args.device)
        dec_blocks = departition_octree(
            codec.decompress_blocks(payload), binstr, [0, 0, 0],
            [resolution] * 3, level)
        cloud = (np.vstack(dec_blocks)[:, :3]
                 if dec_blocks else np.zeros((0, 3), np.float32))
        os.makedirs(os.path.dirname(outfile) or ".", exist_ok=True)
        pc_io.write_ply(outfile, cloud)
        logger.info("%s -> %s (%d points)", infile, outfile, len(cloud))


if __name__ == "__main__":
    main()

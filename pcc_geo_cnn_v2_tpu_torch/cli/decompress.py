"""Decode bitstreams back to point clouds.

Same argv as ``pcc_geo_cnn_v2_tpu.cli.decompress`` plus ``--device``:

    python -m pcc_geo_cnn_v2_tpu_torch.cli.decompress --input_files out.bin \
        --output_files dec.ply --checkpoint_dir \
        pcc_geo_cnn_v2_tpu/assets/bench_c3p.msgpack.gz --model_config c3p

``--debug`` checks the decoded ``y_sym`` / ``z_sym`` against the dump
``compress --debug`` wrote beside the stream (``<input>.enc.debug.npz``)
and raises an ``AssertionError`` naming the key that differs.
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


def _check_debug_dump(dbg, dump_path):
    """The decoder's symbols equal the encoder's dump, key by key where
    both sides have the key, as int32."""
    dump = np.load(dump_path)
    for key in ("y_sym", "z_sym"):
        if key in dump and key in dbg:
            np.testing.assert_array_equal(
                np.asarray(dbg[key]).astype(np.int32),
                dump[key].astype(np.int32),
                err_msg=f"{key} mismatch vs {dump_path}")
    logger.info("debug: decoded symbols bit-exact vs encoder dump")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        prog="decompress", description="Decompress point clouds.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--input_files", nargs="+", required=True)
    parser.add_argument("--output_files", nargs="+", required=True)
    parser.add_argument("--checkpoint_dir", required=True,
                        help="A .msgpack.gz weight asset or a training "
                             "directory (its latest ckpt_<step>).")
    add_model_args(parser)
    parser.add_argument("--batch_blocks", type=int, default=32)
    parser.add_argument("--debug", action="store_true",
                        help="Verify decoded symbols against the encoder's "
                             "--debug dump (bit-exactness harness).")
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
        if args.debug:
            dec_blocks, dbg = codec.decompress_blocks(payload,
                                                      return_debug=True)
            _check_debug_dump(dbg, infile + ".enc.debug.npz")
        else:
            dec_blocks = codec.decompress_blocks(payload)
        dec_blocks = departition_octree(dec_blocks, binstr, [0, 0, 0],
                                        [resolution] * 3, level)
        cloud = (np.vstack(dec_blocks)[:, :3]
                 if dec_blocks else np.zeros((0, 3), np.float32))
        os.makedirs(os.path.dirname(outfile) or ".", exist_ok=True)
        pc_io.write_ply(outfile, cloud)
        logger.info("%s -> %s (%d points)", infile, outfile, len(cloud))


if __name__ == "__main__":
    main()

"""Symlink the N largest files from a tree (port of
``pcc_geo_cnn_v2_tpu.cli.ds_select_largest``, the reference's
``ds_select_largest.py``).

Used to pick the 200 largest ModelNet meshes for the training set.

    python -m pcc_geo_cnn_v2_tpu_torch.cli.ds_select_largest \\
        ModelNet40 '**/*.off' ModelNet40_200 200
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

logger = logging.getLogger(__name__)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="ds_select_largest")
    parser.add_argument("input_dir")
    parser.add_argument("input_pattern", help="e.g. '**/*.off'")
    parser.add_argument("output_dir")
    parser.add_argument("n", type=int)
    args = parser.parse_args(argv)

    files = sorted(
        Path(args.input_dir).glob(args.input_pattern),
        key=lambda p: p.stat().st_size,
        reverse=True,
    )[: args.n]
    if not files:
        parser.error("no files matched")
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for f in files:
        rel = f.relative_to(args.input_dir)
        dst = out / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        if dst.is_symlink() or dst.exists():
            dst.unlink()
        os.symlink(f.resolve(), dst)
    logger.info("linked %d files into %s", len(files), out)


if __name__ == "__main__":
    main()

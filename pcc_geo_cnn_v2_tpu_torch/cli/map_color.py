"""Transfer colours from an original cloud to a decoded one by nearest
neighbour (the port's own copy of ``pcc_geo_cnn_v2_tpu/cli/map_color.py``;
the reference's ``src/map_color.py``).

    python -m pcc_geo_cnn_v2_tpu_torch.cli.map_color ori.ply dec.ply out.ply
"""

from __future__ import annotations

import argparse
import logging
import subprocess
import sys

import numpy as np
from scipy.spatial import cKDTree

from pcc_geo_cnn_v2_tpu_torch.utils import pc_io

logger = logging.getLogger(__name__)

__all__ = ["map_color", "run_mapcolor", "main"]


def map_color(ori_path, target_path, output_path):
    ori, names = pc_io.read_ply(ori_path)
    assert all(c in names for c in ("red", "green", "blue")), (
        f"{ori_path} has no colors ({names})")
    cols = [names.index(c) for c in ("red", "green", "blue")]
    target, _ = pc_io.read_ply(target_path, columns=["x", "y", "z"])
    tree = cKDTree(ori[:, :3], balanced_tree=False)
    _, idx = tree.query(target, workers=-1)
    rgb = ori[idx][:, cols]
    out = np.hstack([target, rgb])
    pc_io.write_ply(output_path, out,
                    ["x", "y", "z", "red", "green", "blue"],
                    dtypes=["f4"] * 3 + ["u1"] * 3)
    logger.info("%s + %s -> %s (%d points)", ori_path, target_path,
                output_path, len(out))


def run_mapcolor(ori, target, output, stdout=None, stderr=None):
    """Popen helper for pipeline drivers (reference map_color.py:42-43)."""
    return subprocess.Popen(
        [sys.executable, "-m", "pcc_geo_cnn_v2_tpu_torch.cli.map_color",
         ori, target, output],
        stdout=stdout, stderr=stderr)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="map_color")
    parser.add_argument("ori_path")
    parser.add_argument("target_path")
    parser.add_argument("output_path")
    args = parser.parse_args(argv)
    map_color(args.ori_path, args.target_path, args.output_path)


if __name__ == "__main__":
    main()

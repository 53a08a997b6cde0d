"""Render the decoded clouds of an experiment beside their originals: the
port's own copy of ``pcc_geo_cnn_v2_tpu/cli/ut_run_render.py`` (reference
``src/ut_run_render.py``, Open3D-optional, see ``utils/render``), same argv.

Walks ``experiment_dir/*/*/*/*.dec.ply`` (the layout ``ev_run_experiment``
writes) and writes ``<name>.dec.render.png`` plus its colorbar beside each
decode; a render that exists is kept, a cloud with no original in the
YAML's ``data`` is warned about and an empty decode is skipped.

    python -m pcc_geo_cnn_v2_tpu_torch.cli.ut_run_render experiment.yml \\
        [--img_size 1024] [--axis 2]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.render import render_comparison

logger = logging.getLogger(__name__)

__all__ = ["main"]


def main(argv=None):
    import yaml

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="ut_run_render")
    parser.add_argument("experiment_yml")
    parser.add_argument("--img_size", type=int, default=1024)
    parser.add_argument("--axis", type=int, default=2)
    args = parser.parse_args(argv)

    spec = yaml.safe_load(Path(args.experiment_yml).read_text())
    exp_dir = Path(spec["experiment_dir"])
    originals = {d["pc_name"]: d["input_pc"] for d in spec["data"]}

    n = 0
    for dec in sorted(exp_dir.glob("*/*/*/*.dec.ply")):
        out_png = dec.with_suffix(".render.png")
        if out_png.exists():
            continue
        pc_name = dec.parts[len(exp_dir.parts)]
        ori_path = originals.get(pc_name)
        if ori_path is None:
            logger.warning("no original for %s", pc_name)
            continue
        ori, _ = pc_io.read_ply(ori_path, columns=["x", "y", "z"])
        pts, _ = pc_io.read_ply(dec, columns=["x", "y", "z"])
        if len(pts) == 0:
            continue
        render_comparison(ori, pts, out_png, axis=args.axis,
                          img_size=args.img_size)
        n += 1
    logger.info("rendered %d comparisons", n)


if __name__ == "__main__":
    main()

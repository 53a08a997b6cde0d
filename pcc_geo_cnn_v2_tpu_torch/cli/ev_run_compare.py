"""Fan ``ev_compare`` over point clouds × metrics and merge the per-cloud
CSVs into ``results/{data,bdrate,bdsnr}.csv`` (the port's own copy of
``pcc_geo_cnn_v2_tpu/cli/ev_run_compare.py``; the reference's
``src/ev_run_compare.py``).

    python -m pcc_geo_cnn_v2_tpu_torch.cli.ev_run_compare experiment.yml \\
        [--metrics d1_psnr] [--no_plot]

pandas and PyYAML are imported in ``main``, matplotlib where it draws.
"""

from __future__ import annotations

import argparse
import glob
import logging
from pathlib import Path

from pcc_geo_cnn_v2_tpu_torch.cli import ev_compare

logger = logging.getLogger(__name__)

__all__ = ["main"]


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="ev_run_compare")
    parser.add_argument("experiment_yml")
    parser.add_argument("--metrics", nargs="+",
                        default=["d1_psnr", "d2_psnr"])
    parser.add_argument("--no_plot", action="store_true")
    args = parser.parse_args(argv)
    import pandas as pd
    import yaml

    spec = yaml.safe_load(Path(args.experiment_yml).read_text())
    exp_dir = Path(spec["experiment_dir"])
    results = exp_dir / "results"
    results.mkdir(parents=True, exist_ok=True)
    bd_ignore = spec.get("bd_ignore", [])

    # the global mode list, up front: it fixes each mode's plot style in
    # every figure, so that the shared legend strip stays true even where a
    # point cloud lacks a mode
    style_modes = sorted({
        Path(p).parts[-3]
        for p in glob.glob(str(exp_dir / "*" / "*" / "*" / "report_*.json"))
    })

    for data in spec["data"]:
        for metric in args.metrics:
            try:
                ev_compare.main(
                    [str(exp_dir), data["pc_name"], str(results),
                     "--metric", metric, "--bd_ignore", *bd_ignore]
                    + (["--style_modes", *style_modes] if style_modes
                       else [])
                    + (["--no_plot"] if args.no_plot else []))
            except AssertionError:
                logger.warning("no %s reports for %s", metric,
                               data["pc_name"])

    # the shared legend strip of the per-cloud RD plots
    # (reference ev_run_compare.py:76-102)
    if not args.no_plot:
        modes = set()
        for p in sorted(results.glob("*_data.csv")):
            modes.update(pd.read_csv(p)["mode_id"].unique())
        if modes:
            from pcc_geo_cnn_v2_tpu_torch.utils.plots import (
                render_standalone_legend,
            )

            render_standalone_legend(style_modes or sorted(modes),
                                     results / "legend.png")

    # merge
    for kind in ("data", "bdrate", "bdsnr"):
        parts = sorted(results.glob(f"*_{kind}.csv"))
        if not parts:
            continue
        frames = []
        for p in parts:
            df = pd.read_csv(p)
            df.insert(0, "source", p.stem)
            frames.append(df)
        pd.concat(frames).to_csv(results / f"{kind}.csv", index=False)
        logger.info("merged %d files into %s.csv", len(parts), kind)


if __name__ == "__main__":
    main()

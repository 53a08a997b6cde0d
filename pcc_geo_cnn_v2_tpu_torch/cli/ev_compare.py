"""RD curves and pairwise BD matrices from report JSONs (the port's own
copy of ``pcc_geo_cnn_v2_tpu/cli/ev_compare.py``; the reference's
``src/ev_compare.py``): a rate-distortion plot per point cloud, a
``*_data.csv`` of every curve point, and BD-rate / BD-PSNR matrices.

    python -m pcc_geo_cnn_v2_tpu_torch.cli.ev_compare experiments/ \\
        loot_vox10_1200 results/ [--metric d1_psnr] [--no_plot]

pandas and matplotlib are imported inside the functions that need them.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
from pathlib import Path

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.utils.bd import bdrate, bdsnr

logger = logging.getLogger(__name__)

__all__ = ["load_curves", "plot_rd", "bd_matrices", "main"]


def load_curves(experiment_dir, pc_name, metric_key, opt_group,
                bd_ignore=()):
    """mode_id → sorted [(bpp, psnr), ...] from the report_*.json files
    under ``experiment_dir/pc_name/<mode_id>/<lmbda>/``."""
    curves = {}
    pattern = str(Path(experiment_dir) / pc_name / "*" / "*"
                  / f"report_{opt_group}.json")
    for path in sorted(glob.glob(pattern)):
        parts = Path(path).parts
        mode_id, lmbda = parts[-3], parts[-2]
        if f"{mode_id}/{lmbda}" in bd_ignore:
            continue
        rep = json.loads(Path(path).read_text())
        if metric_key not in rep:
            continue
        curves.setdefault(mode_id, []).append((rep["bpp"], rep[metric_key]))
    return {k: sorted(v) for k, v in curves.items()}


def plot_rd(curves, title, ylabel, out_path, style_order=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from pcc_geo_cnn_v2_tpu_torch.utils.plots import (
        set_paper_style,
        style_for,
    )

    set_paper_style()
    style_order = style_order or sorted(curves)
    fig, ax = plt.subplots(figsize=(5, 4))
    for mode, pts in sorted(curves.items()):
        marker, ls = style_for(mode, style_order)
        arr = np.array(pts)
        ax.plot(arr[:, 0], arr[:, 1], marker=marker, linestyle=ls,
                markersize=4, label=mode)
    ax.set_xlabel("bits per input point")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(alpha=0.4)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def bd_matrices(curves, pchip=True):
    """(BD-rate, BD-PSNR) DataFrames over every ordered pair of modes; a
    pair whose curves do not overlap is NaN."""
    import pandas as pd

    modes = sorted(curves)
    n = len(modes)
    rate = np.full((n, n), np.nan)
    snr = np.full((n, n), np.nan)
    for i, a in enumerate(modes):
        for j, b in enumerate(modes):
            if i == j or len(curves[a]) < 2 or len(curves[b]) < 2:
                continue
            try:
                rate[i, j] = bdrate(curves[a], curves[b], pchip=pchip)
                snr[i, j] = bdsnr(curves[a], curves[b], pchip=pchip)
            except Exception as e:  # disjoint ranges etc.
                logger.warning("BD %s vs %s failed: %s", a, b, e)
    return (pd.DataFrame(rate, index=modes, columns=modes),
            pd.DataFrame(snr, index=modes, columns=modes))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="ev_compare")
    parser.add_argument("experiment_dir")
    parser.add_argument("pc_name")
    parser.add_argument("output_dir")
    parser.add_argument("--metric", default="d1_psnr",
                        choices=["d1_psnr", "d2_psnr"])
    parser.add_argument("--opt_group", default=None,
                        help="default: metric prefix (d1/d2)")
    parser.add_argument("--bd_ignore", nargs="*", default=[],
                        help="mode_id/lambda entries to drop from BD stats")
    parser.add_argument("--no_plot", action="store_true")
    parser.add_argument("--style_modes", nargs="*", default=None,
                        help="global mode list fixing each mode's plot "
                             "style across figures (shared legends)")
    args = parser.parse_args(argv)
    import pandas as pd

    group = args.opt_group or args.metric[:2]
    curves = load_curves(args.experiment_dir, args.pc_name, args.metric,
                         group, bd_ignore=args.bd_ignore)
    assert curves, "no reports found"
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    rows = [
        {"pc_name": args.pc_name, "mode_id": mode, "metric": args.metric,
         "x": x, "y": y}
        for mode, pts in curves.items() for x, y in pts
    ]
    data_path = out / f"{args.pc_name}_{args.metric}_data.csv"
    pd.DataFrame(rows).to_csv(data_path, index=False)

    rate_df, snr_df = bd_matrices(curves)
    rate_df.to_csv(out / f"{args.pc_name}_{args.metric}_bdrate.csv")
    snr_df.to_csv(out / f"{args.pc_name}_{args.metric}_bdsnr.csv")
    if not args.no_plot:
        plot_rd(curves, args.pc_name, args.metric.replace("_", " ").upper(),
                out / f"{args.pc_name}_{args.metric}_rd.png",
                style_order=args.style_modes)
    logger.info("wrote %s and BD matrices", data_path)


if __name__ == "__main__":
    main()

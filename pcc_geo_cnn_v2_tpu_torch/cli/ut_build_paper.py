"""LaTeX result tables from merged BD CSVs (port of
``pcc_geo_cnn_v2_tpu.cli.ut_build_paper``, the reference's
``src/ut_build_paper.py``: bold best / italic second-best). pandas is
imported by :func:`main`.

    python -m pcc_geo_cnn_v2_tpu_torch.cli.ut_build_paper bdsnr.csv \\
        table.tex --anchor c1
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def format_table(df, higher_better=True):
    """Per-row bold best and italic second-best LaTeX table."""
    lines = [" & ".join(["PC"] + list(df.columns)) + r" \\ \midrule"]
    for idx, row in df.iterrows():
        vals = row.values.astype(float)
        order = np.argsort(-vals if higher_better else vals)
        rank = {order[0]: 0}
        if len(order) > 1:
            rank[order[1]] = 1
        cells = []
        for j, v in enumerate(vals):
            s = f"{v:.2f}"
            if rank.get(j) == 0:
                s = rf"\textbf{{{s}}}"
            elif rank.get(j) == 1:
                s = rf"\textit{{{s}}}"
            cells.append(s)
        lines.append(" & ".join([str(idx)] + cells) + r" \\")
    return "\n".join(lines)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="ut_build_paper")
    parser.add_argument("bd_csv", help="Merged bdsnr.csv or bdrate.csv.")
    parser.add_argument("output_tex")
    parser.add_argument("--anchor", required=True,
                        help="Row (anchor mode_id) to compare against.")
    parser.add_argument("--lower_better", action="store_true")
    args = parser.parse_args(argv)
    import pandas as pd

    # merged format (ev_run_compare): [source, <unnamed mode index>, modes…]
    df = pd.read_csv(args.bd_csv)
    mode_col = df.columns[1]
    rows = {}
    for src, group in df.groupby("source"):
        pc = src.rsplit("_", 2)[0]
        g = group.set_index(mode_col).drop(columns=["source"])
        if args.anchor not in g.index:
            continue
        rows[pc] = g.loc[args.anchor].drop(args.anchor, errors="ignore")
    table = pd.DataFrame(rows).T.astype(float)
    tex = format_table(table, higher_better=not args.lower_better)
    Path(args.output_tex).write_text(tex)
    logger.info("wrote %s (%d rows)", args.output_tex, len(table))


if __name__ == "__main__":
    main()

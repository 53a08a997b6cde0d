"""Training-curve plots from ``train_log.jsonl`` files (the port's own copy
of ``pcc_geo_cnn_v2_tpu/cli/ut_train_plots.py``; the reference's
``src/ut_tensorboard_plots.py`` read tfevents). The port's trainer writes
the same JSONL records.

    python -m pcc_geo_cnn_v2_tpu_torch.cli.ut_train_plots models/ plots/
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

logger = logging.getLogger(__name__)

__all__ = ["read_log", "main"]


def read_log(path, split="train"):
    """(steps, {key: values}) of the records of ``split`` in one log."""
    steps, series = [], {}
    for line in Path(path).read_text().splitlines():
        rec = json.loads(line)
        if rec.get("split") != split:
            continue
        steps.append(rec["step"])
        for k, v in rec.items():
            if isinstance(v, (int, float)) and k != "step":
                series.setdefault(k, []).append(v)
    return steps, series


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="ut_train_plots")
    parser.add_argument("model_dir",
                        help="Root dir containing */*/train_log.jsonl.")
    parser.add_argument("output_dir")
    parser.add_argument("--keys", nargs="+",
                        default=["loss", "focal_loss", "mbpov"])
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    logs = sorted(Path(args.model_dir).glob("**/train_log.jsonl"))
    assert logs, "no train logs found"
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for key in args.keys:
        fig, ax = plt.subplots(figsize=(6, 4))
        for log in logs:
            steps, series = read_log(log)
            if key not in series:
                continue
            label = "/".join(log.parent.parts[-2:])
            ax.plot(steps, series[key], label=label, linewidth=1)
        ax.set_xlabel("step")
        ax.set_ylabel(key)
        ax.set_yscale("log" if key == "loss" else "linear")
        ax.grid(alpha=0.4)
        ax.legend(fontsize=6)
        fig.tight_layout()
        fig.savefig(out / f"train_{key}.png", dpi=150)
        plt.close(fig)
        logger.info("wrote train_%s.png (%d runs)", key, len(logs))


if __name__ == "__main__":
    main()

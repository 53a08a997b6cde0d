"""Build ``report.json`` for a G-PCC (tmc3) anchor run from its logs (the
port's own copy of ``pcc_geo_cnn_v2_tpu/cli/mp_report.py``; the
reference's ``src/mp_report.py``): the positions bitstream size and bpp
from the encoder log, D1 / D2 from the pc_error log.

    python -m pcc_geo_cnn_v2_tpu_torch.cli.mp_report in.ply enc.log \\
        pc_error.log report.json
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.mpeg_parsing import (
    parse_bin_log,
    parse_pcerror,
)

logger = logging.getLogger(__name__)

__all__ = ["main"]


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="mp_report")
    parser.add_argument("input_pc", help="Original point cloud (for bpp).")
    parser.add_argument("bin_log", help="tmc3 encoder log.")
    parser.add_argument("pcerror_log", help="pc_error output log.")
    parser.add_argument("output_report", help="report.json path.")
    args = parser.parse_args(argv)

    bin_info = parse_bin_log(args.bin_log)
    metrics = parse_pcerror(args.pcerror_log)
    n_points = len(pc_io.read_ply(args.input_pc, columns=["x", "y", "z"])[0])
    report = {
        **bin_info,
        **metrics,
        "input_point_count": n_points,
        "bpp": bin_info["pos_bitstream_size_in_bytes"] * 8 / n_points,
    }
    Path(args.output_report).write_text(
        json.dumps(report, sort_keys=True, indent=4))
    logger.info("wrote %s", args.output_report)


if __name__ == "__main__":
    main()

"""Run G-PCC (tmc3) anchors: encode / decode at several rates, evaluate,
report (the port's own copy of ``pcc_geo_cnn_v2_tpu/cli/mp_run.py``; the
reference's ``src/mp_run.py``).

    python -m pcc_geo_cnn_v2_tpu_torch.cli.mp_run in.ply anchors/ \\
        [--tmc3 builtin] [--rates 0.5 0.25] [--resolution 1024]

``--tmc3 builtin`` (the default, unless $TMC3 is set) is the in-repo octree
anchor (``coding/octree_anchor.py``); a path runs the external MPEG tmc3
binary with the reference's argv, and ``--pc_error`` the external metric
binary. Anchors are for comparison only; the learned codec never depends
on them. Rate points follow the CTC configs: positionQuantizationScale in
octree mode, trisoupNodeSizeLog2 in trisoup mode.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
from pathlib import Path

from pcc_geo_cnn_v2_tpu_torch.cli.mp_report import main as mp_report_main

logger = logging.getLogger(__name__)

__all__ = ["OCTREE_SCALES", "TRISOUP_NODE_SIZES", "encode_decode", "main"]

OCTREE_SCALES = [0.75, 0.5, 0.25, 0.125, 0.0625]
TRISOUP_NODE_SIZES = [2, 3, 4]


def _run(cmd, log_path):
    logger.info("run: %s", " ".join(map(str, cmd)))
    with open(log_path, "w") as f:
        subprocess.run([str(c) for c in cmd], stdout=f,
                       stderr=subprocess.STDOUT, check=True)


def encode_decode(tmc3, in_pc, out_dir, mode, rate_param):
    """One rate point: ``compressed.bin``, ``decoded.ply`` and the encoder
    log in ``out_dir`` (each stage skipped when its output exists)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    bin_path = out_dir / "compressed.bin"
    dec_path = out_dir / "decoded.ply"
    enc_log = out_dir / "enc.log"
    dec_log = out_dir / "dec.log"
    if tmc3 == "builtin":
        # the self-contained octree anchor: the same files and log format
        assert mode == "octree", "builtin anchor implements octree mode"
        from pcc_geo_cnn_v2_tpu_torch.coding.octree_anchor import (
            anchor_decode,
            anchor_encode,
            write_tmc3_style_log,
        )
        from pcc_geo_cnn_v2_tpu_torch.utils import pc_io

        if not bin_path.exists() or not dec_path.exists():
            pts = pc_io.read_ply(in_pc, columns=["x", "y", "z"])[0]
            data = anchor_encode(pts, int(pts.max()) + 1,
                                 scale=float(rate_param))
            bin_path.write_bytes(data)
            write_tmc3_style_log(enc_log, in_pc, len(pts), len(data))
            dec, _ = anchor_decode(bin_path.read_bytes())
            pc_io.write_ply(dec_path, dec)
            dec_log.write_text(f"decoded {len(dec)} points\n")
        return bin_path, dec_path, enc_log
    if not bin_path.exists():
        cmd = [
            tmc3, "--mode=0", f"--uncompressedDataPath={in_pc}",
            f"--compressedStreamPath={bin_path}",
            "--disableAttributeCoding=1",
        ]
        if mode == "octree":
            cmd.append(f"--positionQuantizationScale={rate_param}")
        else:  # trisoup
            cmd += [
                "--positionQuantizationScale=1",
                f"--trisoupNodeSizeLog2={rate_param}",
            ]
        _run(cmd, enc_log)
    if not dec_path.exists():
        _run([tmc3, "--mode=1", f"--compressedStreamPath={bin_path}",
              f"--reconstructedDataPath={dec_path}",
              "--outputBinaryPly=1"], dec_log)
    return bin_path, dec_path, enc_log


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="mp_run")
    parser.add_argument("input_pc")
    parser.add_argument("output_dir")
    parser.add_argument("--tmc3", default=os.environ.get("TMC3", "builtin"),
                        help="Path to the tmc3 binary, or 'builtin' for "
                             "the in-repo octree anchor codec "
                             "(coding/octree_anchor.py).")
    parser.add_argument("--pc_error", default=os.environ.get("PC_ERROR"))
    parser.add_argument("--input_norm", default=None)
    parser.add_argument("--mode", default="octree",
                        choices=["octree", "trisoup"])
    parser.add_argument("--rates", nargs="*", type=float, default=None)
    parser.add_argument("--resolution", type=int, default=1024)
    args = parser.parse_args(argv)

    rates = args.rates or (
        OCTREE_SCALES if args.mode == "octree" else TRISOUP_NODE_SIZES)
    for rate in rates:
        run_dir = Path(args.output_dir) / args.mode / f"r{rate:g}"
        report = run_dir / "report.json"
        if report.exists():
            logger.info("%s exists, skipping", report)
            continue
        bin_path, dec_path, enc_log = encode_decode(
            args.tmc3, args.input_pc, run_dir, args.mode, rate)
        pcerr_log = run_dir / "pc_error.log"
        if args.pc_error and not pcerr_log.exists():
            cmd = [
                args.pc_error, f"--fileA={args.input_pc}",
                f"--fileB={dec_path}", "--color=0",
                f"--resolution={args.resolution - 1}", "--dropdups=0",
            ]
            if args.input_norm:
                cmd.append(f"--inputNorm={args.input_norm}")
            _run(cmd, pcerr_log)
        if pcerr_log.exists():
            mp_report_main([args.input_pc, str(enc_log), str(pcerr_log),
                            str(report)])
        else:
            # the report from the in-repo metrics
            from pcc_geo_cnn_v2_tpu_torch.cli.ev_experiment import (
                _internal_metrics,
            )
            from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
            from pcc_geo_cnn_v2_tpu_torch.utils.mpeg_parsing import (
                parse_bin_log,
            )

            bin_info = parse_bin_log(enc_log)
            n = len(pc_io.read_ply(args.input_pc,
                                   columns=["x", "y", "z"])[0])
            rep = {
                **bin_info,
                **_internal_metrics(args.input_pc, str(dec_path),
                                    args.input_norm, args.resolution),
                "input_point_count": n,
                "bpp": bin_info["pos_bitstream_size_in_bytes"] * 8 / n,
            }
            report.write_text(json.dumps(rep, sort_keys=True, indent=4))
        logger.info("wrote %s", report)


if __name__ == "__main__":
    main()

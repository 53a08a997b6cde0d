"""Stand-in for the MPEG ``pc_error_d`` binary (the port's own metrics).

    python -m pcc_geo_cnn_v2_tpu_torch.cli.pc_error --fileA a.ply \
        --fileB b.ply --resolution 1023 [--inputNorm a_n.ply]

Port of ``pcc_geo_cnn_v2_tpu/cli/pc_error.py``: prints symmetric D1 (and,
with ``--inputNorm``, D2) in the log format that
``utils/mpeg_parsing.parse_pcerror`` reads, so pipelines written against
the external binary run where it is not installed. The metrics are the
host KD-tree ones of ``utils/metrics.compute_metrics`` (mpeg-pcc-dmetric's
symmetric max / min convention); the other switches of the binary are
accepted and ignored, as in the JAX package.
"""

from __future__ import annotations

import argparse

from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.metrics import compute_metrics


def main(argv=None):
    parser = argparse.ArgumentParser(prog="pc_error", add_help=True)
    parser.add_argument("--fileA", required=True)
    parser.add_argument("--fileB", required=True)
    parser.add_argument("--inputNorm", default=None)
    parser.add_argument("--resolution", type=float, required=True)
    parser.add_argument("--color", default="0")
    parser.add_argument("--dropdups", default="0")
    parser.add_argument("--neighborsProc", default="1")
    parser.add_argument("--singlePass", default=None)
    args = parser.parse_args(argv)

    p1, _ = pc_io.read_ply(args.fileA, columns=["x", "y", "z"])
    p2, _ = pc_io.read_ply(args.fileB, columns=["x", "y", "z"])
    p1_n = None
    if args.inputNorm:
        p1_n, _ = pc_io.read_ply(args.inputNorm, columns=["nx", "ny", "nz"])
    m = compute_metrics(p1, p2, args.resolution, p1_n=p1_n)
    print(f"infile1: {args.fileA}")
    print(f"infile2: {args.fileB}")
    print("3. Final (symmetric).")
    print(f"   mseF      (p2point): {m['d1_mse']}")
    print(f"   mseF,PSNR (p2point): {m['d1_psnr']}")
    if p1_n is not None:
        print(f"   mseF      (p2plane): {m['d2_mse']}")
        print(f"   mseF,PSNR (p2plane): {m['d2_psnr']}")
    else:  # keep the parser's D2 keys: a geometry-only run
        print("   mseF      (p2plane): 0.0")
        print("   mseF,PSNR (p2plane): 0.0")


if __name__ == "__main__":
    main()

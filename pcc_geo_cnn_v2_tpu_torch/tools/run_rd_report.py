"""The RD pipeline on one held-out figure cloud (port of the JAX
package's ``tools/run_rd_report.py``, its argv plus ``--device``).

Drives the CLI pipeline the reference ships: for each trained λ of
``model_root`` (the port's training directories), ``cli/ev_experiment``
(compress → merged decode → metrics → ``report_d1.json``), then the
built-in octree anchor through ``cli/mp_run``, then ``cli/ev_compare``'s
RD curves and BD matrices. Output tree::

    results_torch/rd_pipeline/
      pcs/figure_200.ply
      experiments/figure_200/c3p-a0.75/<λ>/report_d1.json
      experiments/figure_200/octree-anchor/r<scale>/report_d1.json
      compare/figure_200_d1_psnr_{rd.png,data.csv,bdrate.csv,bdsnr.csv}

    python -m pcc_geo_cnn_v2_tpu_torch.tools.run_rd_report \\
        [models/rd/c3p-a0.75] [--seed 200]
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.tools.paths import RESULTS_ROOT, writable

__all__ = ["main"]

RESOLUTION = 1024
LEVEL = 4


def main(argv=None):
    ap = argparse.ArgumentParser(prog="run_rd_report")
    ap.add_argument("model_root", nargs="?", default="models/rd/c3p-a0.75")
    ap.add_argument("--seed", type=int, default=200)
    ap.add_argument("--out", default=str(RESULTS_ROOT / "rd_pipeline"))
    ap.add_argument("--resolution", type=int, default=RESOLUTION)
    ap.add_argument("--octree_level", type=int, default=LEVEL)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Run the experiments on the GPU (default) or, "
                         "explicitly, on the CPU.")
    args = ap.parse_args(argv)

    from pcc_geo_cnn_v2_tpu_torch.cli.ev_compare import main as ev_compare
    from pcc_geo_cnn_v2_tpu_torch.cli.ev_experiment import (
        main as ev_experiment,
    )
    from pcc_geo_cnn_v2_tpu_torch.cli.mp_run import main as mp_run
    from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud

    out = writable(args.out)
    pc_name = f"figure_{args.seed}"
    pc_path = out / "pcs" / f"{pc_name}.ply"
    norm_path = out / "pcs" / f"{pc_name}_n.ply"
    pc_path.parent.mkdir(parents=True, exist_ok=True)
    if not pc_path.exists():
        pts, nrm = figure_cloud(args.seed, args.resolution,
                                with_normals=True)
        pc_io.write_ply(pc_path, pts)
        pc_io.write_ply(norm_path, np.hstack([pts, nrm]),
                        names=("x", "y", "z", "nx", "ny", "nz"))
    print(f"{pc_name}: "
          f"{len(pc_io.read_ply(pc_path, columns=['x','y','z'])[0])} pts",
          flush=True)

    run_dirs = sorted(Path(args.model_root).glob("*e-*"),
                      key=lambda p: float(p.name))
    if not run_dirs:
        ap.error(f"no checkpoints under {args.model_root}")
    exp_root = out / "experiments" / pc_name
    for run_dir in run_dirs:
        exp_dir = exp_root / "c3p-a0.75" / run_dir.name
        ev_experiment([
            "--output_dir", str(exp_dir),
            "--model_dir", str(run_dir),
            "--model_config", "c3p",
            "--input_pc", str(pc_path),
            "--input_norm", str(norm_path),
            "--opt_metrics", "d1_mse", "d2_mse",
            "--resolution", str(args.resolution),
            "--octree_level", str(args.octree_level),
            "--device", args.device,
        ])
        print(f"λ={run_dir.name}: report "
              f"{(exp_dir / 'report_d1.json').exists()}", flush=True)

    # the built-in octree anchor at the CTC scales, rehomed into the
    # ev_compare layout (report.json → report_d1.json)
    anchors_tmp = out / "anchors" / pc_name
    mp_run([str(pc_path), str(anchors_tmp), "--tmc3", "builtin",
            "--input_norm", str(norm_path),
            "--resolution", str(args.resolution)])
    for rdir in sorted((anchors_tmp / "octree").glob("r*")):
        rep = rdir / "report.json"
        if rep.exists():
            for group in ("d1", "d2"):
                dst = (exp_root / "octree-anchor" / rdir.name
                       / f"report_{group}.json")
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy(rep, dst)

    for metric in ("d1_psnr", "d2_psnr"):
        ev_compare([str(out / "experiments"), pc_name,
                    str(out / "compare"), "--metric", metric])
        path = out / "compare" / f"{pc_name}_{metric}_bdsnr.csv"
        if path.exists():
            print(f"BD-PSNR matrix ({metric}):\n" + path.read_text(),
                  flush=True)


if __name__ == "__main__":
    main()

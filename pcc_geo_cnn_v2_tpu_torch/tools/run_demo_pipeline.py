"""The whole experiment stack on synthetic data (port of the JAX package's
``tools/run_demo_pipeline.py``, its argv plus ``--device``).

The reference's README workflow (dataset → tr_train_all →
ev_run_experiment → ev_run_compare → ut_build_paper / ut_train_plots) on
self-generated surface clouds, so that the pipeline and its artifacts (RD
CSVs, BD matrices, plots, LaTeX tables) can be run without the ModelNet /
MPEG datasets. Everything lands in ``demo_out/``.

    python -m pcc_geo_cnn_v2_tpu_torch.tools.run_demo_pipeline [steps]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.data import (
    _surface_patch,
    synthetic_blocks,
)

__all__ = ["make_cloud", "main"]

ROOT = Path("demo_out")


def make_cloud(seed, res=512, n=350_000):
    rng = np.random.default_rng(seed)
    kinds = ["shell", "plane", "cylinder", "shell"]
    parts = [_surface_patch(rng, res, k, n=n // len(kinds)) for k in kinds]
    pts = np.round(np.vstack(parts))
    pts = pts[np.all((pts >= 0) & (pts < res), axis=1)]
    return np.unique(pts, axis=0)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="run_demo_pipeline")
    ap.add_argument("steps", nargs="?", type=int, default=6000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Train and encode on the GPU (default) or, "
                         "explicitly, on the CPU.")
    args = ap.parse_args(argv)
    import yaml

    t_start = time.time()
    blocks_dir = ROOT / "data/blocks"
    clouds_dir = ROOT / "data/clouds"
    blocks_dir.mkdir(parents=True, exist_ok=True)
    clouds_dir.mkdir(parents=True, exist_ok=True)

    for i, b in enumerate(synthetic_blocks(256, block_size=64, seed=3,
                                           kind="mix")):
        pc_io.write_ply(blocks_dir / f"block{i:03d}.ply", b)
    data = []
    for name, seed in [("synth_a", 11), ("synth_b", 23)]:
        path = clouds_dir / f"{name}.ply"
        pc_io.write_ply(path, make_cloud(seed))
        data.append({"pc_name": name, "input_pc": str(path)})
    print(f"dataset ready ({time.time()-t_start:.0f}s)", flush=True)

    spec = {
        "train_glob": str(blocks_dir / "*.ply"),
        "model_dir": str(ROOT / "models"),
        "experiment_dir": str(ROOT / "experiments"),
        "resolution": 512,
        "octree_level": 3,
        "opt_metrics": ["d1_mse"],
        "max_deltas": ["inf"],
        "bd_ignore": [],
        "batch_size": 8,
        "max_steps": args.steps,
        "model_configs": [
            {"id": "c1", "config": "c1", "lambdas": [3e-4]},
            {"id": "c3p", "config": "c3p", "train_mode": "warm_seq",
             "lambdas": [3e-4, 3e-5, 3e-3]},
        ],
        "data": data,
    }
    yml = ROOT / "experiment.yml"
    yml.write_text(yaml.safe_dump(spec))

    from pcc_geo_cnn_v2_tpu_torch.cli import (
        ev_run_compare,
        ev_run_experiment,
        tr_train_all,
        ut_build_paper,
        ut_train_plots,
    )

    t0 = time.time()
    tr_train_all.main([str(yml), spec["model_dir"], "--device", args.device])
    print(f"training sweep done ({time.time()-t0:.0f}s)", flush=True)
    t0 = time.time()
    ev_run_experiment.main([str(yml), "--num_parallel", "1", "--device",
                            args.device])
    print(f"experiments done ({time.time()-t0:.0f}s)", flush=True)
    t0 = time.time()
    ev_run_compare.main([str(yml), "--metrics", "d1_psnr"])
    results = ROOT / "experiments/results"
    ut_train_plots.main([spec["model_dir"], str(results / "plots")])
    bdsnr = results / "bdsnr.csv"
    if bdsnr.exists():
        try:
            ut_build_paper.main([str(bdsnr), str(results / "bdsnr_table.tex"),
                                 "--anchor", "c1"])
        except Exception as exc:  # table building is cosmetic
            print("ut_build_paper skipped:", exc, flush=True)
    print(f"analysis done ({time.time()-t0:.0f}s)", flush=True)
    print("artifacts:", sorted(p.name for p in results.rglob("*") if
                               p.is_file()), flush=True)
    print(f"TOTAL {time.time()-t_start:.0f}s", flush=True)


if __name__ == "__main__":
    main()

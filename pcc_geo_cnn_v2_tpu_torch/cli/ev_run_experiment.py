"""Fan ``ev_experiment`` out over point clouds × model configs × λ, with a
subprocess pool (the port's ``pcc_geo_cnn_v2_tpu/cli/ev_run_experiment.py``,
the reference's ``src/ev_run_experiment.py``), plus ``--device``.

    python -m pcc_geo_cnn_v2_tpu_torch.cli.ev_run_experiment experiment.yml \\
        [--num_parallel 2] [--device cpu]

Weights are read at ``model_dir/<id>/<lmbda_tag>``: a training directory
(``tr_train_all``'s layout) or a ``.msgpack.gz`` asset, so a symlink to a
committed asset evaluates it. YAML schema (a subset of the reference's
ev_experiment.yml):

  experiment_dir: out/experiments
  model_dir: out/models
  resolution: 1024
  octree_level: 4
  opt_metrics: [d1_mse]            # d2_* need input_norm files
  max_deltas: [inf]
  data:
    - pc_name: loot_vox10_1200
      input_pc: /data/loot.ply
      input_norm: /data/loot_n.ply   # optional
  model_configs:
    - id: c3p-sweep
      config: c3p
      lambdas: [1e-4]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from pcc_geo_cnn_v2_tpu_torch.cli.ev_experiment import run_experiment
from pcc_geo_cnn_v2_tpu_torch.cli.tr_train_all import lmbda_tag
from pcc_geo_cnn_v2_tpu_torch.utils.parallel_process import parallel_process

logger = logging.getLogger(__name__)

__all__ = ["run_experiments", "main"]


def run_experiments(spec, num_parallel=1, device="cuda"):
    """Run the experiments of ``spec`` (the parsed YAML) whose reports are
    missing, ``num_parallel`` children at a time."""
    jobs = []
    groups = sorted({m[:2] for m in spec.get("opt_metrics", ["d1_mse"])})
    for data in spec["data"]:
        for mc in spec["model_configs"]:
            for lmbda in mc["lambdas"]:
                model_dir = (Path(spec["model_dir"]) / mc["id"]
                             / lmbda_tag(lmbda))
                out_dir = (Path(spec["experiment_dir"]) / data["pc_name"]
                           / mc["id"] / lmbda_tag(lmbda))
                if all((out_dir / f"report_{g}.json").exists()
                       for g in groups):
                    logger.info("%s reports exist, skipping", out_dir)
                    continue
                params = {
                    "output_dir": out_dir,
                    "model_dir": model_dir,
                    "model_config": mc["config"],
                    "input_pc": data["input_pc"],
                    "opt_metrics": spec.get("opt_metrics", ["d1_mse"]),
                    "max_deltas": spec.get("max_deltas", ["inf"]),
                    "resolution": spec.get("resolution", 1024),
                    "octree_level": spec.get("octree_level", 4),
                    "device": device,
                }
                if "num_filters" in mc:
                    params["num_filters"] = mc["num_filters"]
                if data.get("input_norm"):
                    params["input_norm"] = data["input_norm"]
                out_dir.mkdir(parents=True, exist_ok=True)
                log_f = open(out_dir / "experiment.log", "w")
                jobs.append((params, log_f))

    logger.info("%d experiments to run", len(jobs))
    parallel_process(
        lambda p, f: run_experiment(p, stdout=f, stderr=f),
        jobs, num_parallel)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="ev_run_experiment")
    parser.add_argument("experiment_yml")
    parser.add_argument("--num_parallel", type=int, default=1)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Run the experiments on the GPU (default) or, "
                             "explicitly, on the CPU.")
    args = parser.parse_args(argv)
    import yaml

    spec = yaml.safe_load(Path(args.experiment_yml).read_text())
    run_experiments(spec, args.num_parallel, args.device)


if __name__ == "__main__":
    main()

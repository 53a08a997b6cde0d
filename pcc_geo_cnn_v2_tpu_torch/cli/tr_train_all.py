"""Train sweep driver: model configs × λ, sequential, with warm_seq
chaining.

The argv of ``pcc_geo_cnn_v2_tpu.cli.tr_train_all`` plus ``--device``
(passed to every run). Per-config ``lambdas`` and ``train_mode``
(``independent``, or ``warm_seq``: each λ warm-starts from the previous
λ's directory); a run whose ``done`` marker exists is skipped; the runs
are ``python -m pcc_geo_cnn_v2_tpu_torch.cli.train`` children, one after
the other (one device).

    python -m pcc_geo_cnn_v2_tpu_torch.cli.tr_train_all experiment.yml \\
        models/ [--extra_args "--val_every 500"] [--device cpu]

YAML schema (a subset of the reference's ev_experiment.yml):

  mpeg_dataset_path / train_glob: glob of training block PLYs
  model_configs:
    - id: c3p-sweep          # checkpoint subdirectory
      config: c3p            # MODEL_CONFIGS name
      lambdas: [1e-4, 5e-5]
      train_mode: warm_seq   # optional
      alpha: 0.9             # optional per-config overrides
      ...
"""

from __future__ import annotations

import argparse
import logging
import shlex
import subprocess
import sys
from pathlib import Path

logger = logging.getLogger(__name__)

__all__ = ["lmbda_tag", "train_all", "main"]

TRAIN_KEYS = ("alpha", "gamma", "batch_size", "max_steps", "resolution",
              "num_filters")


def lmbda_tag(lmbda):
    """The run directory's name: ``1.00e-04`` (the committed assets' names
    too)."""
    return f"{float(lmbda):.2e}"


def train_all(spec, model_dir, extra_args=(), device="cuda"):
    """Train every (model config, λ) of ``spec`` (the parsed YAML) whose
    ``done`` marker is missing, under ``model_dir/<id>/<lmbda_tag>``."""
    train_glob = spec.get("train_glob") or spec["mpeg_dataset_path"]
    for mc in spec["model_configs"]:
        mode = mc.get("train_mode", "independent")
        prev_dir = None
        for lmbda in mc["lambdas"]:
            run_dir = Path(model_dir) / mc["id"] / lmbda_tag(lmbda)
            if (run_dir / "done").exists():
                logger.info("%s done, skipping", run_dir)
                prev_dir = run_dir
                continue
            cmd = [
                sys.executable, "-m", "pcc_geo_cnn_v2_tpu_torch.cli.train",
                train_glob, str(run_dir),
                "--model_config", mc["config"],
                "--lmbda", str(lmbda),
            ]
            for key in TRAIN_KEYS:
                # the per-config value, else the spec-level one, but for
                # resolution: per config it is the training block size,
                # at the spec level the evaluation clouds' resolution,
                # which is never passed on
                val = mc.get(key) if key == "resolution" else (
                    mc.get(key, spec.get(key)))
                if val is not None:
                    cmd += [f"--{key}", str(val)]
            if mode == "warm_seq" and prev_dir is not None:
                cmd += ["--warm_start", str(prev_dir)]
            cmd += ["--device", device, *extra_args]
            logger.info("run: %s", " ".join(cmd))
            subprocess.run(cmd, check=True)
            prev_dir = run_dir


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="tr_train_all")
    parser.add_argument("experiment_yml")
    parser.add_argument("model_dir", help="Root dir for all checkpoints.")
    parser.add_argument("--extra_args", default="",
                        help="Extra flags passed to every train run, "
                             "as one shell-quoted string.")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Train on the GPU (default) or, explicitly, "
                             "on the CPU.")
    args = parser.parse_args(argv)
    import yaml

    spec = yaml.safe_load(Path(args.experiment_yml).read_text())
    train_all(spec, args.model_dir, shlex.split(args.extra_args),
              args.device)


if __name__ == "__main__":
    main()

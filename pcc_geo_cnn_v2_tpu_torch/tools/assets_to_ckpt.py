"""Training checkpoints from RD assets (port of the JAX package's
``tools/assets_to_ckpt.py``).

Inverts ``tools/export_rd_assets.py``: for every λ asset of a run
(``<asset_root>/<run_id>/<λ>.msgpack.gz``, by default the committed
``pcc_geo_cnn_v2_tpu/assets/rd``, read only) writes the port's checkpoint
``<model_root>/<run_id>/<λ>/ckpt_<step>/state.pt`` with the asset's params,
a fresh Adam state (moments are not exported) and the manifest's
``ckpt_step``, a ``done`` marker and a ``rehydrated_from_assets`` record in
``train_log.jsonl``. ``tools/rd_train_all.py --extend`` and warm-seq
chaining then run on top. A λ whose ``done`` marker exists is skipped.

    python -m pcc_geo_cnn_v2_tpu_torch.tools.assets_to_ckpt models/rd \\
        --runs c3p-a0.75
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

from pcc_geo_cnn_v2_tpu_torch.tools.paths import ASSET_ROOT

__all__ = ["rehydrate", "main"]


def run_config(run_id: str) -> str:
    """Run directory name → model config name (c3p-a0.75 → c3p)."""
    return run_id.split("-a")[0]


def run_alpha(run_id: str) -> float:
    """Run directory name → focal-loss α (c3p-a0.75-10k → 0.75; 0.75 for
    a c3p run without one, else 0.9)."""
    if "-a" in run_id:
        return float(run_id.split("-a")[1].split("-")[0])
    return 0.75 if run_id.startswith("c3p") else 0.9


def rehydrate(model_root, runs=None, asset_root=ASSET_ROOT):
    """Write the checkpoints; returns the run directories written."""
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.training import TrainConfig, Trainer

    asset_dirs = sorted(p for p in Path(asset_root).iterdir() if p.is_dir())
    if runs:
        asset_dirs = [p for p in asset_dirs if p.name in runs]
    if not asset_dirs:
        raise FileNotFoundError(f"no matching assets under {asset_root}")

    written = []
    for adir in asset_dirs:
        run_id = adir.name
        manifest = json.loads((adir / "manifest.json").read_text())
        for asset in sorted(adir.glob("*e-*.msgpack.gz"),
                            key=lambda p: -float(p.name[:-11])):
            tag = asset.name[: -len(".msgpack.gz")]
            run_dir = Path(model_root) / run_id / tag
            if (run_dir / "done").exists():
                print(f"skip {run_dir} (done exists)")
                continue
            step = int(manifest.get(tag, {}).get("ckpt_step", 0))
            for stale in run_dir.glob("ckpt_*"):  # an unfinished run's
                shutil.rmtree(stale)
            cfg = TrainConfig(block_size=64, lmbda=float(tag),
                              alpha=run_alpha(run_id))
            # params from the asset, a fresh Adam state; the checkpoint is
            # host data, so the CPU
            trainer = Trainer(build_model(run_config(run_id)), cfg, run_dir,
                              warm_start=asset, device="cpu")
            trainer.save(step)
            (run_dir / "done").touch()
            with open(run_dir / "train_log.jsonl", "a") as f:
                f.write(json.dumps({"step": step,
                                    "split": "rehydrated_from_assets"})
                        + "\n")
            print(f"rehydrated {run_dir} at step {step}")
            written.append(run_dir)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(prog="assets_to_ckpt")
    ap.add_argument("model_root", nargs="?", default="models/rd")
    ap.add_argument("--runs", nargs="*", default=None)
    args = ap.parse_args(argv)
    return rehydrate(args.model_root, args.runs)


if __name__ == "__main__":
    main()

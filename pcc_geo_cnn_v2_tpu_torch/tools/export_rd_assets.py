"""Export a λ sweep's checkpoints as flax ``.msgpack.gz`` assets (port of
the JAX package's ``tools/export_rd_assets.py``).

Walks ``<model_root>/<run_id>/<λ>/`` (the layout ``tools/rd_train_all.py``
writes: the port's ``ckpt_<step>`` directories) and writes each λ's latest
params as ``<out_root>/<run_id>/<λ>.msgpack.gz`` (``weights.save_asset``:
the bytes the JAX exporter writes for the same params, with a gzip time of
0) plus a ``manifest.json`` recording the checkpoint step, the export time,
the size and, from ``train_log.jsonl``, the validation-loss series and its
best point: the JAX manifest's records. ``tools/rd_eval.py --from-assets``
reads the result when pointed at ``out_root``.

    python -m pcc_geo_cnn_v2_tpu_torch.tools.export_rd_assets [models/rd] \\
        [--runs c3p-a0.75] [--out_root models/rd_assets]

The default ``out_root`` is ``models/rd_assets`` (gitignored); the
committed ``pcc_geo_cnn_v2_tpu/assets/rd`` is refused
(``paths.writable``).
"""

from __future__ import annotations

import argparse
import datetime
import json
from pathlib import Path

from pcc_geo_cnn_v2_tpu_torch.tools.paths import EXPORT_ROOT, writable

__all__ = ["export", "main"]


def _val_series(log):
    """[[step, val loss]] of a ``train_log.jsonl``: the sweep's
    ``val_loss`` records and the trainer's ``split: val`` ones."""
    vals = []
    for line in log.read_text().splitlines():
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        v = d.get("val_loss",
                  d.get("loss") if d.get("split") == "val" else None)
        if v is not None:
            vals.append([int(d["step"]), round(float(v), 4)])
    return vals


def export(model_root, runs=None, out_root=EXPORT_ROOT):
    """Export every λ of every run under ``model_root`` (or of ``runs``);
    returns the manifest paths written."""
    from pcc_geo_cnn_v2_tpu_torch.training import Trainer, load_params
    from pcc_geo_cnn_v2_tpu_torch.weights import save_asset

    out_root = writable(out_root)
    root = Path(model_root)
    run_dirs = sorted(p for p in root.iterdir() if p.is_dir())
    if runs:
        run_dirs = [p for p in run_dirs if p.name in runs]
    if not run_dirs:
        raise FileNotFoundError(f"nothing to export under {root}")

    written = []
    for run_dir in run_dirs:
        out_dir = writable(out_root / run_dir.name)
        out_dir.mkdir(parents=True, exist_ok=True)
        manifest_path = out_dir / "manifest.json"
        manifest = (json.loads(manifest_path.read_text())
                    if manifest_path.exists() else {})
        for lam_dir in sorted(run_dir.glob("*e-*"),
                              key=lambda p: float(p.name)):
            latest = Trainer.latest_checkpoint(lam_dir)
            if latest is None:
                print(f"skip {lam_dir} (no checkpoint)")
                continue
            step = int(latest.name.split("_")[1])
            out = out_dir / f"{lam_dir.name}.msgpack.gz"
            save_asset(load_params(lam_dir), out)
            manifest[lam_dir.name] = {
                "ckpt_step": step,
                "exported_utc":
                    datetime.datetime.now(datetime.timezone.utc)
                    .isoformat(timespec="seconds"),
                "bytes": out.stat().st_size,
            }
            # the convergence record beside the weights: the val-loss
            # series and its best point
            log = lam_dir / "train_log.jsonl"
            if log.exists():
                vals = _val_series(log)
                if vals:
                    best = min(vals, key=lambda t: t[1])
                    manifest[lam_dir.name]["val_series"] = vals
                    manifest[lam_dir.name]["best_val"] = {
                        "step": best[0], "loss": best[1],
                        "last_logged_step": vals[-1][0],
                    }
            print(f"{lam_dir} (step {step}) -> {out} "
                  f"({out.stat().st_size / 1e6:.1f} MB)")
        manifest_path.write_text(json.dumps(manifest, indent=2))
        print(f"wrote {manifest_path}")
        written.append(manifest_path)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(prog="export_rd_assets")
    ap.add_argument("model_root", nargs="?", default="models/rd")
    ap.add_argument("--runs", nargs="*", default=None,
                    help="run dirs to export (default: all)")
    ap.add_argument("--out_root", default=str(EXPORT_ROOT),
                    help="where <run_id>/<λ>.msgpack.gz are written")
    args = ap.parse_args(argv)
    return export(args.model_root, args.runs, Path(args.out_root))


if __name__ == "__main__":
    main()

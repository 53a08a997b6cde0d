"""RD evaluation of a λ ladder on held-out figure clouds (port of the JAX
package's ``tools/rd_eval.py``, the JAX argv plus ``--device``).

For each λ of a run (the port's training directories under
``models/rd/<run_id>/``, or with ``--from-assets`` the committed
``pcc_geo_cnn_v2_tpu/assets/rd/<run_id>/*.msgpack.gz``), compresses four
held-out 10-bit scan-like clouds (``utils/scansim.py``), records bpp and
full-cloud D1 PSNR (the encoder's device metric) and the host KD-tree D1 /
D2 PSNR of the decoded cloud. Modes:

- default: the adaptive d1 group (``compress_blocks_device_opt``; the
  bucket sweep K1 and the D1 sums K2 on a card);
- ``--d2_group``: a second, d2-optimised stream per cloud
  (``opt_metrics=("d1_mse", "d2_mse")`` with normals: K3 and K2), decoded
  and scored on the host; its decode must equal the encoder's
  reconstruction;
- ``--fixed_threshold``: the host path with the middle threshold
  (``compress_blocks(fixed_threshold=True)``), metrics from the host;
- ``--anchor_only``: only the anchor and BD sections, reusing the points
  already in ``--out``.

Then the built-in octree anchor at eight scales on the same clouds and
BD-rate / BD-PSNR of the average curves against it (d1, and d2). Writes
``results_torch/rd_<run_id>[_fixedthr].json`` (the JAX tool's names under
the port's results root; the committed ``results/`` is never written).

    python -m pcc_geo_cnn_v2_tpu_torch.tools.rd_eval --from-assets \\
        --d2_group                       # results_torch/rd_c3p_a075.json

The JAX tool also takes BD figures against the reference's published
curves from the reference's ``data.csv``; :func:`main` does so when its
``reference_csv`` argument names that file, and otherwise logs one line
and leaves ``bd_vs_reference`` empty.
"""

from __future__ import annotations

import argparse
import gzip
import json
import logging
import time
from pathlib import Path

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.tools.paths import (
    ASSET_ROOT,
    RESULTS_ROOT,
    writable,
)

logger = logging.getLogger(__name__)

__all__ = ["EVAL_SEEDS", "ANCHOR_SCALES", "reference_curves", "avg_curve",
           "summarize", "main"]

EVAL_SEEDS = [200, 201, 202, 203]
RESOLUTION = 1024
LEVEL = 4
# near-1 scales extend the anchor curve into the learned curve's PSNR range
# (67-72 dB) so that BD-rate, not only BD-PSNR, is defined
ANCHOR_SCALES = (0.96875, 0.9375, 0.875, 0.75, 0.5, 0.25, 0.125, 0.0625)


def reference_curves(path, metric="d1_psnr", labels=("c3", "c4"),
                     opt_group="d1"):
    """Per-label average RD curve over the 4 MPEG PCs of the reference's
    published ``data.csv`` at ``path``.

    Labels per ``ev_experiment.yml``: c3=c3p, c4=c3p-a0.75, c6=c4-ws.
    data.csv carries d2_psnr rows under opt_group d2 (d2-optimized
    encodes); pass metric="d2_psnr", opt_group="d2" for those.
    """
    import csv

    with open(path) as f:
        rows = [r for r in csv.DictReader(f)
                if r["eval_id"] == "main" and r["metric"] == metric
                and r["opt_group"] == opt_group]
    out = {}
    for label in labels:
        per_pc = {}
        for r in rows:
            if r["label"] != label:
                continue
            per_pc.setdefault(r["pc_name"], []).append(
                (float(r["x"]), float(r["y"])))
        if not per_pc:
            continue
        # average curves pointwise by rate rank (all PCs share the λ grid)
        n = min(len(v) for v in per_pc.values())
        pts = np.mean(
            [sorted(v)[:n] for v in per_pc.values()], axis=0)
        out[label] = pts  # [(bpp, psnr)...]
    return out


def _bd_safe(fn, ref, ours):
    try:
        return fn([tuple(p) for p in ref], [tuple(p) for p in ours])
    except Exception as e:  # disjoint rate ranges etc.
        return f"n/a ({e})"


def avg_curve(rows, key, keyvals, metric):
    """Per-key (λ or scale) mean (bpp, metric) over the clouds with a
    finite metric; rows without the metric (older artifacts) are
    skipped."""
    return [
        (float(np.mean([r["bpp"] for r in pts])),
         float(np.mean([r[metric] for r in pts])))
        for k in keyvals
        if (pts := [r for r in rows
                    if r[key] == k
                    and np.isfinite(r.get(metric, np.nan))])
    ]


def summarize(results, anchor_results, train_steps, reference_csv=None):
    """The report of :func:`main` from its rows: the average curves of
    the d1 group (and of the d2 group when encoded), the anchor's, BD
    against the anchor and, when ``reference_csv`` exists, against the
    reference's published curves."""
    from pcc_geo_cnn_v2_tpu_torch.utils.bd import bdrate, bdsnr

    def bdsnr_safe(ref, ours):
        return _bd_safe(bdsnr, ref, ours)

    def bdrate_safe(ref, ours):
        return _bd_safe(bdrate, ref, ours)

    lambdas = sorted({r["lmbda"] for r in results})
    # opt_group='d2' rows are the d2-optimized streams: their curve does
    # not mix with the d1 group's
    rows_d1 = [r for r in results if r.get("opt_group", "d1") == "d1"]
    rows_d2g = [r for r in results if r.get("opt_group") == "d2"]
    # the reference's bd_ignore mask (ev_experiment.yml:115): a cloud whose
    # D1 PSNR is not finite (an empty reconstruction) leaves the per-λ
    # average, and is recorded; a λ with no finite cloud leaves whole
    ignored = [
        {"lmbda": r["lmbda"], "pc_name": r["pc_name"], "bpp": r["bpp"]}
        for r in rows_d1 if not np.isfinite(r["d1_psnr"])
    ]

    scales = sorted({r["scale"] for r in anchor_results}, reverse=True)
    avg = avg_curve(rows_d1, "lmbda", lambdas, "d1_psnr")
    # the d2 curve of the d2-optimized group when one was encoded, else of
    # the d1-group stream scored with d2
    avg_d2 = avg_curve(rows_d2g or rows_d1, "lmbda", lambdas, "d2_psnr")
    anchor_avg = avg_curve(anchor_results, "scale", scales, "d1_psnr")
    anchor_avg_d2 = avg_curve(anchor_results, "scale", scales, "d2_psnr")
    report = {"points": results, "avg_curve": avg,
              "avg_curve_d2": avg_d2,
              "d2_group_encoded": bool(rows_d2g),
              "train_steps": train_steps,
              "bd_ignore_points": ignored,
              "anchor_points": anchor_results,
              "anchor_avg_curve": anchor_avg,
              "anchor_avg_curve_d2": anchor_avg_d2,
              "bd_vs_builtin_octree_anchor": {
                  "bd_psnr_db": bdsnr_safe(anchor_avg, avg),
                  "bd_rate_pct": bdrate_safe(anchor_avg, avg),
                  "note": "same-content comparison on the 4 held-out "
                          "figure clouds; anchor entropy backend is the "
                          "context-adaptive binary range coder "
                          "(coding/octree_anchor.py)",
              },
              "bd_vs_reference": {}}
    if avg_d2 and anchor_avg_d2:
        report["bd_vs_builtin_octree_anchor_d2"] = {
            "bd_psnr_db": bdsnr_safe(anchor_avg_d2, avg_d2),
            "bd_rate_pct": bdrate_safe(anchor_avg_d2, avg_d2),
            "note": "point-to-plane (d2) variant of the same-content "
                    "comparison; normals are scansim's analytic ones",
        }
    if reference_csv is None or not Path(reference_csv).exists():
        logger.info("the reference's data.csv is not here (%s): "
                    "bd_vs_reference left empty", reference_csv)
    else:
        for label, ref in reference_curves(reference_csv).items():
            report["bd_vs_reference"][label] = {
                "bd_rate_pct": bdrate_safe(ref.tolist(), avg),
                "bd_psnr_db": bdsnr_safe(ref.tolist(), avg),
                "note": "cross-content positioning (synthetic figures vs "
                        "MPEG scans), not a same-content comparison",
            }
        if avg_d2:
            for label, ref in reference_curves(
                    reference_csv, metric="d2_psnr",
                    opt_group="d2").items():
                report["bd_vs_reference"][label + "_d2"] = {
                    "bd_rate_pct": bdrate_safe(ref.tolist(), avg_d2),
                    "bd_psnr_db": bdsnr_safe(ref.tolist(), avg_d2),
                    "note": "cross-content d2 positioning; reference rows "
                            "are d2-optimized encodes (opt_group d2), ours "
                            + ("is the d2-optimized group too" if rows_d2g
                               else "is the d1-group bitstream scored "
                                    "with d2"),
                }
    return report


def _parser():
    ap = argparse.ArgumentParser(prog="rd_eval")
    ap.add_argument("model_root", nargs="?", default=None,
                    help="default: models/rd/<run_id>")
    ap.add_argument("--config", default="c3p",
                    choices=["c1", "c2", "c3", "c3p"])
    ap.add_argument("--run_id", default=None,
                    help="run dir name under models/rd/ (default "
                         "c3p-a0.75 for c3p, else <config>)")
    ap.add_argument("--out", default=None,
                    help="default: results_torch/rd_<run_id>.json")
    ap.add_argument("--fixed_threshold", action="store_true",
                    help="encode with the reference's fixed mid-threshold "
                         "on the host path instead of the adaptive device "
                         "sweep; metrics from the host")
    ap.add_argument("--d2_group", action="store_true",
                    help="additionally encode a d2-optimized bitstream "
                         "group per cloud; adds opt_group='d2' rows. "
                         "Adaptive path only.")
    ap.add_argument("--batch_blocks", type=int, default=64)
    ap.add_argument("--resolution", type=int, default=RESOLUTION)
    ap.add_argument("--level", type=int, default=LEVEL)
    ap.add_argument("--seeds", nargs="*", type=int, default=EVAL_SEEDS)
    ap.add_argument("--anchor_only", action="store_true",
                    help="recompute only the anchor curve + BD sections, "
                    "reusing the learned points already in --out (host "
                    "work, no model)")
    ap.add_argument("--from-assets", action="store_true", dest="from_assets",
                    help="load params from the committed assets "
                         "(pcc_geo_cnn_v2_tpu/assets/rd/<run_id>/) instead "
                         "of the port's training directories under "
                         "models/rd")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Run on the GPU (default) or, explicitly, on the "
                         "CPU with the kernels' plain versions.")
    return ap


def _ladder(args, asset_root):
    """The λ entries of the run: (lmbda, params loader) sorted by λ, and
    the training steps a λ."""
    from pcc_geo_cnn_v2_tpu_torch.training import Trainer, load_params
    from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

    if args.from_assets:
        # assets mirror the models/rd run-dir layout (e.g. the α=0.9 run
        # lives under 'c3p' per the trainer's run-id rule, even though
        # its eval run_id is 'c3p-a0.9')
        root = Path(asset_root) / Path(args.model_root).name
        files = sorted(root.glob("*e-*.msgpack.gz"),
                       key=lambda p: float(p.name[:-len(".msgpack.gz")]))
        if not files:
            raise FileNotFoundError(f"no exported λ assets under {root}")
        manifest = json.loads((root / "manifest.json").read_text())
        steps = {tag: m["ckpt_step"] for tag, m in manifest.items()}
        return [(float(p.name[:-len(".msgpack.gz")]),
                 lambda p=p: load_asset_tree(p)) for p in files], steps
    run_dirs = sorted(Path(args.model_root).glob("*e-*"),
                      key=lambda p: float(p.name))
    if not run_dirs:
        raise FileNotFoundError(
            f"no λ checkpoints under {args.model_root}")
    steps = {}
    for d in run_dirs:
        latest = Trainer.latest_checkpoint(d)
        if latest is not None:
            steps[d.name] = int(latest.name.split("_")[1])
    return [(float(d.name), lambda d=d: load_params(d))
            for d in run_dirs], steps


def main(argv=None, asset_root=ASSET_ROOT, reference_csv=None):
    """Run the evaluation; returns the report written to ``--out``.

    :param asset_root: where ``--from-assets`` finds ``<run_id>/`` (the
        committed assets, read only; an export of
        ``tools/export_rd_assets.py`` for a check).
    :param reference_csv: the reference's published ``data.csv``; when
        None or absent, ``bd_vs_reference`` stays empty.
    """
    logging.basicConfig(level=logging.INFO)
    parser = _parser()
    args = parser.parse_args(argv)
    if args.d2_group and args.fixed_threshold:
        parser.error("--d2_group needs the adaptive sweep path")
    if args.run_id is None:
        args.run_id = "c3p-a0.75" if args.config == "c3p" else args.config
    if args.model_root is None:
        args.model_root = f"models/rd/{args.run_id}"
    if args.out is None:  # the JAX tool's names, under the port's root
        args.out = str(RESULTS_ROOT / (
            "rd_c3p_a075.json" if args.run_id == "c3p-a0.75"
            and not args.fixed_threshold else
            "rd_" + args.run_id.replace("-", "_").replace(".", "")
            + ("_fixedthr" if args.fixed_threshold else "") + ".json"))
    out_path = writable(args.out)
    resolution, level = args.resolution, args.level

    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec, resolve_device
    from pcc_geo_cnn_v2_tpu_torch.coding.octree_anchor import (
        anchor_decode,
        anchor_encode,
    )
    from pcc_geo_cnn_v2_tpu_torch.coding.syntax import save_compressed_file
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.utils.metrics import compute_metrics
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import (
        departition_octree,
        partition_octree,
    )
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud

    device = None
    if not args.anchor_only:
        device = resolve_device(args.device)
        print("device:", device, flush=True)
    # normals give every row a d2_psnr column next to d1_psnr, as the
    # reference data.csv schema (metric d1_psnr/d2_psnr)
    clouds = {}
    for seed in args.seeds:
        pts, nrm = figure_cloud(seed, resolution, with_normals=True)
        # the d2-group sweep reads normals columns on the blocks and the
        # points (columns 3:6)
        part_pts = np.hstack([pts, nrm]) if args.d2_group else pts
        blocks, binstr = partition_octree(
            part_pts, [0, 0, 0], [resolution] * 3, level)
        clouds[f"figure_{seed}"] = (part_pts, nrm, blocks, binstr)
        print(f"figure_{seed}: {len(pts)} pts, {len(blocks)} blocks",
              flush=True)

    def container(binstr, payload):
        return gzip.compress(save_compressed_file(
            binstr, payload, resolution, level), mtime=0)

    if args.anchor_only:
        prev = json.loads(out_path.read_text())
        results = prev["points"]
        train_steps = prev.get("train_steps", {})
        ladder = []
    else:
        ladder, train_steps = _ladder(args, asset_root)
        model = build_model(args.config)
        results = []
    codec = None
    for lmbda, load in ladder:
        params = load()
        if codec is None:
            codec = BlockCodec(model, params,
                               block_size=resolution // 2 ** level,
                               batch_blocks=args.batch_blocks, device=device,
                               sweep_backend="auto")
        else:
            codec.set_params(params)
        for name, (pts, nrm, blocks, binstr) in clouds.items():
            t0 = time.time()
            if args.fixed_threshold:
                data_list, _ = codec.compress_blocks(
                    blocks, binstr, pts, resolution, level,
                    fixed_threshold=True)
            elif args.d2_group:
                data_list, meta = codec.compress_blocks_device_opt(
                    blocks, binstr, pts, resolution, level,
                    opt_metrics=("d1_mse", "d2_mse"), with_normals=True)
            else:
                data_list, meta = codec.compress_blocks_device_opt(
                    blocks, binstr, pts, resolution, level)
            # one decode of the d1 group scored on the host with normals
            # gives both metric columns; with the adaptive sweep the
            # encoder's D1 is the row's, the host's is kept beside it
            dec_blocks = codec.decompress_blocks(data_list[0])
            dec = np.vstack(departition_octree(
                dec_blocks, binstr, [0, 0, 0], [resolution] * 3, level))
            m = compute_metrics(pts[:, :3], dec, resolution - 1, p1_n=nrm)
            row = {"lmbda": lmbda, "pc_name": name,
                   "d2_psnr": m["d2_psnr"]}
            if args.fixed_threshold:
                row["d1_psnr"] = m["d1_psnr"]
            else:
                row["d1_psnr"] = meta[0]["metrics"]["d1_psnr"]
                row["d1_psnr_host"] = m["d1_psnr"]
            row["bpp"] = len(container(binstr, data_list[0])) * 8 / len(pts)
            results.append(row)
            print(f"λ={lmbda:g} {name}: {row['bpp']:.3f} bpp @ "
                  f"{row['d1_psnr']:.2f} dB d1 / {row['d2_psnr']:.2f} dB "
                  f"d2 ({time.time()-t0:.0f}s)", flush=True)
            if args.d2_group:
                # the d2-optimized stream, scored on the host (the
                # published row's D2 is a KD-tree one); the encoder's D2
                # is kept beside it
                t0 = time.time()
                dec2_blocks = codec.decompress_blocks(data_list[1])
                assert all(np.array_equal(d, e) for d, e in zip(
                    dec2_blocks, meta[1]["x_hat_list"])), \
                    "d2-group decode != encoder reconstruction"
                dec2 = np.vstack(departition_octree(
                    dec2_blocks, binstr, [0, 0, 0], [resolution] * 3,
                    level))
                m2 = compute_metrics(pts[:, :3], dec2, resolution - 1,
                                     p1_n=nrm)
                row2 = {"lmbda": lmbda, "pc_name": name,
                        "opt_group": "d2",
                        "bpp": len(container(binstr, data_list[1])) * 8
                        / len(pts),
                        "d2_psnr": m2["d2_psnr"],
                        "d2_psnr_enc": meta[1]["metrics"]["d2_psnr"],
                        "d1_psnr_on_d2_group": m2["d1_psnr"]}
                results.append(row2)
                print(f"λ={lmbda:g} {name} [d2 group]: "
                      f"{row2['bpp']:.3f} bpp @ {row2['d2_psnr']:.2f} dB "
                      f"d2 (host {m2['d2_psnr']:.2f}) "
                      f"({time.time()-t0:.0f}s)", flush=True)

    # the built-in octree anchor on the same clouds (tmc3 stands absent;
    # coding/octree_anchor.py)
    anchor_results = []
    for name, (pts, nrm, _, _) in clouds.items():
        for scale in ANCHOR_SCALES:
            data = anchor_encode(pts, resolution, scale=scale)
            dec, _ = anchor_decode(data)
            m = compute_metrics(pts[:, :3], dec, resolution - 1, p1_n=nrm)
            anchor_results.append({
                "scale": scale, "pc_name": name,
                "bpp": len(data) * 8 / len(pts),
                "d1_psnr": m["d1_psnr"],
                "d2_psnr": m["d2_psnr"],
            })
            print(f"anchor s={scale} {name}: "
                  f"{anchor_results[-1]['bpp']:.3f} bpp @ "
                  f"{m['d1_psnr']:.2f} dB d1 / {m['d2_psnr']:.2f} dB d2",
                  flush=True)

    report = summarize(results, anchor_results, train_steps, reference_csv)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=2))
    print(json.dumps({"avg_curve": report["avg_curve"],
                      "bd_vs_reference": report["bd_vs_reference"]},
                     indent=2), flush=True)
    return report


if __name__ == "__main__":
    main()

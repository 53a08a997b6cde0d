"""Config-ladder report: within-repo BD deltas against the published
ordering (port of the JAX package's ``tools/rd_ladder.py``).

The reference's headline ablation is the BD-PSNR ladder against the G-PCC
trisoup anchor on 4 MPEG clouds: c1 −0.72 → c2 −0.25 → c3 +1.79 → c4
+3.71 → c5 +5.39 dB. Label↔protocol map (``ev_experiment.yml:10-46``):
c1/c2 = configs c1/c2, c3 = config c3p α0.9, c4 = c3p α0.75, all with the
FIXED mid-threshold; c5 = the c4 checkpoints with the ADAPTIVE threshold
sweep. The content-independent check is the config-to-config deltas:
each rung's BD-PSNR against the same built-in octree anchor on the same
held-out synthetic clouds, then successive differences beside the
published ones.

Inputs: ``<results_dir>/rd_<run_id>[_fixedthr].json`` from
``tools/rd_eval.py`` (any subset of :data:`RUNGS`). Outputs:
``<results_dir>/config_ladder.json`` and ``<results_dir>/data.csv`` (the
reference's published-results schema:
``eval_id,label,metric,mode_id,opt_group,pc_name,x,y,ylabel``) and a
printed table; the same bytes as the JAX tool's for the same inputs.

    python -m pcc_geo_cnn_v2_tpu_torch.tools.rd_ladder [--results_dir D]

``--results_dir`` defaults to ``results_torch``; the committed
``results/`` is refused (``paths.writable``).
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.tools.paths import RESULTS_ROOT, writable

__all__ = ["RUNGS", "CSV_LABELS", "YLABEL", "write_data_csv", "ladder",
           "main"]

# (rung, results file, published BD-PSNR d1, published BD-PSNR d2). All
# fixed-thr rungs train at one uniform budget (10k base + 1.5k ft
# warm-seq), so successive deltas compare configs, not budgets. The c5
# analogue (adaptive threshold on the c4 checkpoints) appears on the
# ladder-budget checkpoints (the controlled delta) and as the
# full-protocol flagship artifact (absolute positioning). The d2 column is
# the reference data.csv's BD-PSNR on the 4-PC average curve against
# trisoup, metric d2_psnr / opt_group d2.
RUNGS = [
    ("c1 (fixed thr)", "rd_c1_fixedthr.json", -0.72, -2.39),
    ("c2 (fixed thr)", "rd_c2_fixedthr.json", -0.25, -1.62),
    ("c3p-a0.9 (fixed thr)", "rd_c3p_a09_fixedthr.json", 1.79, 1.19),
    ("c3p-a0.75 (fixed thr)", "rd_c3p_a075_fixedthr.json", 3.71, 3.68),
    # α ablation twins of the c3p-a0.75 rung (reference rows labeled
    # '$\alpha = …$' in data.csv, fixed thr)
    ("c3p-a0.5 (fixed thr)", "rd_c3p_a05_fixedthr.json", 3.70, 6.07),
    ("c3p-a0.25 (fixed thr)", "rd_c3p_a025_fixedthr.json", -0.22, 3.54),
    # paper c5 = independently trained c3p-a0.75 checkpoints + adaptive
    # sweep; paper c6 = the same on warm-seq-trained checkpoints
    ("c3p-a0.75 (adaptive, independent ckpts)",
     "rd_c3p_a075_ind_adaptive.json", 5.39, 6.42),
    ("c3p-a0.75 (adaptive, warm-seq ckpts)",
     "rd_c3p_a075_trim_adaptive.json", 5.50, 6.48),
    ("c3p-a0.75 (adaptive, flagship protocol)",
     "rd_c3p_a075.json", 5.50, 6.48),
]

# rung -> (data.csv label, mode_id), the reference's label map
# (ev_experiment.yml:10-46); the flagship keeps its own label, the α
# ablations the reference's exact label strings
CSV_LABELS = {
    "c1 (fixed thr)": ("c1", "c1"),
    "c2 (fixed thr)": ("c2", "c2"),
    "c3p-a0.9 (fixed thr)": ("c3", "c3p"),
    "c3p-a0.75 (fixed thr)": ("c4", "c3p-a0.75-10k"),
    "c3p-a0.5 (fixed thr)": ("$\\alpha = 0.50$", "c3p-a0.5"),
    "c3p-a0.25 (fixed thr)": ("$\\alpha = 0.25$", "c3p-a0.25"),
    "c3p-a0.75 (adaptive, independent ckpts)":
        ("c5", "c3p-a0.75-ind+adaptive"),
    "c3p-a0.75 (adaptive, warm-seq ckpts)":
        ("c6", "c3p-a0.75-10k+adaptive"),
    "c3p-a0.75 (adaptive, flagship protocol)":
        ("c6-flagship", "c3p-a0.75"),
}

YLABEL = {"d1_psnr": "D1 PSNR (dB)", "d2_psnr": "D2 PSNR (dB)"}

NOTE = (
    "within-repo config ladder on 4 held-out synthetic clouds "
    "vs the builtin CABAC octree anchor; 'published' column = "
    "reference data.csv BD-PSNR vs G-PCC trisoup on 4 MPEG "
    "clouds (BASELINE.md). The parity check is the ORDERING "
    "and the successive deltas, not absolute values "
    "(different content, different anchor). Rungs carry "
    "their per-λ training budget (train_steps_per_lambda); "
    "every fixed-thr rung and the same-ckpts adaptive rung "
    "train at the uniform 10k-base + 1.5k-ft warm-seq "
    "budget, so successive deltas compare configs. The "
    "flagship row alone uses the full protocol (40k base, "
    "8k ft, early-stop patience 4000); its delta is "
    "training-contaminated and reported for context. d2 "
    "columns: rows with d2_curve_is_d2_group=true are from "
    "separately d2-OPTIMIZED bitstreams (rd_eval "
    "--d2_group — the reference's published d2 convention "
    "for its adaptive c5/c6 rows); false means the d1 "
    "bitstream scored with the d2 metric, which is the "
    "correct protocol reading for fixed-thr rungs "
    "(reference c1-c4 + alpha rows emit one bitstream, "
    "fixed mid-threshold).")


def write_data_csv(reports, results_dir=RESULTS_ROOT):
    """``<results_dir>/data.csv`` in the reference's published-results
    schema.

    One row per (rung, metric, cloud, rate point), plus the built-in
    CABAC octree anchor's points (from the artifact with the most eval
    clouds). Points tagged ``opt_group: d2`` (``rd_eval --d2_group``) are
    d2-optimized streams and give a (d2_psnr, opt_group=d2) row; untagged
    points are d1-optimized and their d2_psnr rows keep opt_group=d1.
    """
    rows = []
    anchor_src = max(
        (rep for _, rep in reports if rep.get("anchor_points")),
        key=lambda rep: len({p["pc_name"] for p in rep["anchor_points"]}),
        default=None,
    )
    if anchor_src is not None:
        for p in anchor_src["anchor_points"]:
            for metric in ("d1_psnr", "d2_psnr"):
                if metric not in p:
                    continue
                rows.append(["main", "CABAC octree (builtin)", metric,
                             "octree-cabac", "d1", p["pc_name"],
                             p["bpp"], p[metric], YLABEL[metric]])
    for run_id, rep in reports:
        label, mode_id = CSV_LABELS.get(run_id, (run_id, run_id))
        for p in rep.get("points", []):
            group = p.get("opt_group", "d1")
            metrics = ("d2_psnr",) if group == "d2" else \
                ("d1_psnr", "d2_psnr")
            for metric in metrics:
                if metric not in p or not np.isfinite(p[metric]):
                    continue
                rows.append(["main", label, metric, mode_id, group,
                             p["pc_name"], p["bpp"], p[metric],
                             YLABEL[metric]])
    out = writable(Path(results_dir) / "data.csv")
    with out.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["eval_id", "label", "metric", "mode_id", "opt_group",
                    "pc_name", "x", "y", "ylabel"])
        w.writerows(rows)
    print(f"wrote {out} ({len(rows)} rows)")


def _bd_of(anchor, ours):
    from pcc_geo_cnn_v2_tpu_torch.utils.bd import bdsnr

    if anchor is None:
        return "n/a (no anchor curve)"
    ours = [q for q in ours if np.isfinite(q[0]) and np.isfinite(q[1])]
    try:
        bd = float(bdsnr([tuple(q) for q in anchor], ours))
        return bd if np.isfinite(bd) else f"n/a (bdsnr={bd})"
    except Exception as e:  # noqa: BLE001 - disjoint ranges etc.
        return f"n/a ({e})"


def ladder(results_dir=RESULTS_ROOT):
    """The ladder's rows over the rung files present in ``results_dir``,
    and the (run_id, report) pairs read."""
    results_dir = Path(results_dir)
    # fallback anchor for old artifacts without one (the flagship's)
    fallback_anchor = None
    flagship_path = results_dir / "rd_c3p_a075.json"
    if flagship_path.exists():
        flagship = json.loads(flagship_path.read_text())
        if flagship.get("anchor_avg_curve"):
            fallback_anchor = [tuple(p) for p in flagship["anchor_avg_curve"]]

    rows = []
    reports = []
    for run_id, name, published, published_d2 in RUNGS:
        p = results_dir / name
        if not p.exists():
            rows.append({"run_id": run_id, "status": "missing",
                         "published_bd_psnr_vs_trisoup": published})
            continue
        rep = json.loads(p.read_text())
        reports.append((run_id, rep))
        # each rung against the anchor of its own eval clouds (rd_eval
        # embeds it): a same-content comparison
        anchor = rep.get("anchor_avg_curve", fallback_anchor)
        bd = _bd_of(anchor, [tuple(q) for q in rep["avg_curve"]])
        row = {"run_id": run_id,
               "bd_psnr_vs_builtin_anchor": bd,
               "published_bd_psnr_vs_trisoup": published}
        if rep.get("avg_curve_d2") and rep.get("anchor_avg_curve_d2"):
            row["bd_psnr_d2_vs_builtin_anchor"] = _bd_of(
                rep["anchor_avg_curve_d2"],
                [tuple(q) for q in rep["avg_curve_d2"]])
            row["published_bd_psnr_d2_vs_trisoup"] = published_d2
            # True when the d2 curve is from a d2-OPTIMIZED group
            # (rd_eval --d2_group), not the d1 stream scored with d2
            row["d2_curve_is_d2_group"] = bool(
                rep.get("d2_group_encoded"))
        # encoder-side against host KD-tree d2 over the rung's d2-group
        # points (the published row's value is the host one)
        d2pts = [p for p in rep.get("points", [])
                 if p.get("opt_group") == "d2" and "d2_psnr_enc" in p
                 and np.isfinite(p.get("d2_psnr", np.nan))]
        if d2pts:
            row["d2_enc_vs_host_max_abs_db"] = round(
                max(abs(p["d2_psnr_enc"] - p["d2_psnr"])
                    for p in d2pts), 3)
        if rep.get("train_steps"):
            row["train_steps_per_lambda"] = rep["train_steps"]
        rows.append(row)

    # successive deltas (the content-independent check)
    for i in range(1, len(rows)):
        a, b = rows[i - 1], rows[i]
        if isinstance(a.get("bd_psnr_vs_builtin_anchor"), float) and \
                isinstance(b.get("bd_psnr_vs_builtin_anchor"), float):
            b["delta_db"] = round(b["bd_psnr_vs_builtin_anchor"]
                                  - a["bd_psnr_vs_builtin_anchor"], 3)
        b["published_delta_db"] = round(
            b["published_bd_psnr_vs_trisoup"]
            - a["published_bd_psnr_vs_trisoup"], 3)
        if isinstance(a.get("bd_psnr_d2_vs_builtin_anchor"), float) and \
                isinstance(b.get("bd_psnr_d2_vs_builtin_anchor"), float):
            b["delta_d2_db"] = round(
                b["bd_psnr_d2_vs_builtin_anchor"]
                - a["bd_psnr_d2_vs_builtin_anchor"], 3)
            b["published_delta_d2_db"] = round(
                b["published_bd_psnr_d2_vs_trisoup"]
                - a["published_bd_psnr_d2_vs_trisoup"], 3)
    return rows, reports


def main(argv=None):
    """Write ``config_ladder.json`` and ``data.csv``; returns the rows."""
    ap = argparse.ArgumentParser(prog="rd_ladder")
    ap.add_argument("--results_dir", default=str(RESULTS_ROOT),
                    help="where the rd_*.json are read and the ladder "
                         "written")
    args = ap.parse_args(argv)
    results_dir = Path(args.results_dir)
    out = writable(results_dir / "config_ladder.json")
    rows, reports = ladder(results_dir)
    out.write_text(json.dumps({"note": NOTE, "rows": rows}, indent=2))
    w = max(len(r["run_id"]) for r in rows)
    print(f"{'rung':<{w}}  {'BD vs anchor':>12}  {'Δ':>7}  "
          f"{'published Δ':>11}")
    for r in rows:
        bd = r.get("bd_psnr_vs_builtin_anchor", "missing")
        bd = f"{bd:.2f}" if isinstance(bd, float) else str(bd)[:12]
        d = r.get("delta_db", "")
        pd = r.get("published_delta_db", "")
        print(f"{r['run_id']:<{w}}  {bd:>12}  {str(d):>7}  {str(pd):>11}")
    print(f"wrote {out}")
    write_data_csv(reports, results_dir)
    return rows


if __name__ == "__main__":
    main()

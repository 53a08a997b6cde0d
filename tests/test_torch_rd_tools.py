"""The port's RD tools against the JAX package's, on the CPU.

- ``rd_ladder``: ``config_ladder.json`` and ``data.csv`` byte-equal to the
  JAX tool's (run as a subprocess in a temporary working directory) on
  copies of the committed ``results/rd_*.json``, on all of them and on a
  subset; the committed ``results/`` is refused as an output.
- ``rd_eval.reference_curves`` equal to JAX's on a small synthetic
  ``data.csv`` (the JAX module's ``open`` patched to read it).
- ``export_rd_assets``: the same checkpoint params (an orbax checkpoint
  written by the JAX package's own ``save_ckpt``, a port checkpoint by
  ``assets_to_ckpt``) export to byte-equal assets (the JAX exporter's gzip
  time patched to 0) and manifests equal apart from the export time.
- ``assets_to_ckpt``: the checkpoint holds the asset's params, a fresh
  Adam state, the manifest's step, the ``done`` marker and the
  ``rehydrated_from_assets`` record; a second call skips; an export of it
  gives the committed payload back.
- ``train_sweep`` on a tiny model: the directory layout, steps in
  ``K_INNER``, warm-seq sources (a fresh λ and one reloaded after a
  ``done`` skip), ``--extend`` from a checkpoint, early stop with the
  best-val params checkpointed and the final tail probe.
"""

import functools
import gzip
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu_torch.tools import (
    assets_to_ckpt,
    export_rd_assets,
    rd_eval,
    rd_ladder,
    rd_train_all,
)
from pcc_geo_cnn_v2_tpu_torch.training import (
    Trainer,
    load_params,
    read_checkpoint,
)
from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree, msgpack_serialize

REPO = Path(__file__).resolve().parent.parent
RESULTS = REPO / "results"
ASSETS = REPO / "pcc_geo_cnn_v2_tpu/assets/rd"
TINY = dict(model="v2", num_filters=8, analysis="AnalysisTransformV1",
            synthesis="SynthesisTransformV1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file, as the other port files:
    test files run in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    """A JAX tool script loaded as a module (nothing in it changes)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- rd_ladder ---------------------------------------------------------------


@pytest.mark.parametrize("subset", ["all", "two"])
def test_rd_ladder_bytes_equal_jax(tmp_path, subset):
    files = sorted(RESULTS.glob("rd_*.json"))
    if subset == "two":
        files = [RESULTS / "rd_c1_fixedthr.json",
                 RESULTS / "rd_c3p_a075.json"]
    jax_dir, port_dir = tmp_path / "jax" / "results", tmp_path / "port"
    jax_dir.mkdir(parents=True)
    port_dir.mkdir()
    for f in files:
        shutil.copy(f, jax_dir)
        shutil.copy(f, port_dir)
    proc = subprocess.run([sys.executable, str(REPO / "tools/rd_ladder.py")],
                          cwd=tmp_path / "jax", capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stderr
    rows = rd_ladder.main(["--results_dir", str(port_dir)])
    for name in ("config_ladder.json", "data.csv"):
        assert (port_dir / name).read_bytes() == \
            (jax_dir / name).read_bytes(), name
    present = [r for r in rows if r.get("status") != "missing"]
    assert len(present) == len(files)


def test_rd_ladder_refuses_the_committed_results():
    with pytest.raises(ValueError, match="committed"):
        rd_ladder.main(["--results_dir", str(RESULTS)])


# -- reference_curves ---------------------------------------------------------


def test_reference_curves_equal_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    csv_path = tmp_path / "data.csv"
    lines = ["eval_id,label,metric,mode_id,opt_group,pc_name,x,y,ylabel"]
    for label, n_pts in (("c3", 4), ("c4", 5), ("c6", 3)):
        for pc in ("longdress", "loot", "redandblack", "soldier"):
            # one cloud with an extra point: the curves cut to the shortest
            extra = pc == "loot"
            for i in range(n_pts + extra):
                for metric, group in (("d1_psnr", "d1"), ("d2_psnr", "d2"),
                                      ("d2_psnr", "d1")):
                    x, y = rng.uniform(0.05, 1.5), rng.uniform(60, 76)
                    lines.append(f"main,{label},{metric},m,{group},{pc},"
                                 f"{x!r},{y!r},y")
        lines.append(f"other,{label},d1_psnr,m,d1,loot,0.5,70.0,y")
    csv_path.write_text("\n".join(lines) + "\n")
    jax_eval = _jax_tool("rd_eval")
    monkeypatch.setattr(jax_eval, "open",
                        lambda *a, **k: open(csv_path), raising=False)
    for kw in ({}, {"metric": "d2_psnr", "opt_group": "d2"},
               {"metric": "d2_psnr", "opt_group": "d1",
                "labels": ("c3", "c4", "c6")}):
        got = rd_eval.reference_curves(csv_path, **kw)
        want = jax_eval.reference_curves(**kw)
        assert list(got) == list(want) and got
        for label in want:
            assert np.array_equal(got[label], want[label]), label


@pytest.mark.parametrize("name", ["rd_c1_fixedthr.json", "rd_c3p_a075.json"])
def test_anchor_only_equals_jax(tmp_path, monkeypatch, name):
    """``--anchor_only`` on a copy of a committed report in both packages
    (the anchor on 64³ figure clouds): the same report, the learned rows
    kept, the anchor, the curves and the BD figures recomputed by each
    package's own code (the JAX tool's reference section patched empty;
    the committed files' d2 sections predate its current code)."""
    argv = ["--anchor_only", "--resolution", "64", "--level", "1",
            "--seeds", "200", "203"]
    for side in ("jax", "port"):
        shutil.copy(RESULTS / name, tmp_path / f"{side}.json")
    jax_eval = _jax_tool("rd_eval")
    monkeypatch.setattr(jax_eval, "reference_curves", lambda **k: {})
    monkeypatch.setattr(sys, "argv", ["rd_eval", *argv, "--out",
                                      str(tmp_path / "jax.json")])
    jax_eval.main()
    report = rd_eval.main(argv + ["--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == want
    assert json.loads(json.dumps(report)) == want
    assert want["points"] == json.loads((RESULTS / name).read_text())[
        "points"]
    assert {p["pc_name"] for p in want["anchor_points"]} == {
        "figure_200", "figure_203"}


# -- export_rd_assets and assets_to_ckpt --------------------------------------


def _asset_root(tmp_path, run="c1", tags=("5.00e-05", "2.00e-04")):
    """A copy of committed assets: ``tags`` of ``run`` and its manifest."""
    root = tmp_path / "assets"
    (root / run).mkdir(parents=True)
    for tag in tags:
        shutil.copy(ASSETS / run / f"{tag}.msgpack.gz", root / run)
    shutil.copy(ASSETS / run / "manifest.json", root / run)
    return root


def test_assets_to_ckpt_round_trip(tmp_path):
    root = _asset_root(tmp_path)
    models = tmp_path / "models"
    written = assets_to_ckpt.rehydrate(models, ["c1"], asset_root=root)
    manifest = json.loads((ASSETS / "c1/manifest.json").read_text())
    assert [d.name for d in written] == ["2.00e-04", "5.00e-05"]
    for run_dir in written:
        tag = run_dir.name
        step = manifest[tag]["ckpt_step"]
        latest = Trainer.latest_checkpoint(run_dir)
        assert latest.name == f"ckpt_{step}"
        state = read_checkpoint(latest)
        assert state["step"] == step
        assert all(not s for s in state["opt_state"]["state"].values())
        assert (run_dir / "done").exists()
        assert json.loads((run_dir / "train_log.jsonl").read_text()) == \
            {"step": step, "split": "rehydrated_from_assets"}
        # equal trees serialise to equal bytes
        assert msgpack_serialize(load_params(run_dir)) == msgpack_serialize(
            load_asset_tree(ASSETS / "c1" / f"{tag}.msgpack.gz"))
    assert assets_to_ckpt.rehydrate(models, ["c1"], asset_root=root) == []
    # and exported again: the committed payloads
    out = tmp_path / "export"
    export_rd_assets.export(models, ["c1"], out)
    for run_dir in written:
        name = f"{run_dir.name}.msgpack.gz"
        assert gzip.decompress((out / "c1" / name).read_bytes()) == \
            gzip.decompress((ASSETS / "c1" / name).read_bytes())


def test_export_rd_assets_bytes_equal_jax(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
    from pcc_geo_cnn_v2_tpu.training import TrainConfig, create_train_state
    from tools.rd_train_all import save_ckpt

    root = _asset_root(tmp_path)
    port_models = tmp_path / "port_models"
    assets_to_ckpt.rehydrate(port_models, ["c1"], asset_root=root)
    # the JAX side: orbax checkpoints of the same params at the same steps
    jax_models = tmp_path / "jax_models"
    model = jax_build("c1")
    log = "\n".join(json.dumps(r) for r in (
        {"step": 1000, "split": "train", "loss": 3.0, "val_loss": 2.5},
        {"step": 1500, "split": "val", "loss": 2.25},
        {"step": 1700, "split": "final_probe", "val_loss": 2.3125},
        {"step": 1800, "split": "train", "loss": 2.0})) + "\nnot json\n"
    for run_dir in sorted((port_models / "c1").iterdir()):
        step = int(Trainer.latest_checkpoint(run_dir).name.split("_")[1])
        state = create_train_state(model, jax.random.PRNGKey(0),
                                   TrainConfig(block_size=16))
        params = load_asset_tree(root / "c1" / f"{run_dir.name}.msgpack.gz")
        state = state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                            params))
        jdir = jax_models / "c1" / run_dir.name
        save_ckpt(jdir, state, step)
        for d in (jdir, run_dir):
            (d / "train_log.jsonl").write_text(log)
    jax_export = _jax_tool("export_rd_assets")
    jax_out = tmp_path / "jax_assets"
    monkeypatch.setattr(jax_export, "ASSET_ROOT", jax_out)
    monkeypatch.setattr(sys, "argv", ["export_rd_assets", str(jax_models),
                                      "--runs", "c1"])
    with monkeypatch.context() as m:  # the JAX exporter stamps the time
        m.setattr(jax_export.gzip, "compress",
                  functools.partial(gzip.compress, mtime=0))
        jax_export.main()
    port_out = tmp_path / "port_assets"
    export_rd_assets.main([str(port_models), "--runs", "c1", "--out_root",
                           str(port_out)])
    names = sorted(p.name for p in (jax_out / "c1").iterdir())
    assert names == sorted(p.name for p in (port_out / "c1").iterdir())
    assert names == ["2.00e-04.msgpack.gz", "5.00e-05.msgpack.gz",
                     "manifest.json"]
    for name in names[:2]:
        assert (port_out / "c1" / name).read_bytes() == \
            (jax_out / "c1" / name).read_bytes(), name
    got = json.loads((port_out / "c1/manifest.json").read_text())
    want = json.loads((jax_out / "c1/manifest.json").read_text())
    for m in (got, want):
        for rec in m.values():
            assert rec.pop("exported_utc")
    assert got == want
    assert got["2.00e-04"]["val_series"] == [[1000, 2.5], [1500, 2.25],
                                             [1700, 2.3125]]


def test_export_refuses_the_committed_assets(tmp_path):
    assets_to_ckpt.rehydrate(tmp_path / "m", ["c1"],
                             asset_root=_asset_root(tmp_path))
    with pytest.raises(ValueError, match="committed"):
        export_rd_assets.export(tmp_path / "m", ["c1"], ASSETS.parent)


# -- train_sweep --------------------------------------------------------------


def _blocks(n, seed, size=16, pts=200):
    rng = np.random.default_rng(seed)
    out = np.full((n, pts, 3), -1, np.int8)
    for i in range(n):
        k = int(rng.integers(pts // 2, pts))
        out[i, :k] = rng.integers(0, size, (k, 3))
    return out


def _params(run_dir):
    return read_checkpoint(Trainer.latest_checkpoint(run_dir))["params"]


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


SWEEP = dict(config=TINY, alpha=0.75, run_id="tiny", batch_size=2,
             device="cpu", block_size=16)


@pytest.fixture
def starts(monkeypatch):
    """The model's state at the first step of every λ's run."""
    seen = []
    real = Trainer.step_blocks

    def step_blocks(self, data, step):
        if step == 1:
            seen.append({k: v.clone()
                         for k, v in self.model.state_dict().items()})
        return real(self, data, step)

    monkeypatch.setattr(Trainer, "step_blocks", step_blocks)
    return seen


def test_train_sweep_layout_steps_and_warm_seq(tmp_path, starts):
    train, val = _blocks(6, 0), _blocks(2, 1)
    lams = [3e-4, 1e-4]
    dirs = rd_train_all.train_sweep(tmp_path, lambdas=lams,
                                    train_blocks=train, val_blocks=val,
                                    base_steps=3, ft_steps=3, **SWEEP)
    assert dirs == [tmp_path / "tiny" / rd_train_all.lmbda_tag(x)
                    for x in lams]
    for d in dirs:
        # 3 steps asked, one K_INNER call of 50 taken
        assert [p.name for p in d.glob("ckpt_*")] == [
            f"ckpt_{rd_train_all.K_INNER}"]
        assert (d / "ckpt_50" / "state.pt").exists()
        assert (d / "done").exists()
    assert len(starts) == 2
    # the second λ starts from the first λ's checkpoint
    assert _equal(starts[1], _params(dirs[0]))
    assert not _equal(starts[0], starts[1])

    # again with a third λ: the two done are skipped (untouched), the
    # first reloaded one is the third's warm-start source
    mtimes = [(d / "ckpt_50" / "state.pt").stat().st_mtime_ns for d in dirs]
    dirs3 = rd_train_all.train_sweep(tmp_path, lambdas=lams + [5e-5],
                                     train_blocks=train, val_blocks=val,
                                     base_steps=3, ft_steps=3, **SWEEP)
    assert [(d / "ckpt_50" / "state.pt").stat().st_mtime_ns
            for d in dirs] == mtimes
    assert len(starts) == 3
    assert _equal(starts[2], _params(dirs[1]))
    assert [p.name for p in dirs3[2].glob("ckpt_*")] == ["ckpt_50"]

    # --extend: the done λ trains on from its checkpoint, Adam state too
    before = read_checkpoint(dirs[0] / "ckpt_50")
    rd_train_all.train_sweep(tmp_path, lambdas=lams[:1], train_blocks=train,
                             val_blocks=val, extend=60, **SWEEP)
    assert _equal(starts[3], before["params"])
    latest = Trainer.latest_checkpoint(dirs[0])
    assert latest.name == "ckpt_150"  # 50 + two K_INNER calls
    after = read_checkpoint(latest)
    assert after["step"] == 150
    adam = next(iter(after["opt_state"]["state"].values()))
    assert int(adam["step"]) == 150


def _scripted_probe(losses, kept):
    """A validation probe returning ``losses`` in order and keeping the
    params it saw at each call (1, 2, ...)."""
    losses = iter(losses)

    def probe(trainer, val_data):
        kept[len(kept) + 1] = {k: v.clone() for k, v in
                               trainer.model.state_dict().items()}
        return next(losses)

    return probe


def test_train_sweep_early_stop_keeps_the_best_params(tmp_path, monkeypatch):
    monkeypatch.setattr(rd_train_all, "PROBE_EVERY", 100)
    train, val = _blocks(6, 0), _blocks(2, 1)
    kept = {}
    monkeypatch.setattr(rd_train_all, "_probe", _scripted_probe(
        [5.0, 3.0, 4.0, 6.0, 7.0], kept))
    (run,) = rd_train_all.train_sweep(
        tmp_path / "a", lambdas=[1e-4], train_blocks=train, val_blocks=val,
        base_steps=1000, patience_steps=200, **SWEEP)
    log = [json.loads(x) for x in
           (run / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [100, 200, 300, 400]
    assert log[-1]["early_stop"] == 400 and log[-1]["best_step"] == 200
    assert [p.name for p in run.glob("ckpt_*")] == ["ckpt_200"]
    assert _equal(_params(run), kept[2])  # the best probe's params

    # a budget that ends between probes gets a final one
    kept.clear()
    monkeypatch.setattr(rd_train_all, "_probe", _scripted_probe(
        [5.0, 1.0], kept))
    (run,) = rd_train_all.train_sweep(
        tmp_path / "b", lambdas=[1e-4], train_blocks=train, val_blocks=val,
        base_steps=150, patience_steps=200, **SWEEP)
    log = [json.loads(x) for x in
           (run / "train_log.jsonl").read_text().splitlines()]
    assert [(r["step"], r["split"]) for r in log] == [
        (100, "train"), (150, "final_probe")]
    assert [p.name for p in run.glob("ckpt_*")] == ["ckpt_150"]
    assert _equal(_params(run), kept[2])


# -- the scripts: rd_sweep, run_rd_report, ut_build_paper, run_demo_pipeline --


def test_rd_sweep_reads_no_argv_at_import_and_its_cloud_equals_jax(
        monkeypatch):
    from pcc_geo_cnn_v2_tpu_torch.tools import rd_sweep

    monkeypatch.setattr(sys, "argv", ["rd_sweep"])  # JAX reads it at import
    jax_sweep = _jax_tool("rd_sweep")
    assert np.array_equal(rd_sweep.eval_cloud(), jax_sweep.eval_cloud())
    assert rd_sweep.LAMBDAS == jax_sweep.LAMBDAS
    assert rd_sweep.BENCH_CKPT == jax_sweep.BENCH_CKPT
    assert not hasattr(rd_sweep, "STEPS")


def test_ut_build_paper_equals_jax(tmp_path):
    from pcc_geo_cnn_v2_tpu.cli import ut_build_paper as jax_paper
    from pcc_geo_cnn_v2_tpu_torch.cli import ut_build_paper

    rng = np.random.default_rng(2)
    modes = ["c1", "c3p", "c4", "anchor"]
    lines = ["source,," + ",".join(modes)]
    for pc in ("figure_200", "loot_vox10"):
        for metric in ("d1_psnr_bdsnr", "d2_psnr_bdsnr"):
            for m in modes:
                vals = ",".join(f"{v:.4f}" for v in rng.normal(0, 2, 4))
                lines.append(f"{pc}_{metric},{m},{vals}")
    src = tmp_path / "bdsnr.csv"
    src.write_text("\n".join(lines) + "\n")
    for extra in ([], ["--lower_better"]):
        ut_build_paper.main([str(src), str(tmp_path / "p.tex"),
                             "--anchor", "c1", *extra])
        jax_paper.main([str(src), str(tmp_path / "j.tex"), "--anchor",
                        "c1", *extra])
        got = (tmp_path / "p.tex").read_bytes()
        assert got == (tmp_path / "j.tex").read_bytes()
        assert b"\\textbf" in got and b"\\textit" in got


def _record_cli(monkeypatch, module, calls, name, effect=None):
    """Replace ``module.main`` with a recorder of its argv."""
    def main(argv=None):
        calls.append((name, [str(a) for a in argv]))
        if effect:
            effect(argv)

    monkeypatch.setattr(module, "main", main)


def test_run_rd_report_drives_the_clis_as_jax(tmp_path, monkeypatch):
    """Both scripts on two trained λ directories, the CLIs they call
    recorded: the same argv in the same order (the port's ev_experiment
    with ``--device``), the same anchor reports rehomed, the same cloud
    files."""
    from pcc_geo_cnn_v2_tpu.cli import ev_compare as j_cmp
    from pcc_geo_cnn_v2_tpu.cli import ev_experiment as j_exp
    from pcc_geo_cnn_v2_tpu.cli import mp_run as j_mp
    from pcc_geo_cnn_v2_tpu_torch.cli import ev_compare as t_cmp
    from pcc_geo_cnn_v2_tpu_torch.cli import ev_experiment as t_exp
    from pcc_geo_cnn_v2_tpu_torch.cli import mp_run as t_mp
    from pcc_geo_cnn_v2_tpu_torch.tools import run_rd_report

    models = tmp_path / "models"
    for tag in ("1.00e-05", "3.00e-04"):
        (models / tag).mkdir(parents=True)

    def anchors(argv):  # mp_run writes one report a rate
        for r in ("r0.5", "r0.75"):
            d = Path(argv[1]) / "octree" / r
            d.mkdir(parents=True, exist_ok=True)
            (d / "report.json").write_text(json.dumps({"r": r}))

    calls = {"jax": [], "port": []}
    for side, (exp, mp, cmp) in (("jax", (j_exp, j_mp, j_cmp)),
                                 ("port", (t_exp, t_mp, t_cmp))):
        _record_cli(monkeypatch, exp, calls[side], "ev_experiment")
        _record_cli(monkeypatch, mp, calls[side], "mp_run", anchors)
        _record_cli(monkeypatch, cmp, calls[side], "ev_compare")
    argv = [str(models), "--resolution", "64", "--octree_level", "1"]
    monkeypatch.setattr(sys, "argv", ["run_rd_report", *argv, "--out",
                                      str(tmp_path / "jax")])
    _jax_tool("run_rd_report").main()
    run_rd_report.main(argv + ["--out", str(tmp_path / "port"),
                               "--device", "cpu"])
    assert len(calls["port"]) == len(calls["jax"]) == 5
    for (nj, aj), (np_, ap) in zip(calls["jax"], calls["port"]):
        assert nj == np_
        aj = [a.replace(str(tmp_path / "jax"), "OUT") for a in aj]
        ap = [a.replace(str(tmp_path / "port"), "OUT") for a in ap]
        if nj == "ev_experiment":
            assert ap[-2:] == ["--device", "cpu"]
            ap = ap[:-2]
        assert ap == aj
    files = {side: sorted(str(p.relative_to(tmp_path / side))
                          for p in (tmp_path / side).rglob("*")
                          if p.is_file())
             for side in ("jax", "port")}
    assert files["port"] == files["jax"]
    for rel in files["jax"]:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel


def test_run_demo_pipeline_drives_the_clis_as_jax(tmp_path, monkeypatch):
    """Both demos in their own working directory with the CLIs they call
    recorded: the same dataset files byte for byte, the same
    experiment.yml and the same argv in the same order (the port's with
    ``--device``)."""
    from pcc_geo_cnn_v2_tpu.cli import ev_run_compare as j_rc
    from pcc_geo_cnn_v2_tpu.cli import ev_run_experiment as j_re
    from pcc_geo_cnn_v2_tpu.cli import tr_train_all as j_tr
    from pcc_geo_cnn_v2_tpu.cli import ut_train_plots as j_pl
    from pcc_geo_cnn_v2_tpu_torch.cli import ev_run_compare as t_rc
    from pcc_geo_cnn_v2_tpu_torch.cli import ev_run_experiment as t_re
    from pcc_geo_cnn_v2_tpu_torch.cli import tr_train_all as t_tr
    from pcc_geo_cnn_v2_tpu_torch.cli import ut_train_plots as t_pl
    from pcc_geo_cnn_v2_tpu_torch.tools import run_demo_pipeline

    calls = {"jax": [], "port": []}
    for side, mods in (("jax", (j_tr, j_re, j_rc, j_pl)),
                       ("port", (t_tr, t_re, t_rc, t_pl))):
        for mod in mods:
            _record_cli(monkeypatch, mod, calls[side],
                        mod.__name__.rsplit(".", 1)[1])
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["run_demo_pipeline", "7"])
            _jax_tool("run_demo_pipeline").main()
        else:
            run_demo_pipeline.main(["7", "--device", "cpu"])
    want = [(n, a) for n, a in calls["jax"]]
    got = [(n, a[:-2] if a[-2:] == ["--device", "cpu"] else a)
           for n, a in calls["port"]]
    assert got == want and len(want) == 4
    assert [n for n, a in calls["port"] if a[-2:] == ["--device", "cpu"]] \
        == ["tr_train_all", "ev_run_experiment"]
    files = {side: sorted(str(p.relative_to(tmp_path / side))
                          for p in (tmp_path / side).rglob("*")
                          if p.is_file())
             for side in ("jax", "port")}
    assert files["port"] == files["jax"] and len(files["jax"]) == 259
    for rel in files["jax"]:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel

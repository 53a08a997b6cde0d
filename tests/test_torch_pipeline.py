"""The port's RD experiment pipeline against the JAX package's, on the CPU.

- ``parallel_process``: the same child commands in both pools give the
  same launch order, the same failure (with the child's log) and the same
  cleanup. Exact.
- ``tr_train_all``: the training command lines of both packages, recorded
  at ``subprocess.run``, equal with the module name swapped and the port's
  ``--device`` removed: ``independent`` and ``warm_seq``, per-config and
  spec-level keys, the ``resolution`` rule, the ``done`` skip.
- ``ev_run_experiment``: the job list equal to JAX's, but ``device``.
- ``ev_compare`` / ``ev_run_compare`` on a tree of seeded reports: the
  CSVs byte for byte, the BD matrices within 1e-12.
- ``ut_train_plots.read_log`` and ``plots.style_for`` equal to JAX's.
- One real run at a tiny size through child processes (JAX
  ``tests/test_pipeline.py``): c1 at 8 filters, two λ in warm_seq, then the
  experiments two at a time, the idempotent rerun and the comparison.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from pcc_geo_cnn_v2_tpu.cli import ev_run_experiment as jax_ere
from pcc_geo_cnn_v2_tpu.cli import tr_train_all as jax_tta
from pcc_geo_cnn_v2_tpu.utils import parallel_process as jax_pp
from pcc_geo_cnn_v2_tpu_torch.cli import ev_run_experiment as ere
from pcc_geo_cnn_v2_tpu_torch.cli import tr_train_all as tta
from pcc_geo_cnn_v2_tpu_torch.utils import parallel_process as pp

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file: test files run in parallel
    worker processes, and torch's default of a thread a core oversubscribes
    the CPU many times over on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- imports -----------------------------------------------------------------

SLICE_MODULES = (
    "utils.parallel_process", "utils.experiment", "utils.plots",
    "cli.tr_train_all", "cli.map_color", "cli.ev_experiment",
    "cli.ev_run_experiment", "cli.ev_compare", "cli.ev_run_compare",
    "cli.ut_train_plots", "coding.binary_coder", "coding.octree_anchor",
    "cli.mp_report", "cli.mp_run")


@pytest.fixture(scope="module")
def imported_without_optional_packages():
    """Every module of the slice imported in a child where PyYAML, pandas
    and matplotlib cannot be imported (the card's machine may lack them):
    {module: error text or None}."""
    code = """
import importlib, json, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("yaml", "pandas", "matplotlib"):
            raise ImportError(f"blocked {name}")
sys.meta_path.insert(0, Block())
out = {}
for m in sys.argv[1:]:
    try:
        importlib.import_module("pcc_geo_cnn_v2_tpu_torch." + m)
        out[m] = None
    except Exception as e:
        out[m] = repr(e)
print(json.dumps(out))
"""
    proc = subprocess.run([sys.executable, "-c", code, *SLICE_MODULES],
                          cwd=REPO, capture_output=True, text=True,
                          check=True, timeout=120)
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_module_imports_without_yaml_pandas_matplotlib(
        imported_without_optional_packages, module):
    assert imported_without_optional_packages[module] is None


# -- parallel_process --------------------------------------------------------


def _pool_run(module, tmp_path, codes, parallelism, sleepers=()):
    """Run children ``exit(code)`` (or ``sleep`` for the indices in
    ``sleepers``) through ``module.parallel_process``; returns (launch
    order, the error text or None, the children)."""
    order, procs = [], []

    def launch(i, code):
        order.append(i)
        log = open(tmp_path / f"{module.__name__}.{i}.log", "w")
        body = ("import time; time.sleep(60)" if i in sleepers else
                f"print('child {i} says', {code}); raise SystemExit({code})")
        p = module.Popen([sys.executable, "-c", body], stdout=log,
                         stderr=subprocess.STDOUT)
        procs.append(p)
        return p

    err = None
    try:
        module.parallel_process(launch, list(enumerate(codes)), parallelism,
                                progress=False)
    except RuntimeError as e:
        err = str(e)
    for p in procs:
        p.wait(timeout=30)
    return order, err, procs


@pytest.mark.parametrize("parallelism", [1, 2, 5])
def test_parallel_process_order_matches_jax(tmp_path, parallelism):
    codes = [0] * 5
    want, err_j, _ = _pool_run(jax_pp, tmp_path, codes, parallelism)
    got, err_p, _ = _pool_run(pp, tmp_path, codes, parallelism)
    assert got == want == [4, 3, 2, 1, 0][:len(got)]
    assert err_j is None and err_p is None


def test_parallel_process_failure_carries_the_log_and_cleans_up(tmp_path):
    """A failing child raises with its command and log; the child still
    running is terminated; both pools alike."""
    codes = [0, 0, 3]  # popped from the end: the failing child starts first
    out = {}
    for module in (jax_pp, pp):
        order, err, procs = _pool_run(module, tmp_path, codes, 2,
                                      sleepers={1})
        out[module] = (order, err, [p.returncode for p in procs])
    (o_j, e_j, rc_j), (o_p, e_p, rc_p) = out[jax_pp], out[pp]
    assert o_p == o_j == [2, 1]
    assert e_p == e_j
    assert "returned 3" in e_p and "child 2 says 3" in e_p
    assert rc_p == rc_j and rc_p[0] == 3 and rc_p[1] < 0  # SIGTERM


# -- tr_train_all -------------------------------------------------------------


def _strip_device(cmd):
    i = cmd.index("--device")
    assert cmd[i + 1] == "cpu"
    return cmd[:i] + cmd[i + 2:]


def _record_train_cmds(monkeypatch, module, yml, model_dir, extra=()):
    calls = []

    def fake_run(cmd, check=False, **kw):
        assert check
        calls.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    argv = [str(yml), str(model_dir)] + list(extra)
    if module is tta:
        argv += ["--device", "cpu"]
    module.main(argv)
    monkeypatch.undo()
    return calls


TRAIN_SPECS = {
    "independent": {
        "train_glob": "blocks/*.ply",
        "resolution": 1024, "alpha": 0.8, "max_steps": 9,
        "model_configs": [
            {"id": "a", "config": "c3p", "lambdas": [1e-4, 3e-4]},
            {"id": "b", "config": "c1", "lambdas": [5e-5],
             "resolution": 32, "num_filters": 8, "alpha": 0.7,
             "batch_size": 4, "gamma": 1.5},
        ]},
    "warm_seq": {
        "mpeg_dataset_path": "mpeg/**/*.ply", "batch_size": 2,
        "model_configs": [
            {"id": "w", "config": "c3p", "train_mode": "warm_seq",
             "lambdas": [1e-5, 2e-5, 5e-5], "max_steps": 3},
            {"id": "v", "config": "c2", "train_mode": "warm_seq",
             "lambdas": [1e-4, 2e-4]},
        ]},
}


@pytest.mark.parametrize("kind", sorted(TRAIN_SPECS))
@pytest.mark.parametrize("done", [(), ("w", "1.00e-05"), ("a", "1.00e-04")])
def test_tr_train_all_commands_match_jax(tmp_path, monkeypatch, kind, done):
    spec = TRAIN_SPECS[kind]
    yml = tmp_path / "exp.yml"
    yml.write_text(yaml.safe_dump(spec))
    model_dir = tmp_path / "models"
    if done:
        (model_dir / done[0] / done[1]).mkdir(parents=True)
        (model_dir / done[0] / done[1] / "done").touch()
    extra = ["--extra_args", "--val_every 3 --val_batches 1"]
    want = _record_train_cmds(monkeypatch, jax_tta, yml, model_dir, extra)
    got = _record_train_cmds(monkeypatch, tta, yml, model_dir, extra)
    n_runs = sum(len(mc["lambdas"]) for mc in spec["model_configs"])
    skipped = int(bool(done) and done[0] in {mc["id"] for mc in
                                             spec["model_configs"]})
    assert len(got) == len(want) == n_runs - skipped
    for g, w in zip(got, want):
        assert g[2] == "pcc_geo_cnn_v2_tpu_torch.cli.train"
        assert w[2] == "pcc_geo_cnn_v2_tpu.cli.train"
        assert _strip_device(g)[3:] == w[3:]
        assert g[:2] == w[:2] == [sys.executable, "-m"]
    flat = [" ".join(c) for c in got]
    assert not any("--resolution 1024" in c for c in flat)
    if kind == "warm_seq":
        warm = [c for c in flat if "--warm_start" in c]
        assert len(warm) == 3  # every λ but each config's first
        if skipped:
            assert f"--warm_start {model_dir}/w/1.00e-05" in flat[0]


def test_lmbda_tag_names_the_committed_assets():
    assets = REPO / "pcc_geo_cnn_v2_tpu/assets/rd/c3p-a0.75"
    names = sorted(p.name[:-len(".msgpack.gz")]
                   for p in assets.glob("*.msgpack.gz"))
    tags = sorted(tta.lmbda_tag(float(n)) for n in names)
    assert tags == names
    for x in (1e-5, 2e-5, 5e-5, 1e-4, 3e-4, 0.5, 7):
        assert tta.lmbda_tag(x) == jax_tta.lmbda_tag(x)


# -- ev_run_experiment ----------------------------------------------------------


def _record_jobs(monkeypatch, module, yml, extra=()):
    jobs = []

    def fake_pool(launch, params, parallelism):
        for p, f in params:
            jobs.append(dict(p))
            f.close()
        jobs.append(parallelism)

    monkeypatch.setattr(module, "parallel_process", fake_pool)
    module.main([str(yml), "--num_parallel", "3", *extra])
    monkeypatch.undo()
    return jobs


@pytest.mark.parametrize("variant", ["defaults", "full"])
def test_ev_run_experiment_jobs_match_jax(tmp_path, monkeypatch, variant):
    spec = {
        "experiment_dir": str(tmp_path / "exp"),
        "model_dir": str(tmp_path / "models"),
        "data": [{"pc_name": "p0", "input_pc": "/d/p0.ply"},
                 {"pc_name": "p1", "input_pc": "/d/p1.ply",
                  "input_norm": "/d/p1_n.ply"}],
        "model_configs": [
            {"id": "c3p-a0.75", "config": "c3p", "lambdas": [1e-5, 3e-4]},
            {"id": "small", "config": "c1", "num_filters": 8,
             "lambdas": [2e-4]}],
    }
    if variant == "full":
        spec.update(resolution=512, octree_level=3,
                    opt_metrics=["d1_mse", "d2_mse"], max_deltas=[1, 2])
        # every report of one experiment exists: it is skipped
        done = tmp_path / "exp/p0/c3p-a0.75/1.00e-05"
        done.mkdir(parents=True)
        for g in ("d1", "d2"):
            (done / f"report_{g}.json").write_text("{}")
        # one of two reports only: it runs
        half = tmp_path / "exp/p1/small/2.00e-04"
        half.mkdir(parents=True)
        (half / "report_d1.json").write_text("{}")
    yml = tmp_path / "exp.yml"
    yml.write_text(yaml.safe_dump(spec))
    want = _record_jobs(monkeypatch, jax_ere, yml)
    got = _record_jobs(monkeypatch, ere, yml, ["--device", "cpu"])
    assert got[-1] == want[-1] == 3
    assert len(got) == len(want) == (6 if variant == "full" else 7)
    for g, w in zip(got[:-1], want[:-1]):
        assert g.pop("device") == "cpu"
        assert g == w
    assert (tmp_path / "exp/p1/small/2.00e-04/experiment.log").exists()


def test_run_experiment_command_matches_jax(monkeypatch):
    from pcc_geo_cnn_v2_tpu.cli import ev_experiment as jax_ee
    from pcc_geo_cnn_v2_tpu_torch.cli import ev_experiment as ee

    seen = []

    class FakePopen:
        def __init__(self, cmd, stdout=None, stderr=None):
            seen.append(cmd)

    monkeypatch.setattr(jax_pp, "Popen", FakePopen)
    monkeypatch.setattr(pp, "Popen", FakePopen)
    params = {"output_dir": Path("/o"), "model_dir": "/m", "resolution": 64,
              "opt_metrics": ["d1_mse", "d2_mse"], "max_deltas": ["inf"],
              "fixed_threshold": True}
    jax_ee.run_experiment(params)
    ee.run_experiment({**params, "device": "cpu"})
    want, got = seen
    assert want[2] == "pcc_geo_cnn_v2_tpu.cli.ev_experiment"
    assert got[2] == "pcc_geo_cnn_v2_tpu_torch.cli.ev_experiment"
    assert _strip_device(got)[3:] == want[3:]


# -- ev_compare / ev_run_compare ------------------------------------------------


MODES = ("c3p-a0.75", "c3p-train", "anchor")


def _report_tree(root, seed):
    """Seeded reports: two clouds × three modes × four λ; ``anchor`` has no
    d2-group report on the second cloud, one point of c3p-train is left out by
    ``bd_ignore``."""
    rng = np.random.default_rng(seed)
    for pc in ("figure_200", "figure_201"):
        for k, mode in enumerate(MODES):
            bpp = np.sort(rng.uniform(0.05, 2.0, 4))
            psnr = 55 + 6 * np.log(bpp) + 3 * k + rng.normal(0, 0.2, 4)
            for lam, (b, p) in enumerate(zip(bpp, psnr)):
                d = root / pc / mode / tta.lmbda_tag(10.0 ** -(lam + 2))
                d.mkdir(parents=True)
                rep = {"bpp": float(b), "d1_psnr": float(p),
                       "d2_psnr": float(p + 4), "pc_name": pc}
                (d / "report_d1.json").write_text(json.dumps(
                    {**rep, "opt_group": "d1"}))
                if not (mode == "anchor" and pc == "figure_201"):
                    (d / "report_d2.json").write_text(json.dumps(
                        {**rep, "bpp": float(b * 1.01), "opt_group": "d2"}))
    spec = {"experiment_dir": str(root),
            "data": [{"pc_name": "figure_200"}, {"pc_name": "figure_201"},
                     {"pc_name": "absent"}],
            "bd_ignore": ["c3p-train/1.00e-03"]}
    yml = root.parent / f"{root.name}.yml"
    yml.write_text(yaml.safe_dump(spec))
    return yml


@pytest.mark.parametrize("plot", [False, True])
def test_ev_run_compare_csvs_match_jax_byte_for_byte(tmp_path, plot):
    from pcc_geo_cnn_v2_tpu.cli import ev_run_compare as jax_erc
    from pcc_geo_cnn_v2_tpu_torch.cli import ev_run_compare as erc

    extra = ["--metrics", "d1_psnr", "d2_psnr"] + ([] if plot else
                                                   ["--no_plot"])
    jax_erc.main([str(_report_tree(tmp_path / "jax", 3))] + extra)
    erc.main([str(_report_tree(tmp_path / "port", 3))] + extra)
    want = sorted(p.name for p in (tmp_path / "jax/results").iterdir())
    got = sorted(p.name for p in (tmp_path / "port/results").iterdir())
    assert got == want
    csvs = [n for n in got if n.endswith(".csv")]
    assert {"data.csv", "bdrate.csv", "bdsnr.csv",
            "figure_201_d2_psnr_bdrate.csv"} <= set(csvs)
    for name in csvs:
        assert (tmp_path / "port/results" / name).read_bytes() == \
            (tmp_path / "jax/results" / name).read_bytes(), name
    if plot:
        assert {"legend.png", "figure_200_d1_psnr_rd.png"} <= set(got)


@pytest.mark.parametrize("metric,group", [("d1_psnr", "d1"),
                                          ("d2_psnr", "d1"),
                                          ("d2_psnr", "d2")])
@pytest.mark.parametrize("pc", ["figure_200", "figure_201"])
def test_load_curves_and_bd_matrices_match_jax(tmp_path, metric, group, pc):
    from pcc_geo_cnn_v2_tpu.cli import ev_compare as jax_ec
    from pcc_geo_cnn_v2_tpu_torch.cli import ev_compare as ec

    _report_tree(tmp_path / "exp", 4)
    args = (tmp_path / "exp", pc, metric, group)
    kw = dict(bd_ignore=["c3p-train/1.00e-03"])
    curves = ec.load_curves(*args, **kw)
    assert curves == jax_ec.load_curves(*args, **kw)
    assert len(curves["c3p-train"]) == 3
    for pchip in (True, False):
        got = ec.bd_matrices(curves, pchip=pchip)
        want = jax_ec.bd_matrices(curves, pchip=pchip)
        for g, w in zip(got, want):
            assert list(g.index) == list(w.index) == sorted(curves)
            assert list(g.columns) == list(w.columns)
            g, w = g.to_numpy(), w.to_numpy()
            assert np.array_equal(np.isnan(g), np.isnan(w))
            ok = ~np.isnan(w)
            assert ok.sum() >= 2
            np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=1e-12)


def test_read_log_and_style_for_match_jax(tmp_path):
    from pcc_geo_cnn_v2_tpu.cli import ut_train_plots as jax_utp
    from pcc_geo_cnn_v2_tpu.utils import plots as jax_plots
    from pcc_geo_cnn_v2_tpu_torch.cli import ut_train_plots as utp
    from pcc_geo_cnn_v2_tpu_torch.utils import plots

    rng = np.random.default_rng(2)
    log = tmp_path / "train_log.jsonl"
    with open(log, "w") as f:
        for step in range(1, 40):
            split = "val" if step % 7 == 0 else "train"
            rec = {"step": step, "split": split,
                   "loss": float(rng.random()), "mbpov": int(step * 3),
                   "note": "x"}
            if step % 3:
                rec["focal_loss"] = float(rng.random())
            f.write(json.dumps(rec) + "\n")
    for split in ("train", "val", "rehydrated_from_assets"):
        assert utp.read_log(log, split) == jax_utp.read_log(log, split)
    modes = [f"m{i}" for i in range(45)]
    for mode in modes + ["other"]:
        assert plots.style_for(mode, modes) == \
            jax_plots.style_for(mode, modes)
    cyc, jcyc = plots.style_cycle(), jax_plots.style_cycle()
    assert [next(cyc) for _ in range(90)] == [next(jcyc) for _ in range(90)]


# -- one real run through child processes ---------------------------------------------


def test_train_sweep_experiments_and_compare_through_children(
        tmp_path, monkeypatch):
    """JAX ``tests/test_pipeline.py`` on the port, ``--device cpu``: c1 at
    8 filters trained on 16³ blocks, two λ in warm_seq; the experiments on
    a 32³ cloud two at a time; the rerun of both starts no child; the
    comparison and the training plots."""
    from pcc_geo_cnn_v2_tpu_torch.cli import ev_run_compare as erc
    from pcc_geo_cnn_v2_tpu_torch.cli import ut_train_plots as utp
    from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
    from pcc_geo_cnn_v2_tpu_torch.utils.data import synthetic_blocks

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the children's torch
    monkeypatch.chdir(REPO)
    blocks_dir = tmp_path / "blocks"
    blocks_dir.mkdir()
    for i, b in enumerate(synthetic_blocks(16, block_size=16, seed=0)):
        pc_io.write_ply(blocks_dir / f"b{i:02d}.ply", b)
    rng = np.random.default_rng(1)
    cloud = np.unique(rng.integers(0, 32, (800, 3)), axis=0).astype(float)
    pc_io.write_ply(tmp_path / "cloud.ply", cloud)
    spec = {
        "train_glob": str(blocks_dir / "*.ply"),
        "experiment_dir": str(tmp_path / "experiments"),
        "model_dir": str(tmp_path / "models"),
        "resolution": 32, "octree_level": 1, "opt_metrics": ["d1_mse"],
        "data": [{"pc_name": "cloud", "input_pc": str(tmp_path / "cloud.ply")}],
        "model_configs": [
            {"id": "c1-t", "config": "c1", "num_filters": 8,
             "resolution": 16, "batch_size": 2, "max_steps": 6,
             "lambdas": [1e-4, 3e-4], "train_mode": "warm_seq"}],
    }
    yml = tmp_path / "experiment.yml"
    yml.write_text(yaml.safe_dump(spec))
    train = [str(yml), spec["model_dir"], "--device", "cpu",
             "--extra_args", "--val_every 3 --val_batches 1"]
    tta.main(train)
    runs = sorted(Path(spec["model_dir"]).glob("c1-t/*/done"))
    assert [p.parent.name for p in runs] == ["1.00e-04", "3.00e-04"]

    ere.main([str(yml), "--num_parallel", "2", "--device", "cpu"])
    reports = sorted(Path(spec["experiment_dir"]).glob("**/report_d1.json"))
    assert len(reports) == 2
    for path in reports:
        rep = json.loads(path.read_text())
        assert {"bpp", "d1_psnr", "pos_total_size_in_bytes",
                "input_point_count"} <= set(rep)
        assert rep["input_point_count"] == len(cloud) and rep["bpp"] > 0

    def no_child(*a, **k):
        raise AssertionError("a rerun started a child")

    monkeypatch.setattr(subprocess, "run", no_child)
    monkeypatch.setattr(subprocess, "Popen", no_child)
    tta.main(train)
    ere.main([str(yml), "--num_parallel", "1", "--device", "cpu"])
    monkeypatch.undo()

    erc.main([str(yml), "--metrics", "d1_psnr"])
    results = Path(spec["experiment_dir"]) / "results"
    for name in ("data.csv", "cloud_d1_psnr_rd.png", "bdrate.csv",
                 "legend.png"):
        assert (results / name).exists(), name
    utp.main([spec["model_dir"], str(tmp_path / "plots")])
    assert (tmp_path / "plots" / "train_loss.png").exists()

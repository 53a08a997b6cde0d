"""One RD experiment through both packages on the CPU.

A c3p at 8 filters with weights from the JAX init (the analysis output
scaled by 30, so that y is not all zero, and the last synthesis bias
raised, so that blocks decode non-empty) is saved once as an orbax
checkpoint through the JAX package's own functions and once as a port
asset; ``ev_experiment.main`` of each package runs on the same 128³
coloured cloud. Equal exactly: the report keys and ``input_point_count``;
``_internal_metrics`` of both on the same PLYs within 1e-12; ``map_color``
of both on the same PLYs byte for byte. Across packages (XLA against
torch convolutions, so a pick at a near tie may differ) the bitstream
size is held within 2% and D1 PSNR within 0.05 dB.
"""

import json

import jax
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.cli import ev_experiment as jax_ee
from pcc_geo_cnn_v2_tpu.cli import map_color as jax_mc
from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
from pcc_geo_cnn_v2_tpu_torch.cli import ev_experiment as ee
from pcc_geo_cnn_v2_tpu_torch.cli import map_color as mc
from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
from pcc_geo_cnn_v2_tpu_torch.weights import save_asset

R, LEVEL, B, NF = 128, 3, 16, 8
SIZE_REL, D1_DB = 0.02, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file: test files run in parallel
    worker processes, and torch's default of a thread a core oversubscribes
    the CPU many times over on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax.numpy as jnp

    from pcc_geo_cnn_v2_tpu.models.configs import MODEL_CONFIGS
    from pcc_geo_cnn_v2_tpu.training import TrainConfig, create_train_state
    from tools.rd_train_all import save_ckpt

    root = tmp_path_factory.mktemp("experiment")
    model = jax_build({**MODEL_CONFIGS["c3p"], "num_filters": NF})
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), np.zeros((1, B, B, B, 1), np.float32),
        training=False))
    # at a fresh init every y symbol is 0: scale the analysis output
    ana = params["params"]["analysis_t"]["Conv_0"]
    ana["kernel"] = ana["kernel"] * 30
    syn = params["params"]["synthesis_t"]
    last = sorted(k for k in syn if k.startswith("ConvTranspose"))[-1]
    syn[last]["bias"] = syn[last]["bias"] + 0.55
    # the JAX side: an orbax checkpoint as tools/assets_to_ckpt.py writes it
    state = create_train_state(model, jax.random.PRNGKey(0),
                               TrainConfig(block_size=16))
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    ckpt_dir = root / "ckpt"
    save_ckpt(ckpt_dir, state, 0)
    asset = root / "w.msgpack.gz"
    save_asset(params, asset)

    pts, nrm = figure_cloud(3, R, with_normals=True)
    rgb = np.random.default_rng(5).integers(0, 256, (len(pts), 3))
    cloud = root / "cloud.ply"
    pc_io.write_ply(cloud, np.hstack([pts, rgb]),
                    ["x", "y", "z", "red", "green", "blue"],
                    dtypes=["f4"] * 3 + ["u1"] * 3)
    norm = root / "cloud_n.ply"
    pc_io.write_ply(norm, np.hstack([pts, nrm]),
                    ["x", "y", "z", "nx", "ny", "nz"])
    common = ["--model_config", "c3p", "--num_filters", str(NF),
              "--input_pc", str(cloud), "--resolution", str(R),
              "--octree_level", str(LEVEL), "--map_color"]
    jax_ee.main(["--output_dir", str(root / "jax"), "--model_dir",
                 str(ckpt_dir)] + common)
    ee.main(["--output_dir", str(root / "port"), "--model_dir", str(asset),
             "--device", "cpu"] + common)
    out = {}
    for side in ("jax", "port"):
        d = root / side
        out[side] = dict(
            dir=d, report=json.loads((d / "report_d1.json").read_text()),
            bin=d / "cloud.d1.bin", dec=d / "cloud.d1.dec.ply")
    return dict(root=root, cloud=cloud, norm=norm, n=len(pts), **out)


def test_report_keys_and_point_count_equal(runs):
    j, p = runs["jax"]["report"], runs["port"]["report"]
    assert sorted(p) == sorted(j)
    assert p["input_point_count"] == j["input_point_count"] == runs["n"]
    for key in ("pc_name", "model_config", "opt_group"):
        assert p[key] == j[key]
    for side in ("jax", "port"):
        assert (runs[side]["dir"] / "cloud.d1.dec.color.ply").exists()
        assert (runs[side]["dir"] / "cloud.d1.bin.enc.metric.json").exists()


def test_rate_and_distortion_within_bounds(runs):
    j, p = runs["jax"]["report"], runs["port"]["report"]
    rel = abs(p["pos_total_size_in_bytes"] - j["pos_total_size_in_bytes"]) \
        / j["pos_total_size_in_bytes"]
    gap = abs(p["d1_psnr"] - j["d1_psnr"])
    print(f"bitstream {p['pos_total_size_in_bytes']} B (port) against "
          f"{j['pos_total_size_in_bytes']} B (JAX): {100 * rel:.3f}%; D1 "
          f"PSNR {p['d1_psnr']:.4f} against {j['d1_psnr']:.4f} dB: "
          f"{gap:.4f} dB")
    assert rel <= SIZE_REL
    assert gap <= D1_DB
    assert p["bpp"] == p["pos_total_size_in_bytes"] * 8 / runs["n"]


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("dec_side", ["jax", "port"])
def test_internal_metrics_match_jax(runs, dec_side, norm):
    args = (str(runs["cloud"]), str(runs[dec_side]["dec"]),
            str(runs["norm"]) if norm else None, R)
    got, want = ee._internal_metrics(*args), jax_ee._internal_metrics(*args)
    assert sorted(got) == sorted(want)
    assert len(got) == (4 if norm else 2)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), k


def test_map_color_matches_jax(runs, tmp_path):
    target = runs["jax"]["dec"]
    jax_mc.map_color(str(runs["cloud"]), str(target), str(tmp_path / "j.ply"))
    mc.map_color(str(runs["cloud"]), str(target), str(tmp_path / "p.ply"))
    assert (tmp_path / "p.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


def test_rerun_is_idempotent(runs):
    """A second run finds every output and writes nothing."""
    d = runs["port"]["dir"]
    before = {p.name: p.stat().st_mtime_ns for p in d.iterdir()}
    ee.main(["--output_dir", str(d), "--model_dir", "/nonexistent",
             "--model_config", "c3p", "--input_pc", str(runs["cloud"]),
             "--resolution", str(R), "--octree_level", str(LEVEL),
             "--map_color", "--device", "cpu"])
    assert {p.name: p.stat().st_mtime_ns for p in d.iterdir()} == before

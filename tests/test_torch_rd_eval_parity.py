"""``rd_eval`` of both packages on the same small cloud, on the CPU.

The committed c3p ladder (``--from-assets --run_id c3p``: 3 λ, 64
filters) on one 64³ ``figure_cloud`` cut to the two 32³ blocks of its
x, y < 32 corner (``--resolution 64 --level 1``, ``--batch_blocks 2``),
in three modes: the adaptive d1 group, ``--fixed_threshold`` and
``--d2_group``. The JAX tool runs through ``sys.argv`` with its
``reference_curves`` patched to ``{}`` (the reference's data.csv is not
here); both write their report to a temporary file.

Held: the same rows (λ, cloud, group); where the two packages picked the
same thresholds, bpp within 1% and every PSNR column within 0.05 dB (XLA
and ATen sum the convolutions in other orders, which can flip a
borderline voxel); where a pick differs, the two picks are a near-tie of
the group's metric on the port's reconstruction; the anchor rows and the
BD figures computed from them equal.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pcc_geo_cnn_v2_tpu.utils.scansim as jax_scansim
import pcc_geo_cnn_v2_tpu_torch.utils.scansim as scansim
from pcc_geo_cnn_v2_tpu.codec import BlockCodec as JaxCodec
from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
from pcc_geo_cnn_v2_tpu_torch.tools import rd_eval
from pcc_geo_cnn_v2_tpu_torch.utils.metrics import compute_metrics

REPO = Path(__file__).resolve().parent.parent
R, LEVEL, SEED = 64, 1, 200
ARGV = ["--from-assets", "--run_id", "c3p", "--resolution", str(R),
        "--level", str(LEVEL), "--seeds", str(SEED), "--batch_blocks", "2"]
MODES = {"d1": [], "fixed": ["--fixed_threshold"], "d2": ["--d2_group"]}
BPP_REL, PSNR_DB = 0.01, 0.05
# a near-tie: the two picks' metric on the port's x_hat, relative
TIE_REL = 1e-3
PSNR_KEYS = ("d1_psnr", "d1_psnr_host", "d2_psnr", "d2_psnr_enc",
             "d1_psnr_on_d2_group")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file, as the other port files:
    test files run in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_real_cloud = scansim.figure_cloud


def _corner_cloud(seed, resolution=1024, density=1.0, with_normals=True):
    """The figure cloud's x, y < resolution / 2 corner: two blocks at
    level 1."""
    pts, nrm = _real_cloud(seed, resolution, with_normals=True)
    keep = (pts[:, 0] < resolution // 2) & (pts[:, 1] < resolution // 2)
    return (pts[keep], nrm[keep]) if with_normals else pts[keep]


def _recording(cls, name, calls):
    real = getattr(cls, name)

    def method(self, blocks, *a, **k):
        data_list, meta = real(self, blocks, *a, **k)
        calls.append(dict(codec=self, blocks=blocks, kw=k,
                          picks=[[t for _, t in g] for g in data_list]))
        return data_list, meta

    return method


@pytest.fixture(scope="module", params=list(MODES))
def runs(request, tmp_path_factory):
    mode = request.param
    tmp = tmp_path_factory.mktemp(f"rd_eval_{mode}")
    spec = importlib.util.spec_from_file_location(
        "jax_tool_rd_eval", REPO / "tools/rd_eval.py")
    jax_eval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_eval)
    calls = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(scansim, "figure_cloud", _corner_cloud)
        m.setattr(jax_scansim, "figure_cloud", _corner_cloud)
        for side, cls in (("jax", JaxCodec), ("port", BlockCodec)):
            for name in ("compress_blocks_device_opt", "compress_blocks"):
                m.setattr(cls, name, _recording(cls, name, calls[side]))
        m.setattr(jax_eval, "reference_curves", lambda **k: {})
        m.setattr(sys, "argv", ["rd_eval", *ARGV, *MODES[mode], "--out",
                                str(tmp / "jax.json")])
        jax_eval.main()
        rd_eval.main(ARGV + MODES[mode] + ["--device", "cpu", "--out",
                                           str(tmp / "port.json")])
    return dict(mode=mode, calls=calls,
                jax=json.loads((tmp / "jax.json").read_text()),
                port=json.loads((tmp / "port.json").read_text()))


def _key(row):
    return row["lmbda"], row["pc_name"], row.get("opt_group", "d1")


def _near_tie(call, group, block, a, b):
    """The group's metric of thresholds ``a`` and ``b`` on the port's
    canonical x_hat of ``block``: equal within ``TIE_REL``."""
    codec, blocks = call["codec"], call["blocks"]
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import flatten_blocks, pack_coords

    flat, offsets = flatten_blocks(blocks)
    budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                 64)
    pts = codec.chunk_points(torch.from_numpy(pack_coords(
        flat, codec.block_size)), offsets, 0, len(blocks), budget)
    x_hat = codec.canonical_chunk(pts, len(blocks))["x_hat"][block, ..., 0]
    x_hat = x_hat.numpy()
    orig = np.asarray(blocks[block])
    metric = "d2_mse" if group else "d1_mse"
    nrm = orig[:, 3:6] if group else None
    vals = [compute_metrics(orig[:, :3], np.argwhere(
        x_hat > codec.thresholds[t]).astype(np.float32), R - 1,
        p1_n=nrm)[metric] for t in (a, b)]
    assert abs(vals[0] - vals[1]) <= TIE_REL * max(vals), (a, b, vals)


def test_same_rows_and_picks_or_near_ties(runs):
    got = {_key(r): r for r in runs["port"]["points"]}
    want = {_key(r): r for r in runs["jax"]["points"]}
    assert sorted(got) == sorted(want) and len(got) == 3 * (
        2 if runs["mode"] == "d2" else 1)
    calls = runs["calls"]
    assert len(calls["jax"]) == len(calls["port"]) == 3
    differ = 0
    for cj, cp in zip(calls["jax"], calls["port"]):
        assert len(cj["picks"]) == len(cp["picks"])
        for g, (pj, pp) in enumerate(zip(cj["picks"], cp["picks"])):
            for i, (a, b) in enumerate(zip(pp, pj)):
                if a != b:
                    _near_tie(cp, g, i, a, b)
                    differ += 1
    print(f"{runs['mode']}: {differ} pick(s) differ (near-ties)")


def test_rows_within_bounds(runs):
    got = {_key(r): r for r in runs["port"]["points"]}
    want = {_key(r): r for r in runs["jax"]["points"]}
    # one call a λ (one cloud), λ ascending in both
    lambdas = sorted({k[0] for k in want})
    calls = dict(zip(lambdas, zip(runs["calls"]["jax"],
                                  runs["calls"]["port"])))
    for key, w in want.items():
        g = got[key]
        assert sorted(g) == sorted(w), key
        print(key, {k: (g[k], w[k]) for k in w if k not in
                    ("lmbda", "pc_name", "opt_group")})
        cj, cp = calls[key[0]]
        group = 1 if key[2] == "d2" else 0
        if cj["picks"][group] != cp["picks"][group]:
            continue  # a near-tie (held above) moves the row
        assert abs(g["bpp"] - w["bpp"]) <= BPP_REL * w["bpp"], key
        for k in PSNR_KEYS:
            if k in w and np.isfinite(w[k]):
                assert abs(g[k] - w[k]) <= PSNR_DB, (key, k, g[k], w[k])
            elif k in w:  # an empty reconstruction in both
                assert g[k] == w[k], (key, k, g[k], w[k])


def test_anchor_equal_and_report_keys(runs):
    got, want = runs["port"], runs["jax"]
    assert list(got) == list(want)
    assert got["anchor_points"] == want["anchor_points"]
    assert got["anchor_avg_curve"] == want["anchor_avg_curve"]
    assert got["d2_group_encoded"] == want["d2_group_encoded"] == (
        runs["mode"] == "d2")
    assert got["train_steps"] == want["train_steps"]
    assert got["bd_vs_reference"] == want["bd_vs_reference"] == {}
    # BD of the JAX rows against the anchor, through the port's summary:
    # the JAX tool's figures
    again = json.loads(json.dumps(rd_eval.summarize(
        want["points"], want["anchor_points"], want["train_steps"])))
    for k in ("bd_vs_builtin_octree_anchor",
              "bd_vs_builtin_octree_anchor_d2"):
        assert again.get(k) == want.get(k), k

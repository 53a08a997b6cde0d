"""The port's host-threshold encoder on the CPU, against the JAX package.

- ``utils/threshold.compute_optimal_thresholds``: names and picks equal to
  the JAX function on the seeds of ``tests/test_threshold_sweep.py`` (d1
  metrics, max_delta filters, d1 + d2 with normals), the degenerate
  all-below block and ``fixed_threshold``;
- ``select_best_per_opt_metric``: the JAX function's choice and metrics;
- ``BlockCodec.compress_blocks`` fixed and adaptive, and the CLI's
  ``--fixed_threshold`` and ``--threshold_mode host``, with a small c1 (8
  filters, seeded flax-init weights): every stream decodes bit-exactly
  through the port's own decoder; the adaptive d1 picks equal the device
  sweep's;
- the codec's ``need_metrics=False`` (no metric pass for a lone candidate)
  and ``n_thresholds=64`` on the plain sweep (picks equal JAX's exact
  sweep on the port's x_hat, equal streams across backends).
"""

import gzip
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.codec import (
    select_best_per_opt_metric as jax_select_best,
)
from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
from pcc_geo_cnn_v2_tpu.ops.threshold_sweep import select_thresholds_d1_batch
from pcc_geo_cnn_v2_tpu.utils import threshold as jth
from pcc_geo_cnn_v2_tpu_torch import codec as tcodec
from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
from pcc_geo_cnn_v2_tpu_torch.coding.syntax import (
    load_compressed_file,
    save_compressed_file,
)
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import flatten_blocks, pack_coords
from pcc_geo_cnn_v2_tpu_torch.utils import threshold as tth
from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud

B, T = 16, 64
THR = np.linspace(0, 1.0, T)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file: test files run in parallel
    worker processes, and torch's default of a thread a core oversubscribes
    the CPU many times over on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, lift=0.0):
    """``tests/test_threshold_sweep.py``'s block, with unit normals."""
    rng = np.random.default_rng(seed)
    pts = np.unique(rng.integers(0, B, (rng.integers(30, 300), 3)), axis=0)
    occ = np.zeros((B, B, B), np.float32)
    occ[pts[:, 0], pts[:, 1], pts[:, 2]] = 1.0
    noise = rng.random((B, B, B)).astype(np.float32)
    x_hat = np.clip(0.65 * occ + 0.35 * noise + lift, 0.0, 1.0)
    n = np.random.default_rng(seed + 100).normal(size=(len(pts), 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return pts.astype(np.float64), x_hat, n


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("opt_metrics", [
    ("d1_mse",), ("d1_mse", "d1_mse_BA", "d1_sum_max")])
@pytest.mark.parametrize("max_deltas", [(np.inf,), (np.inf, 3.0)])
def test_optimal_thresholds_equal_jax(seed, opt_metrics, max_deltas):
    pts, x_hat, _ = _case(seed)
    kw = dict(opt_metrics=opt_metrics, max_deltas=max_deltas)
    assert tth.compute_optimal_thresholds(pts, x_hat, THR, B, **kw) == \
        tuple(jth.compute_optimal_thresholds(pts, x_hat, THR, B, **kw))


@pytest.mark.parametrize("seed", [40, 41])
def test_optimal_thresholds_with_normals_equal_jax(seed):
    pts, x_hat, n = _case(seed)
    kw = dict(normals=n, opt_metrics=("d1_mse", "d2_mse", "d2_sum_AB"),
              max_deltas=(np.inf, 1.5))
    got = tth.compute_optimal_thresholds(pts, x_hat, THR, B, **kw)
    assert got == tuple(jth.compute_optimal_thresholds(pts, x_hat, THR, B,
                                                       **kw))
    assert got[0][1] == "d2_mse_inf"


def test_optimal_thresholds_degenerate_and_fixed():
    pts, x_hat, _ = _case(7)
    zero = np.zeros_like(x_hat)
    assert tth.compute_optimal_thresholds(pts, zero, THR, B)[1] == [T - 1]
    assert jth.compute_optimal_thresholds(pts, zero, THR, B)[1] == [T - 1]
    names, picks = tth.compute_optimal_thresholds(
        pts, None, THR, B, opt_metrics=("d1_mse", "d1_sum_AB"),
        fixed_threshold=True)
    assert picks == [T // 2] * 2 and names == ["d1_mse_inf", "d1_sum_AB_inf"]
    got = tth.build_points_threshold(x_hat, THR, len(pts), max_delta=2.0)
    want = jth.build_points_threshold(x_hat, THR, len(pts), max_delta=2.0)
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- the codec's host path on a small c1 -----------------------------------

R, LEVEL, BS, CUT = 128, 3, 8, 12
CFG = dict(model="v1", num_filters=8, analysis="AnalysisTransformV1",
           synthesis="SynthesisTransformV1")


@pytest.fixture(scope="module")
def setup():
    pts, nrm = figure_cloud(3, R, with_normals=True)
    pts6 = np.hstack([pts, nrm])
    blocks, binstr = partition_octree(pts6, [0, 0, 0], [R] * 3, LEVEL)
    params = jax.tree_util.tree_map(np.asarray, jax_build(CFG).init(
        jax.random.PRNGKey(0), np.zeros((1, B, B, B, 1), np.float32),
        training=False))
    syn = params["params"]["synthesis_t"]
    syn["ConvTranspose_2"]["bias"] = syn["ConvTranspose_2"]["bias"] + 0.55
    codec = BlockCodec(build_model(CFG), params, block_size=B,
                       batch_blocks=BS, device="cpu", threads=4)
    # 12 blocks as their own cloud: the adaptive host sweep is KD-tree work
    cut = np.vstack([b[:, :3] + o for b, o in zip(
        blocks[:CUT], tcodec.block_origins(binstr, [0, 0, 0], [R] * 3,
                                           LEVEL)[:CUT])])
    cut = np.hstack([cut, np.vstack([b[:, 3:] for b in blocks[:CUT]])])
    cut_blocks, cut_binstr = partition_octree(cut, [0, 0, 0], [R] * 3, LEVEL)
    assert len(cut_blocks) == CUT
    return dict(pts6=pts6, blocks=blocks, binstr=binstr, params=params,
                codec=codec, cut=cut, cut_blocks=cut_blocks,
                cut_binstr=cut_binstr)


def _decoded(params, binstr, payload, **kw):
    """Container round trip and a fresh decoder instance."""
    blob = gzip.compress(save_compressed_file(binstr, payload, R, LEVEL))
    payload = load_compressed_file(io.BytesIO(gzip.decompress(blob)))[3]
    return BlockCodec(build_model(CFG), params, block_size=B,
                      batch_blocks=BS, device="cpu",
                      **kw).decompress_blocks(payload)


def _assert_bit_exact(dec, meta):
    assert len(dec) == len(meta["x_hat_list"])
    for d, e in zip(dec, meta["x_hat_list"]):
        np.testing.assert_array_equal(d, e)


def test_fixed_threshold_roundtrip(setup):
    s = setup
    dl, md = s["codec"].compress_blocks(s["blocks"], s["binstr"],
                                        s["pts6"], R, LEVEL,
                                        fixed_threshold=True)
    assert len(dl) == 1 and {t for _, t in dl[0]} == {128}
    assert all(len(strings) == 1 for strings, _ in dl[0])  # v1: y only
    _assert_bit_exact(_decoded(s["params"], s["binstr"], dl[0]), md[0])
    assert np.isfinite(md[0]["metrics"]["d1_psnr"])


def test_adaptive_host_roundtrip_and_device_picks(setup):
    s = setup
    args = (s["cut_blocks"], s["cut_binstr"], s["cut"], R, LEVEL)
    dl, md = s["codec"].compress_blocks(*args, with_normals=True,
                                        opt_metrics=("d1_mse", "d2_mse"))
    assert [m["idx"] for m in md] == [0, 1]
    for g in range(2):
        _assert_bit_exact(_decoded(s["params"], s["cut_binstr"], dl[g]),
                          md[g])
    assert "d2_psnr" in md[1]["metrics"]
    ddl, _ = s["codec"].compress_blocks_device_opt(*args)
    assert [t for _, t in ddl[0]] == [t for _, t in dl[0]]
    assert ddl[0] == dl[0]  # same symbols, same picks: same stream


def test_select_best_equals_jax(setup):
    s = setup
    codec, blocks = s["codec"], s["cut_blocks"]
    oms, mds = ("d1_mse", "d1_sum_AB", "d1_mse_BA"), (np.inf, 1.2)
    # the per-block candidates of the six variants, as the device sweep
    # cuts them
    flat, offsets = flatten_blocks(blocks)
    budget = max(int(2 ** np.ceil(np.log2(max(map(len, blocks))))), 64)
    masks = [[] for _ in range(len(oms) * len(mds))]
    for lo in range(0, CUT, BS):
        hi = min(lo + BS, CUT)
        res = codec.encode_chunk(codec.chunk_points(
            torch.from_numpy(pack_coords(flat, B)), offsets, lo, hi, budget),
            hi - lo, oms, mds)
        for m, c in zip(res["masks"], masks):
            c.append(m[:hi - lo].numpy())
    cands = [tcodec.unpack_mask_coords(np.concatenate(c), B) for c in masks]
    names = [f"{m}_{d}" for d in mds for m in oms]
    got = tcodec.select_best_per_opt_metric(
        s["cut_binstr"], cands, LEVEL, names, s["cut"], R, False)
    want = jax_select_best(s["cut_binstr"], cands, LEVEL, names, s["cut"],
                           R, False)
    assert [g["idx"] for g in got] == [w["idx"] for w in want]
    for key, v in want[0]["metrics"].items():
        assert np.isclose(got[0]["metrics"][key], v, rtol=1e-12), key
    np.testing.assert_array_equal(got[0]["blocks_full"],
                                  want[0]["blocks_full"])


def _write_asset(tmp_path, params):
    from flax import serialization

    asset = tmp_path / "w.msgpack.gz"
    asset.write_bytes(gzip.compress(serialization.msgpack_serialize(params)))
    return asset


@pytest.mark.parametrize("mode", [["--fixed_threshold"],
                                  ["--threshold_mode", "host"]])
def test_cli_host_modes_roundtrip(tmp_path, setup, mode):
    from pcc_geo_cnn_v2_tpu_torch.cli import compress, decompress
    from pcc_geo_cnn_v2_tpu_torch.utils import pc_io

    s = setup
    pc_io.write_ply(tmp_path / "in.ply", s["cut"][:, :3])
    common = ["--checkpoint_dir", str(_write_asset(tmp_path, s["params"])),
              "--model_config", "c1", "--num_filters", "8", "--device",
              "cpu", "--batch_blocks", str(BS)]
    compress.main(["--input_files", str(tmp_path / "in.ply"),
                   "--output_files", str(tmp_path / "c.bin"), "--dec_files",
                   str(tmp_path / "enc.ply"), "--resolution", str(R),
                   "--octree_level", str(LEVEL)] + mode + common)
    decompress.main(["--input_files", str(tmp_path / "c.bin"),
                     "--output_files", str(tmp_path / "dec.ply")] + common)
    enc = pc_io.load_points([tmp_path / "enc.ply"])[0]
    dec = pc_io.load_points([tmp_path / "dec.ply"])[0]
    assert len(dec) > 0
    np.testing.assert_array_equal(dec, enc)
    with gzip.open(tmp_path / "c.bin") as f:
        picks = {t for _, t in load_compressed_file(f)[3]}
    assert (picks == {128}) == (mode[0] == "--fixed_threshold")
    assert (tmp_path / "c.bin.enc.metric.json").exists()
    if mode[0] == "--fixed_threshold":
        with pytest.raises(SystemExit):
            compress.main(["--input_files", str(tmp_path / "in.ply"),
                           "--output_files", str(tmp_path / "d.bin"),
                           "--threshold_mode", "device"] + mode + common)


def test_need_metrics_false_skips_the_metric_pass(setup, monkeypatch):
    s = setup
    args = (s["cut_blocks"], s["cut_binstr"], s["cut"], R, LEVEL)
    dl, md = s["codec"].compress_blocks_device_opt(*args)

    def no_metric_pass(*a, **k):
        raise AssertionError("the D1 metric pass ran")

    monkeypatch.setattr(tcodec, "blockwise_d1_sums", no_metric_pass)
    dl2, md2 = s["codec"].compress_blocks_device_opt(*args,
                                                     need_metrics=False)
    assert dl2 == dl and md2[0]["metrics"] is None
    assert md[0]["metrics"]["d1_psnr"] > 0
    np.testing.assert_array_equal(md2[0]["blocks_full"], md[0]["blocks_full"])


@pytest.mark.parametrize("backend", ["xla", "bucket"])
def test_n_thresholds_64(setup, backend):
    s = setup
    codec = BlockCodec(build_model(CFG), s["params"], block_size=B,
                       batch_blocks=BS, device="cpu", n_thresholds=T,
                       sweep_backend=backend)
    assert len(codec.thresholds) == T
    blocks = s["cut_blocks"]
    dl, md = codec.compress_blocks_device_opt(blocks, s["cut_binstr"],
                                              s["cut"], R, LEVEL)
    picks = [t for _, t in dl[0]]
    assert max(picks) < T and len(set(picks)) > 1
    _assert_bit_exact(_decoded(s["params"], s["cut_binstr"], dl[0],
                               n_thresholds=T), md[0])
    # the JAX exact sweep on the port's x_hat of the first chunk
    flat, offsets = flatten_blocks(blocks)
    budget = max(int(2 ** np.ceil(np.log2(max(map(len, blocks))))), 64)
    pts = codec.chunk_points(torch.from_numpy(pack_coords(flat, B)),
                             offsets, 0, BS, budget)
    res = codec.encode_chunk(pts, BS)
    occ = np.zeros((BS, B, B, B), np.float32)
    for i, b in enumerate(blocks[:BS]):
        b = b.astype(np.int64)
        occ[i, b[:, 0], b[:, 1], b[:, 2]] = 1.0
    want = select_thresholds_d1_batch(
        jnp.asarray(occ), jnp.asarray(res["x_hat"][..., 0].numpy()),
        jnp.asarray(codec.thresholds, jnp.float32))
    np.testing.assert_array_equal(res["picks"].numpy(), np.asarray(want))
    np.testing.assert_array_equal(res["picks"][:, 0].numpy(), picks[:BS])

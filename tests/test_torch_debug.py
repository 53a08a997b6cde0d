"""The ``--debug`` harness of the port and what it stands on, against the
JAX package on the CPU.

Small models (c3p and c1 at 8 filters, flax-init weights carried across
with ``params_from_jax``, the last analysis kernel scaled by 30 so that y
is not all zero and the last synthesis bias lifted so that candidate sets
are not empty) on 16³ blocks of a 64³ cloud, 5 blocks a chunk so that the
last chunk is padded:

- ``pack_points``, ``devoxelize_host`` equal JAX's, ``config_names`` JAX's and c3p_cw;
- the per-block rANS ``encode`` gives JAX's bytes and the Python twin's,
  and ``decode`` / ``decode_py`` invert it, symbols of 70,000 and -40,000
  included;
- ``Model.encode`` against flax's: symbols equal except where JAX's
  pre-round value lies within 1e-4 of a .5 boundary, y CDF-row indexes
  equal off the scale-table ties, x_hat within 1e-4 (XLA:CPU and ATen sum
  conv products in other orders);
- ``encode_blocks`` has JAX's keys, shapes and int32 symbols, and its
  symbols and x_hat equal the decoder-canonical ones bit for bit;
- ``entropy_encode(out, i)`` gives JAX's bytes and row i of
  ``entropy_encode_all``;
- ``decompress_blocks(return_debug=True)``: the decoder's symbols equal
  the encoder's, its packed masks are the dump's x_hat cut at the picks
  and unpack to the decoded blocks in argwhere order;
- ``compress --debug`` → ``decompress --debug`` passes, and a dump with
  one ``y_sym`` changed makes it raise, naming ``y_sym``.
"""

import gzip
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_models import _check_symbols

from pcc_geo_cnn_v2_tpu.cli import common as jax_common
from pcc_geo_cnn_v2_tpu.codec import BlockCodec as JaxCodec
from pcc_geo_cnn_v2_tpu.coding import range_coder as jrc
from pcc_geo_cnn_v2_tpu.models import entropy as jent
from pcc_geo_cnn_v2_tpu.models.configs import MODEL_CONFIGS
from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
from pcc_geo_cnn_v2_tpu.ops import voxel as jvox
from pcc_geo_cnn_v2_tpu_torch.cli import common
from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
from pcc_geo_cnn_v2_tpu_torch.coding import range_coder as rc
from pcc_geo_cnn_v2_tpu_torch.models import entropy as tent
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.ops import voxel
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import flatten_blocks, pack_coords
from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree, params_from_jax

ASSET = (Path(__file__).resolve().parent.parent
         / "pcc_geo_cnn_v2_tpu/assets/bench_c3p.msgpack.gz")
R, LEVEL, B, BS, NF = 64, 2, 16, 5, 8
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file (test files run in parallel
    worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud():
    pts = figure_cloud(3, R, with_normals=False)
    blocks, binstr = partition_octree(pts, [0, 0, 0], [R] * 3, LEVEL)
    return pts, blocks, binstr


@pytest.fixture(scope="module", params=["c3p", "c1"])
def setup(request):
    name = request.param
    cfg = dict(MODEL_CONFIGS[name], num_filters=NF)
    jm = jax_build(cfg)
    params = jax.tree_util.tree_map(np.array, jm.init(
        jax.random.PRNGKey(0), np.zeros((1, B, B, B, 1), np.float32),
        training=False))
    ana, syn = params["params"]["analysis_t"], params["params"]["synthesis_t"]
    ana[sorted(k for k in ana if k.startswith("Conv"))[-1]]["kernel"] *= 30
    syn[sorted(k for k in syn if k.startswith("ConvTranspose"))[-1]][
        "bias"] += 0.55
    pts, blocks, binstr = _cloud()
    codec = BlockCodec(build_model(cfg), params, block_size=B,
                       batch_blocks=BS, device="cpu")
    return dict(name=name, cfg=cfg, jm=jm, params=params, pts=pts,
                blocks=blocks, binstr=binstr, codec=codec,
                enc=codec.encode_blocks(blocks))


def test_pack_points_devoxelize_and_config_names_match_jax():
    _, blocks, _ = _cloud()
    for kw in ({}, {"max_points": 1024}, {"dtype": np.int16}):
        got, want = voxel.pack_points(blocks, **kw), jvox.pack_points(
            blocks, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="budget"):
        voxel.pack_points(blocks, max_points=4)
    grid = np.random.default_rng(0).random((B, B, B)).astype(np.float32)
    for t in (0.0, 0.5, 0.97, 1.0):
        got = voxel.devoxelize_host(grid, t)
        want = jvox.devoxelize_host(grid, t)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # the port's configurations: JAX's, then the port's own c3p_cw
    assert common.config_names() == jax_common.config_names() + ["c3p_cw"]


def _tables(kind):
    if kind == "gaussian":
        return tent.build_gaussian_cdf(), jent.build_gaussian_cdf()
    eb = load_asset_tree(ASSET)["params"]["entropy_bottleneck"]
    return (tent.build_factorized_cdf(tent.refine_factorized_quantiles(eb)),
            jent.build_factorized_cdf(jent.refine_factorized_quantiles(eb)))


@pytest.mark.parametrize("kind", ["gaussian", "factorized"])
def test_rc_encode_matches_jax_and_python_twin(kind):
    table, jtable = _tables(kind)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, table.rows, size=(6, 5, 4)).astype(np.int32)
    sym = rng.integers(-12, 13, size=idx.shape).astype(np.int32)
    sym.flat[::37] = rng.integers(-900, 900, size=sym.flat[::37].shape)
    data = rc.encode(sym, idx, table)
    assert data == jrc.encode(sym, idx, jtable)
    assert data == rc.encode_py(sym, idx, table)
    for dec in (rc.decode(data, idx, table), rc.decode_py(data, idx, table)):
        assert dec.dtype == np.int32 and dec.shape == idx.shape
        np.testing.assert_array_equal(dec, sym)
    # one row of the batch call
    assert rc.encode_batch(sym[None], idx, table)[0] == data
    with pytest.raises(ValueError, match="malformed"):
        rc.decode(data[:5], idx, table)


def test_wide_symbols_entropy_roundtrip():
    """rANS escape coding round-trips int32-regime symbols losslessly
    (the port's twin of ``tests/test_wide_symbols.py``)."""
    table = tent.build_gaussian_cdf(np.geomspace(0.11, 64.0, 8), 1e-9)
    rng = np.random.default_rng(0)
    sym = rng.integers(-5, 6, size=(6, 4, 4, 4, 2), dtype=np.int32).ravel()
    sym[7] = 70_000
    sym[19] = -40_000
    idx = np.arange(sym.size, dtype=np.int32) % 8
    data = rc.encode(sym, idx, table)
    np.testing.assert_array_equal(rc.decode(data, idx, table), sym)
    np.testing.assert_array_equal(rc.decode_py(data, idx, table), sym)
    assert data == rc.encode_py(sym, idx, table)
    assert data == jrc.encode(sym, idx, jent.build_gaussian_cdf(
        np.geomspace(0.11, 64.0, 8), 1e-9))


def _occupancy(blocks):
    x = np.zeros((len(blocks), B, B, B, 1), np.float32)
    for i, b in enumerate(blocks):
        b = b.astype(np.int64)
        x[i, b[:, 0], b[:, 1], b[:, 2], 0] = 1.0
    return x


def test_model_encode_matches_flax(setup):
    s = setup
    jm, params = s["jm"], s["params"]
    tm = build_model(s["cfg"])
    tm.load_state_dict(params_from_jax(params))
    x = _occupancy(sorted(s["blocks"], key=len)[-3:])
    want = jax.tree_util.tree_map(np.asarray,
                                  jm.apply(params, x, method=jm.encode))
    got = {k: v.numpy() for k, v in tm.encode(torch.from_numpy(x)).items()}
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    medians = params["params"]["entropy_bottleneck"]["quantiles"][:, 1]
    y = np.asarray(jm.apply(params, x, method=lambda m, v: m.analysis_t(v)))
    if "z_sym" in got:
        z = np.asarray(jm.apply(params, y,
                                method=lambda m, v: m.hyper_analysis_t(v)))
        assert _check_symbols(got["z_sym"], z - medians) < 1e-3
        assert _check_symbols(got["y_sym"], y) < 1e-3
        sigma = np.asarray(jm.apply(params, want["z_sym"],
                                    method=jm.decode_z)[0])
        table = np.asarray(tm.conditional.scale_table[:-1], np.float32)
        near = np.any(np.abs(sigma[..., None] - table) <= 1e-5 * table,
                      axis=-1)
        assert np.array_equal(got["y_idx"][~near], want["y_idx"][~near])
    else:
        assert _check_symbols(got["y_sym"], y - medians) < 1e-3
    assert np.count_nonzero(got["y_sym"]) > 0
    np.testing.assert_allclose(got["x_hat"], want["x_hat"], atol=ATOL,
                               rtol=0)
    assert got["x_hat"].max() > 0.5


def test_encode_blocks_matches_jax_and_the_canonical_pass(setup):
    s = setup
    codec, blocks, enc = s["codec"], s["blocks"], s["enc"]
    jc = JaxCodec(s["jm"], s["params"], block_size=B, batch_blocks=BS)
    want = jc.encode_blocks(blocks)
    assert sorted(enc) == sorted(want)
    for k in enc:
        assert isinstance(enc[k], np.ndarray) and len(enc[k]) == len(blocks)
        assert enc[k].shape == want[k].shape, k
        assert enc[k].dtype == want[k].dtype, k
        if k != "x_hat":
            assert enc[k].dtype == np.int32
    # the symbols and x_hat of the canonical pass, chunk by chunk
    flat, offsets = flatten_blocks(blocks)
    budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                 64)
    flat_t = torch.from_numpy(pack_coords(flat, B))
    for lo, hi in codec._chunks(len(blocks)):
        res = codec.canonical_chunk(
            codec.chunk_points(flat_t, offsets, lo, hi, budget), hi - lo)
        for k in enc:
            got = torch.from_numpy(enc[k][lo:hi])
            assert torch.equal(got, res[k][:hi - lo].to(got.dtype)), (k, lo)


def test_entropy_encode_matches_jax_and_the_batch_call(setup):
    s = setup
    codec = s["codec"]
    jc = JaxCodec(s["jm"], s["params"], block_size=B, batch_blocks=BS)
    for out in (s["enc"], jc.encode_blocks(s["blocks"])):
        batch = codec.entropy_encode_all(out)
        for i in range(len(s["blocks"])):
            got = codec.entropy_encode(out, i)
            assert len(got) == (2 if codec.is_v2 else 1)
            assert got == jc.entropy_encode(out, i) == batch[i], i


def test_return_debug_matches_the_encoder(setup):
    s = setup
    codec, enc = s["codec"], s["enc"]
    data_list, metadata = codec.compress_blocks_device_opt(
        s["blocks"], s["binstr"], s["pts"], R, LEVEL)
    dec, dbg = codec.decompress_blocks(data_list[0], return_debug=True)
    assert len(codec.decompress_blocks(data_list[0])) == len(dec)
    keys = {"y_sym", "packed_masks"} | (
        {"z_sym", "y_idx"} if codec.is_v2 else set())
    assert set(dbg) == keys
    for k in keys - {"packed_masks"}:
        np.testing.assert_array_equal(dbg[k].astype(np.int32), enc[k])
    # the masks are the encoder's x_hat cut at the stream's thresholds
    thr = codec.thresholds[[t for _, t in data_list[0]]].astype(np.float32)
    want = np.packbits((enc["x_hat"][..., 0] > thr[:, None, None, None])
                       .reshape(len(dec), -1), axis=-1, bitorder="big")
    np.testing.assert_array_equal(dbg["packed_masks"], want)
    assert sum(len(d) for d in dec) > 0
    for i, (d, e) in enumerate(zip(dec, metadata[0]["x_hat_list"])):
        np.testing.assert_array_equal(d, e)
        bits = np.unpackbits(dbg["packed_masks"][i], bitorder="big")
        np.testing.assert_array_equal(
            d, np.argwhere(bits.reshape(B, B, B)).astype(np.float32))


def test_cli_debug_roundtrip_and_tampered_dump(tmp_path, setup):
    from flax import serialization

    from pcc_geo_cnn_v2_tpu_torch.cli import compress, decompress

    s = setup
    asset = tmp_path / "w.msgpack.gz"
    asset.write_bytes(gzip.compress(serialization.msgpack_serialize(
        s["params"])))
    ply = tmp_path / "in.ply"
    pc_io.write_ply(ply, s["pts"])
    common_args = ["--checkpoint_dir", str(asset), "--model_config",
                   s["name"], "--num_filters", str(NF), "--device", "cpu",
                   "--batch_blocks", str(BS)]
    stream = str(tmp_path / "c.bin")
    compress.main(["--input_files", str(ply), "--output_files", stream,
                   "--dec_files", str(tmp_path / "enc.ply"),
                   "--resolution", str(R), "--octree_level", str(LEVEL),
                   "--debug"] + common_args)
    dump_path = tmp_path / "c.bin.enc.debug.npz"
    dump = dict(np.load(dump_path))
    assert sorted(dump) == sorted(s["enc"])
    for k, v in dump.items():
        np.testing.assert_array_equal(v, s["enc"][k])
    dec_args = ["--input_files", stream, "--output_files",
                str(tmp_path / "dec.ply"), "--debug"] + common_args
    decompress.main(dec_args)
    enc_pts = pc_io.load_points([tmp_path / "enc.ply"])[0]
    np.testing.assert_array_equal(
        pc_io.load_points([tmp_path / "dec.ply"])[0], enc_pts)
    assert len(enc_pts) > 0

    i = int(np.flatnonzero(dump["y_sym"])[0])
    dump["y_sym"].flat[i] += 1
    np.savez_compressed(dump_path, **dump)
    with pytest.raises(AssertionError, match="y_sym mismatch"):
        decompress.main(dec_args)

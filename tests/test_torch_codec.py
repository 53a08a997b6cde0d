"""The port's codec end to end on the CPU, against itself and the JAX codec.

A small c3p (8 filters, random flax-init weights, final synthesis bias
lifted so candidate sets are non-empty) on a 128³ scan-like cloud cut
into 16³ blocks:

- the port round trip is bit-exact (decode == the encoder's blocks);
- the JAX exact sweep, fed the port's x_hat, picks the port's thresholds;
- against JAX's own ``compress_blocks_device_opt``: bpp within 1% and
  D1 PSNR within 0.05 dB (conv sums differ in order between XLA and
  ATen, which can flip borderline voxels);
- with normals and a d1 + a d2 opt metric: the d1 stream is the stream of
  a run without normals, both streams decode bit-exactly, the encoder's D2
  PSNR agrees with the host oracle, the JAX D2 bucket sweep (Pallas
  kernel in interpret mode), fed the port's x_hat, picks the port's
  thresholds (|Δidx| ≤ 1 allowed only at a < 1e-5 relative near-tie of
  the f32 plane sums, counted), and the JAX codec's own normals encode
  gives the same groups, rate, D2 PSNR and picks;
- the three sweep backends give identical d1 streams;
- the fused-conv backend (``conv_backend="pallas"``, c3p at full width on
  16³ blocks, f32 and bf16): the round trip is bit-exact, and bpp / D1
  PSNR agree with the JAX codec built the same way (Pallas tails in
  interpret mode).
"""

import gzip
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.codec import BlockCodec as JaxCodec
from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
from pcc_geo_cnn_v2_tpu.ops.bucket_sweep import (
    select_thresholds_d1_bucket as jax_bucket_select,
)
from pcc_geo_cnn_v2_tpu.ops.threshold_sweep import select_thresholds_d1_batch
from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
from pcc_geo_cnn_v2_tpu_torch.coding.syntax import (
    load_compressed_file,
    save_compressed_file,
)
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as tbs
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import flatten_blocks, pack_coords
from pcc_geo_cnn_v2_tpu_torch.utils.metrics import compute_metrics
from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud

R, LEVEL, B, BS = 128, 3, 16, 8
CFG = dict(model="v2", num_filters=8,
           analysis="AnalysisTransformProgressiveV2",
           synthesis="SynthesisTransformProgressiveV2")


@pytest.fixture(scope="module")
def setup():
    pts = figure_cloud(3, R, with_normals=False)
    blocks, binstr = partition_octree(pts, [0, 0, 0], [R] * 3, LEVEL)
    jm = jax_build(CFG)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), np.zeros((1, B, B, B, 1), np.float32),
        training=False))
    syn = params["params"]["synthesis_t"]
    last = sorted(k for k in syn if k.startswith("ConvTranspose"))[-1]
    syn[last]["bias"] = syn[last]["bias"] + 0.55
    codec = BlockCodec(build_model(CFG), params, block_size=B,
                       batch_blocks=BS, device="cpu")
    data_list, metadata = codec.compress_blocks_device_opt(
        blocks, binstr, pts, R, LEVEL)
    return dict(pts=pts, blocks=blocks, binstr=binstr, jm=jm, params=params,
                codec=codec, data_list=data_list, metadata=metadata)


def test_roundtrip_bit_exact(setup):
    s = setup
    blob = gzip.compress(save_compressed_file(s["binstr"], s["data_list"][0],
                                              R, LEVEL))
    res, lvl, binstr, payload = load_compressed_file(
        io.BytesIO(gzip.decompress(blob)))
    assert (res, lvl) == (R, LEVEL) and list(binstr) == s["binstr"]
    # a fresh decoder instance, as a separate process would build it
    dec = BlockCodec(build_model(CFG), s["params"], block_size=B,
                     batch_blocks=BS, device="cpu").decompress_blocks(payload)
    enc = s["metadata"][0]["x_hat_list"]
    assert len(dec) == len(enc) == len(s["blocks"])
    for d, e in zip(dec, enc):
        np.testing.assert_array_equal(d, e)
    assert np.isfinite(s["metadata"][0]["metrics"]["d1_psnr"])


def test_jax_sweep_on_port_x_hat_gives_port_picks(setup):
    s = setup
    codec, blocks = s["codec"], s["blocks"][:BS]
    flat, offsets = flatten_blocks(blocks)
    budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                 64)
    pts = codec.chunk_points(torch.from_numpy(pack_coords(flat, B)),
                             offsets, 0, len(blocks), budget)
    res = codec.encode_chunk(pts, len(blocks))
    occ = np.zeros((BS, B, B, B), np.float32)
    for i, b in enumerate(blocks):
        b = b.astype(np.int64)
        occ[i, b[:, 0], b[:, 1], b[:, 2]] = 1.0
    want = select_thresholds_d1_batch(
        jnp.asarray(occ), jnp.asarray(res["x_hat"][..., 0].numpy()),
        jnp.asarray(codec.thresholds, jnp.float32))
    np.testing.assert_array_equal(res["picks"].numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        res["picks"][:, 0].numpy(),
        [t for _, t in s["data_list"][0][:BS]])


def test_matches_jax_codec_rate_and_distortion(setup):
    s = setup
    jc = JaxCodec(s["jm"], s["params"], block_size=B, batch_blocks=BS)
    jdl, jmd = jc.compress_blocks_device_opt(
        s["blocks"], s["binstr"], s["pts"], R, LEVEL)

    def bpp(payload):
        blob = save_compressed_file(s["binstr"], payload, R, LEVEL)
        return len(gzip.compress(blob)) * 8 / len(s["pts"])

    b_port, b_jax = bpp(s["data_list"][0]), bpp(jdl[0])
    assert abs(b_port - b_jax) <= 0.01 * b_jax, (b_port, b_jax)
    p_port = s["metadata"][0]["metrics"]["d1_psnr"]
    p_jax = jmd[0]["metrics"]["d1_psnr"]
    assert abs(p_port - p_jax) <= 0.05, (p_port, p_jax)


def test_multi_candidate_selection_matches_jax(setup):
    """Several d1 variants (opt metric × max delta): the full-cloud D1
    selection picks the same variant and thresholds as the JAX codec."""
    s = setup
    kw = dict(opt_metrics=("d1_mse", "d1_sum_AB"), max_deltas=(np.inf, 1.5))
    dl, md = s["codec"].compress_blocks_device_opt(
        s["blocks"], s["binstr"], s["pts"], R, LEVEL, **kw)
    jc = JaxCodec(s["jm"], s["params"], block_size=B, batch_blocks=BS)
    jdl, jmd = jc.compress_blocks_device_opt(
        s["blocks"], s["binstr"], s["pts"], R, LEVEL, **kw)
    assert len(dl) == len(jdl) == 1
    assert md[0]["idx"] == jmd[0]["idx"]
    assert [t for _, t in dl[0]] == [int(t) for _, t in jdl[0]]
    assert abs(md[0]["metrics"]["d1_psnr"]
               - jmd[0]["metrics"]["d1_psnr"]) <= 0.05


def test_cli_roundtrip(tmp_path, setup):
    """The port's compress/decompress CLIs on the CPU, committed asset
    layout (random weights exported as a flax msgpack asset)."""
    from flax import serialization

    from pcc_geo_cnn_v2_tpu_torch.cli import compress, decompress
    from pcc_geo_cnn_v2_tpu_torch.utils import pc_io

    s = setup
    asset = tmp_path / "w.msgpack.gz"
    asset.write_bytes(gzip.compress(serialization.msgpack_serialize(
        s["params"])))
    ply = tmp_path / "in.ply"
    pc_io.write_ply(ply, s["pts"][:4000])
    common = ["--checkpoint_dir", str(asset), "--model_config", "c3p",
              "--num_filters", "8", "--device", "cpu", "--batch_blocks",
              str(BS)]
    compress.main(["--input_files", str(ply), "--output_files",
                   str(tmp_path / "c.bin"), "--dec_files",
                   str(tmp_path / "enc.ply"), "--resolution", str(R),
                   "--octree_level", str(LEVEL)] + common)
    decompress.main(["--input_files", str(tmp_path / "c.bin"),
                     "--output_files", str(tmp_path / "dec.ply")] + common)
    enc = pc_io.load_points([tmp_path / "enc.ply"])[0]
    dec = pc_io.load_points([tmp_path / "dec.ply"])[0]
    assert len(dec) > 0
    np.testing.assert_array_equal(dec, enc)
    assert (tmp_path / "c.bin.enc.metric.json").exists()


D2_KW = dict(opt_metrics=("d1_mse", "d2_mse"), with_normals=True)


@pytest.fixture(scope="module")
def setup_normals(setup):
    """The same cloud with normals through the port's d1 + d2 encode."""
    pts, nrm = figure_cloud(3, R, with_normals=True)
    np.testing.assert_array_equal(pts, setup["pts"])
    pts6 = np.hstack([pts, nrm])
    blocks, binstr = partition_octree(pts6, [0, 0, 0], [R] * 3, LEVEL)
    assert binstr == setup["binstr"]
    data_list, metadata = setup["codec"].compress_blocks_device_opt(
        blocks, binstr, pts6, R, LEVEL, **D2_KW)
    return dict(pts6=pts6, blocks=blocks, binstr=binstr,
                data_list=data_list, metadata=metadata)


def _decode(params, binstr, payload):
    blob = gzip.compress(save_compressed_file(binstr, payload, R, LEVEL))
    payload = load_compressed_file(io.BytesIO(gzip.decompress(blob)))[3]
    return BlockCodec(build_model(CFG), params, block_size=B,
                      batch_blocks=BS, device="cpu").decompress_blocks(payload)


def test_normals_encode_two_groups_roundtrip(setup, setup_normals):
    s, sn = setup, setup_normals
    assert [m["idx"] for m in sn["metadata"]] == [0, 1]
    # the d1 group of a normals run is the run without normals
    assert sn["data_list"][0] == s["data_list"][0]
    assert sn["metadata"][0]["metrics"]["d1_psnr"] == \
        s["metadata"][0]["metrics"]["d1_psnr"]
    for payload, meta in zip(sn["data_list"], sn["metadata"]):
        dec = _decode(s["params"], sn["binstr"], payload)
        for d, e in zip(dec, meta["x_hat_list"]):
            np.testing.assert_array_equal(d, e)
    # encoder-side D2 against the host oracle on the decoded cloud; the
    # tolerance of tests/test_d2_metrics.py (tie-broken neighbours)
    m2 = sn["metadata"][1]["metrics"]
    dec_full = sn["metadata"][1]["blocks_full"]
    assert len(dec_full) > 0
    host = compute_metrics(sn["pts6"][:, :3], dec_full, R - 1,
                           p1_n=sn["pts6"][:, 3:6])
    np.testing.assert_allclose(m2["d1_sum_AB"], host["d1_sum_AB"], rtol=1e-9)
    np.testing.assert_allclose(m2["d1_sum_BA"], host["d1_sum_BA"], rtol=1e-9)
    assert abs(m2["d2_psnr"] - host["d2_psnr"]) < 0.25


def test_jax_d2_sweep_on_port_x_hat_gives_port_picks(setup, setup_normals):
    """All chunks: the JAX D2 bucket sweep on the port's canonical x_hat
    against the picks the port put into its two streams."""
    s, sn = setup, setup_normals
    codec, blocks = s["codec"], sn["blocks"]
    flat, offsets = flatten_blocks(blocks)
    budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                 64)
    flat_dev = torch.from_numpy(pack_coords(flat, B))
    nrm_dev = torch.from_numpy(flatten_blocks(blocks, cols=(3, 4, 5),
                                              dtype=np.float32)[0])
    thr = jnp.asarray(codec.thresholds, jnp.float32)
    port = np.array([[t for _, t in dl] for dl in sn["data_list"]]).T
    near_ties = 0
    for lo in range(0, len(blocks), BS):
        hi = min(lo + BS, len(blocks))
        pts = codec.chunk_points(flat_dev, offsets, lo, hi, budget)
        nrm = codec.chunk_normals(nrm_dev, offsets, lo, hi, budget)
        res = codec.encode_chunk(pts, hi - lo, D2_KW["opt_metrics"], nrm=nrm)
        np.testing.assert_array_equal(res["picks"][:hi - lo].numpy(),
                                      port[lo:hi])
        want, ovf = jax_bucket_select(
            jnp.asarray(res["x_hat"][..., 0].numpy()),
            jnp.asarray(pts.numpy()), thr, opt_metrics=D2_KW["opt_metrics"],
            K=B ** 3, interpret=True, nrm=jnp.asarray(nrm.numpy()))
        assert not np.asarray(ovf).any()
        got, want = port[lo:hi], np.asarray(want)[:hi - lo]
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        diff = np.nonzero(got[:, 1] != want[:, 1])[0]
        if len(diff):  # allowed only at a near-tie of the d2_mse values
            sums = tbs.bucket_sweep_sums(res["x_hat"][..., 0], pts,
                                         codec.thr_dev, K=B ** 3, nrm=nrm)
            n_orig = (pts[:, :, 0] >= 0).sum(-1).to(torch.float32)
            mse = tbs.metrics_from_sums(sums[4], sums[5], n_orig[:, None],
                                        sums[2], prefix="d2")["d2_mse"].numpy()
        for i in diff:
            a, b = int(got[i, 1]), int(want[i, 1])
            assert abs(a - b) <= 1, (lo + i, a, b)
            va, vb = float(mse[i, a]), float(mse[i, b])
            assert abs(va - vb) <= 1e-5 * max(abs(va), abs(vb)), \
                (lo + i, a, b, va, vb)
        near_ties += len(diff)
    print(f"d2 near-tie pick differences: {near_ties} of {len(blocks)}")
    assert near_ties <= max(1, len(blocks) // 50)


def test_normals_encode_matches_jax_codec(setup, setup_normals):
    """End to end against the JAX codec's own normals encode (its bucket
    backend, kernel in interpret mode): the same two groups, the d2
    stream's bpp within 1% and its D2 / D1 PSNR within 0.05 dB (conv sums
    differ in order between XLA and ATen), and the same d2 picks up to
    one index on at most 2% of the blocks."""
    s, sn = setup, setup_normals
    jc = JaxCodec(s["jm"], s["params"], block_size=B, batch_blocks=BS,
                  sweep_backend="bucket")
    jdl, jmd = jc.compress_blocks_device_opt(
        sn["blocks"], sn["binstr"], sn["pts6"], R, LEVEL, **D2_KW)
    assert len(jdl) == len(sn["data_list"]) == 2
    assert [m["idx"] for m in jmd] == [m["idx"] for m in sn["metadata"]]

    def bpp(payload):
        blob = save_compressed_file(sn["binstr"], payload, R, LEVEL)
        return len(gzip.compress(blob)) * 8 / len(sn["pts6"])

    for g, keys in ((0, ("d1_psnr",)), (1, ("d2_psnr", "d1_psnr"))):
        b_port, b_jax = bpp(sn["data_list"][g]), bpp(jdl[g])
        assert abs(b_port - b_jax) <= 0.01 * b_jax, (g, b_port, b_jax)
        for k in keys:
            p_port = sn["metadata"][g]["metrics"][k]
            p_jax = jmd[g]["metrics"][k]
            assert abs(p_port - p_jax) <= 0.05, (g, k, p_port, p_jax)
    assert [t for _, t in sn["data_list"][0]] == [int(t) for _, t in jdl[0]]
    got = np.array([t for _, t in sn["data_list"][1]])
    want = np.array([int(t) for _, t in jdl[1]])
    assert np.abs(got - want).max() <= 1
    assert (got != want).sum() <= max(1, len(got) // 50)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_sweep_backends_give_identical_d1_streams(setup, backend):
    s = setup
    codec = BlockCodec(build_model(CFG), s["params"], block_size=B,
                       batch_blocks=BS, device="cpu", sweep_backend=backend)
    dl, md = codec.compress_blocks_device_opt(
        s["blocks"], s["binstr"], s["pts"], R, LEVEL)
    assert len(s["blocks"]) % BS  # the last chunk is a padded one
    assert dl[0] == s["data_list"][0]
    assert md[0]["metrics"] == s["metadata"][0]["metrics"]
    with pytest.raises(ValueError, match="normals"):
        codec._sweep(None, None, None, ("d2_mse",), (np.inf,))


def test_unknown_sweep_backend_raises(setup):
    with pytest.raises(ValueError, match="sweep_backend"):
        BlockCodec(build_model(CFG), setup["params"], block_size=B,
                   device="cpu", sweep_backend="auto")


def test_cli_roundtrip_with_normals(tmp_path, setup, setup_normals):
    """``--input_normals`` with a d1 and a d2 opt metric: two streams per
    input, sidecars with d2 keys, both decode to the encoder's clouds."""
    import json

    from flax import serialization

    from pcc_geo_cnn_v2_tpu_torch.cli import compress, decompress
    from pcc_geo_cnn_v2_tpu_torch.utils import pc_io

    s, sn = setup, setup_normals
    asset = tmp_path / "w.msgpack.gz"
    asset.write_bytes(gzip.compress(serialization.msgpack_serialize(
        s["params"])))
    pc_io.write_ply(tmp_path / "in.ply", sn["pts6"][:, :3])
    pc_io.write_ply(tmp_path / "in_n.ply", sn["pts6"],
                    names=("x", "y", "z", "nx", "ny", "nz"))
    common = ["--checkpoint_dir", str(asset), "--model_config", "c3p",
              "--num_filters", "8", "--device", "cpu", "--batch_blocks",
              str(BS)]
    outs = [str(tmp_path / f"c_{g}.bin") for g in ("d1", "d2")]
    encs = [str(tmp_path / f"enc_{g}.ply") for g in ("d1", "d2")]
    decs = [str(tmp_path / f"dec_{g}.ply") for g in ("d1", "d2")]
    compress.main(["--input_files", str(tmp_path / "in.ply"),
                   "--input_normals", str(tmp_path / "in_n.ply"),
                   "--opt_metrics", "d1_mse", "d2_mse",
                   "--output_files", *outs, "--dec_files", *encs,
                   "--resolution", str(R), "--octree_level", str(LEVEL)]
                  + common)
    decompress.main(["--input_files", *outs, "--output_files", *decs]
                    + common)
    for enc, dec in zip(encs, decs):
        e, d = pc_io.load_points([enc])[0], pc_io.load_points([dec])[0]
        assert len(d) > 0
        np.testing.assert_array_equal(d, e)
    side = json.loads((tmp_path / "c_d2.bin.enc.metric.json").read_text())
    assert "d2_psnr" in side and "d1_psnr" in side
    side1 = json.loads((tmp_path / "c_d1.bin.enc.metric.json").read_text())
    assert "d1_psnr" in side1 and "d2_psnr" not in side1


def _fused_setup(dtype_t, dtype_j):
    """c3p at full width (the JAX tail kernel needs S·C/128 whole), random
    weights, a 64³ cloud in 16³ blocks, conv_backend="pallas" on both
    sides."""
    r, level, bs = 64, 2, 6  # 16 blocks: the last chunk is a padded one
    pts = figure_cloud(4, r, with_normals=False)
    blocks, binstr = partition_octree(pts, [0, 0, 0], [r] * 3, level)
    jm = jax_build("c3p", dtype=dtype_j, conv_backend="pallas")
    params = jax.tree_util.tree_map(np.array, jm.init(
        jax.random.PRNGKey(0), np.zeros((1, B, B, B, 1), np.float32),
        training=False))
    params["params"]["synthesis_t"]["ConvTranspose_0"]["bias"] += 0.55

    def codec():
        return BlockCodec(build_model("c3p", dtype=dtype_t,
                                      conv_backend="pallas"), params,
                          block_size=B, batch_blocks=bs, device="cpu")

    enc = codec()
    data_list, metadata = enc.compress_blocks_device_opt(
        blocks, binstr, pts, r, level)
    blob = gzip.compress(save_compressed_file(binstr, data_list[0], r, level))
    payload = load_compressed_file(io.BytesIO(gzip.decompress(blob)))[3]
    dec = codec().decompress_blocks(payload)  # a fresh decoder
    assert len(dec) == len(blocks) and len(blocks) % bs
    for d, e in zip(dec, metadata[0]["x_hat_list"]):
        np.testing.assert_array_equal(d, e)
    assert sum(len(d) for d in dec) > 0

    jc = JaxCodec(jm, params, block_size=B, batch_blocks=bs)
    jdl, jmd = jc.compress_blocks_device_opt(blocks, binstr, pts, r, level)
    b_port = len(blob) * 8 / len(pts)
    b_jax = len(gzip.compress(save_compressed_file(
        binstr, jdl[0], r, level))) * 8 / len(pts)
    return (b_port, b_jax, metadata[0]["metrics"]["d1_psnr"],
            jmd[0]["metrics"]["d1_psnr"], enc)


def test_fused_conv_backend_roundtrip_and_jax_codec_f32():
    b_port, b_jax, p_port, p_jax, enc = _fused_setup(None, None)
    assert abs(b_port - b_jax) <= 0.01 * b_jax, (b_port, b_jax)
    assert abs(p_port - p_jax) <= 0.05, (p_port, p_jax)
    # the packed tail weights follow set_params
    from pcc_geo_cnn_v2_tpu_torch.ops.fused_conv import packed_tails

    stack = enc.model.synthesis_t
    before = packed_tails(stack, torch.float32)
    tree = jax.tree_util.tree_map(
        lambda a: a * 0.5, {"params": {
            k: v for k, v in _tree_of(enc).items()}})
    enc.set_params(tree)
    after = stack._packed_tails[torch.float32][1]
    assert after is not before
    assert torch.equal(after[0][0], before[0][0] * 0.5)
    assert packed_tails(stack, torch.float32) is after  # packed by the load


def _tree_of(codec):
    """The codec's current parameters as a flax-layout numpy tree."""
    tree = {}
    for key, v in codec.model.state_dict().items():
        *mods, leaf = key.split(".")
        a = v.numpy()
        if leaf == "weight":
            leaf, a = "kernel", a.transpose(2, 3, 4, 1, 0)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    return tree


def test_fused_conv_backend_roundtrip_and_jax_codec_bf16():
    """bf16 stacks on both sides: the decode is bit-exact, and against the
    JAX codec the f32 bounds hold (both sides round at the same points;
    found: bpp and D1 PSNR equal to four decimals)."""
    b_port, b_jax, p_port, p_jax, _ = _fused_setup(torch.bfloat16,
                                                   jnp.bfloat16)
    print(f"bf16 fused backend: bpp {b_port:.4f} vs JAX {b_jax:.4f}, D1 "
          f"PSNR {p_port:.4f} vs {p_jax:.4f} dB")
    assert abs(b_port - b_jax) <= 0.01 * b_jax, (b_port, b_jax)
    assert abs(p_port - p_jax) <= 0.05, (p_port, p_jax)


def test_decoder_backend_must_match_the_encoder(setup):
    """The same weights through the two conv backends give different
    objects with the same interface; the codec keeps the model's backend
    and dtype, and the xla-backend stream of the small model above is
    untouched by the new arguments."""
    m = build_model(CFG, conv_backend="pallas", dtype=torch.bfloat16)
    assert (m.conv_backend, m.dtype) == ("pallas", torch.bfloat16)
    assert build_model(CFG).conv_backend == "xla"
    codec = BlockCodec(build_model(CFG), setup["params"], block_size=B,
                       batch_blocks=BS, device="cpu")
    dl, _ = codec.compress_blocks_device_opt(
        setup["blocks"], setup["binstr"], setup["pts"], R, LEVEL)
    assert dl[0] == setup["data_list"][0]

"""The port's codec end to end on the CPU, against itself and the JAX codec.

A small c3p (8 filters, random flax-init weights, final synthesis bias
lifted so candidate sets are non-empty) on a 128³ scan-like cloud cut
into 16³ blocks:

- the port round trip is bit-exact (decode == the encoder's blocks);
- the JAX exact sweep, fed the port's x_hat, picks the port's thresholds;
- against JAX's own ``compress_blocks_device_opt``: bpp within 1% and
  D1 PSNR within 0.05 dB (conv sums differ in order between XLA and
  ATen, which can flip borderline voxels).
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
from pcc_geo_cnn_v2_tpu.ops.threshold_sweep import select_thresholds_d1_batch
from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
from pcc_geo_cnn_v2_tpu_torch.coding.syntax import (
    load_compressed_file,
    save_compressed_file,
)
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import flatten_blocks, pack_coords
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

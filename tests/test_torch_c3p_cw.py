"""``c3p_cw`` (c3p with the channel-wise context model) against the plain
reference ``tests/plain/c3p_cw_reference.py``, on the CPU at block 16
(latent 2³) with the configuration's 8 slices, on seeded random weights
(the analysis's first layer scaled by 30 so that y is not all zero).

Tolerances, each against the reference's largest magnitude of the same
quantity: μ and ŷ 1e-5 and x̂ 1e-5 (the reference's transposed convs and
the port's sub-pixel forward convs may sum the same products in other
orders, float32 rounding apart; bfloat16, 2⁻⁸ relative, misses them by
far, which a test checks); the σ rows and every symbol exactly (one
rounding apart they would code other symbols). The training loss and the aux loss
1e-5 relative; each leaf's gradient 1e-3 of its largest |g| (as the
port's training parity holds it against JAX). The codec round trip, the
resumable range decoder against the one-shot decoder, and the y string
order of c3p and c3p_cw are exact.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu_torch.coding import range_coder as rc
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.models.entropy import build_gaussian_cdf
from pcc_geo_cnn_v2_tpu_torch.training import (TrainConfig, Trainer,
                                               draw_noise, init_params)
from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
from pcc_geo_cnn_v2_tpu_torch.weights import (merge_trees, params_to_jax,
                                              save_asset)

_spec = importlib.util.spec_from_file_location(
    "c3p_cw_reference",
    Path(__file__).resolve().parent / "plain" / "c3p_cw_reference.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

B = 16  # block size: latent 2³, z 1³
MU_TOL = 1e-5
X_TOL = 1e-5
REL = 1e-5
GRAD_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights():
    """Seeded random c3p_cw weights in the flax layout."""
    m = build_model("c3p_cw")
    init_params(m, torch.Generator().manual_seed(7))
    with torch.no_grad():
        m.analysis_t.AnalysisBlock_0.Conv_0.weight.mul_(30)
    return params_to_jax(m.state_dict())


def _model(tree, dtype=None):
    from pcc_geo_cnn_v2_tpu_torch.weights import params_from_jax

    m = build_model("c3p_cw", dtype=dtype)
    m.load_state_dict(params_from_jax(tree))
    return m.eval()


@pytest.fixture(scope="module")
def cloud():
    pts = figure_cloud(5, 64, with_normals=False)
    blocks, binstr = partition_octree(pts, [0, 0, 0], [64] * 3, 2)
    return pts, blocks, binstr


def _occupancy(blocks):
    """[n, B, B, B, 1] f32 occupancy of integer point blocks, built here."""
    x = torch.zeros(len(blocks), B, B, B, 1)
    for i, b in enumerate(blocks):
        b = torch.as_tensor(np.asarray(b)[:, :3], dtype=torch.long)
        x[i, b[:, 0], b[:, 1], b[:, 2], 0] = 1.0
    return x


def _ncdhw(t):
    return t.permute(0, 4, 1, 2, 3)


def _port_chain(model, x):
    """The port's chain slice by slice: (encode_syms' dict, μ NCDHW)."""
    enc = model.encode_syms(x)
    hyper = model.decode_hyper(enc["z_sym"])
    y_hats, mus = [], []
    cs = model.slice_channels
    for k in range(model.num_slices):
        mu, _ = model.slice_params(hyper, y_hats, k)
        sym = _ncdhw(enc["y_sym"])[:, k * cs:(k + 1) * cs]
        y_hats.append(model.slice_lrp(hyper, y_hats, k, mu, sym))
        mus.append(mu)
    return enc, torch.cat(mus, 1)


def _rel(got, want):
    return float((got.float() - want).abs().max() / want.abs().max())


def test_chain_matches_reference(weights, cloud):
    x = _occupancy(cloud[1][:6])
    model = _model(weights)
    enc, mu = _port_chain(model, x)
    want = ref.CWReference(weights).code(_ncdhw(x))
    assert want["y_sym"].abs().max() >= 2, "y must not be all zero"
    assert torch.equal(_ncdhw(enc["z_sym"]), want["z_sym"])
    assert torch.equal(_ncdhw(enc["y_sym"]), want["y_sym"])
    assert torch.equal(_ncdhw(enc["y_idx"]).long(), want["idx"])
    assert len(torch.unique(want["idx"])) > 4, "σ spans several rows"
    assert _rel(mu, want["mu"]) <= MU_TOL
    assert _rel(enc["y_hat"], want["y_hat"]) <= MU_TOL
    x_hat = model.decode_y(enc["y_hat"])
    assert _rel(_ncdhw(x_hat), want["x_hat"]) <= X_TOL
    # the fused encode of the --debug harness is the same chain
    fused = model.encode(x)
    assert torch.equal(fused["y_sym"], enc["y_sym"])
    assert torch.equal(fused["x_hat"], x_hat)


def test_bfloat16_chain_fails_the_tolerances(weights, cloud):
    """The same chain with every layer in bfloat16: μ and ŷ leave the
    f32 tolerances (so the tolerances can tell the precisions apart)."""
    x = _occupancy(cloud[1][:6])
    enc, mu = _port_chain(_model(weights, torch.bfloat16), x)
    want = ref.CWReference(weights).code(_ncdhw(x))
    assert _rel(mu, want["mu"]) > 10 * MU_TOL
    assert _rel(enc["y_hat"], want["y_hat"]) > 10 * MU_TOL


def test_support_is_the_first_slices(weights, cloud):
    model = _model(weights)
    assert [model.support(list(range(8)), k) for k in range(8)] == [
        [], [0], [0, 1], [0, 1, 2], [0, 1, 2, 3], [0, 1, 2, 3],
        [0, 1, 2, 3], [0, 1, 2, 3]]
    x = _occupancy(cloud[1][:2])
    enc = model.encode_syms(x)
    hyper = model.decode_hyper(enc["z_sym"])
    y_hats = list(enc["y_hat"].split(model.slice_channels, 1))
    mu6 = model.slice_params(hyper, y_hats[:6], 6)[0]
    later = y_hats[:5] + [y_hats[5] + 3.0]
    assert torch.equal(model.slice_params(hyper, later, 6)[0], mu6)
    first = [y_hats[0] + 3.0] + y_hats[1:6]
    assert not torch.equal(model.slice_params(hyper, first, 6)[0], mu6)


def test_training_step_matches_reference(weights, cloud, tmp_path):
    """One ``Trainer`` step (every leaf trainable) against the reference's
    loss and gradients on the same rows and noise."""
    cfg = TrainConfig(lmbda=5e-5, alpha=0.75, batch_size=3, block_size=B)
    trainer = Trainer(build_model("c3p_cw"), cfg, tmp_path, seed=0,
                      device="cpu")
    from pcc_geo_cnn_v2_tpu_torch.weights import params_from_jax

    trainer.model.load_state_dict(params_from_jax(weights))
    blocks = cloud[1][:3]
    pts = np.full((3, max(len(b) for b in blocks), 3), -1, np.int32)
    for i, b in enumerate(blocks):
        pts[i, :len(b)] = b[:, :3]
    noise = draw_noise(trainer.model, 3, B,
                       torch.Generator().manual_seed(11))
    logs = trainer._update(torch.as_tensor(pts), noise)
    got = params_to_jax({n: p.grad for n, p in
                         trainer.model.named_parameters()})["params"]

    r = ref.CWReference(weights, grad=True)
    loss, aux = r.loss(_ncdhw(_occupancy(blocks)), noise["noise_y"],
                       noise["noise_z"], cfg.lmbda, cfg.alpha)
    (loss + aux).backward()
    loss, aux = float(loss.detach()), float(aux.detach())
    assert abs(float(logs["loss"]) - loss) <= REL * abs(loss)
    assert abs(float(logs["aux_loss"]) - aux) <= REL * abs(aux)
    want = r.leaves()
    flat = {}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = v

    walk(got)
    assert sorted(flat) == sorted(want)
    for name, g in flat.items():
        w = want[name].grad
        scale = float(w.abs().max())
        err = float(np.abs(g - w.numpy()).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)
    assert float(want["slice_lrp_3/Conv_2/kernel"].grad.abs().max()) > 0


def test_codec_round_trip_and_cli(weights, cloud, tmp_path, caplog):
    """compress → decompress through ``BlockCodec`` (chunks of 4 blocks,
    the last padded): the decoder's symbols are the encoder's, its points
    the encoder's points, its slice steps counted and its phases logged;
    then the CLIs with c3p's modules and c3p_cw's in two files."""
    import logging

    from pcc_geo_cnn_v2_tpu_torch.cli import compress, decompress
    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.utils import pc_io, trace

    pts, blocks, binstr = cloud
    codec = BlockCodec(build_model("c3p_cw"), weights, block_size=B,
                       n_thresholds=32, batch_blocks=4, device="cpu",
                       sweep_backend="xla")
    data_list, meta = codec.compress_blocks_device_opt(
        blocks, binstr, pts, 64, 2)
    steps = trace.value("slices.decoded")
    with caplog.at_level(logging.INFO, "pcc_geo_cnn_v2_tpu_torch.codec"):
        decoded, debug = codec.decompress_blocks(data_list[0],
                                                 return_debug=True)
    assert trace.value("slices.decoded") - steps == 8 * -(-len(blocks) // 4)
    rec = [r for r in caplog.records
           if r.getMessage().startswith("decompress_blocks_cw(")]
    assert len(rec) == 1 and len(rec[0].args) == 8
    assert not any(r.getMessage().startswith("decompress_blocks(")
                   for r in caplog.records)
    enc = codec.encode_blocks(blocks)
    for key in ("z_sym", "y_sym", "y_idx"):
        np.testing.assert_array_equal(debug[key], enc[key])
    assert np.abs(enc["y_sym"]).max() >= 2
    assert len(blocks) % 4 and sum(len(b) for b in decoded) > 0
    for a, b in zip(decoded, meta[0]["x_hat_list"]):
        np.testing.assert_array_equal(a, b)

    added = {k: v for k, v in weights["params"].items()
             if k.startswith(build_model("c3p_cw").ADDED_PREFIXES)}
    base = {k: v for k, v in weights["params"].items() if k not in added}
    save_asset({"params": base}, tmp_path / "c3p.msgpack.gz")
    save_asset({"params": added}, tmp_path / "cw.msgpack.gz")
    ply = tmp_path / "in.ply"
    pc_io.write_ply(str(ply), pts)
    common = ["--checkpoint_dir", str(tmp_path / "c3p.msgpack.gz"),
              str(tmp_path / "cw.msgpack.gz"), "--model_config", "c3p_cw",
              "--device", "cpu", "--batch_blocks", "4"]
    compress.main(["--input_files", str(ply), "--output_files",
                   str(tmp_path / "s.bin"), "--dec_files",
                   str(tmp_path / "enc.ply"), "--resolution", "64",
                   "--octree_level", "2"] + common)
    decompress.main(["--input_files", str(tmp_path / "s.bin"),
                     "--output_files", str(tmp_path / "dec.ply")] + common)
    got = pc_io.load_points([str(tmp_path / "dec.ply")])[0]
    want = pc_io.load_points([str(tmp_path / "enc.ply")])[0]
    np.testing.assert_array_equal(np.unique(got, axis=0),
                                  np.unique(want, axis=0))


def test_resumable_decoder_matches_one_shot():
    """Eight parts of every stream, decoded in turn over two runs of
    streams, are the one-shot decode; escapes included; a string that
    cannot be a stream raises."""
    table = build_gaussian_cdf()
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 64, (9, 8, 40), dtype=np.int32)
    sym = np.round(rng.normal(size=idx.shape)
                   * np.exp(idx / 12.0)).astype(np.int32)
    sym[2, 0, :3] = [70_000, -40_000, 1_000]
    strings = rc.encode_batch(sym, idx, table)
    np.testing.assert_array_equal(
        rc.decode_batch(strings, idx, table, per_stream=True), sym)
    dec = rc.BatchDecoder(strings, table)
    parts = [np.concatenate([dec.decode(idx[:4, k], 0, 4),
                             dec.decode(idx[4:, k], 4, 9)])
             for k in range(8)]
    np.testing.assert_array_equal(np.stack(parts, 1), sym)
    with pytest.raises(ValueError, match="malformed"):
        rc.BatchDecoder([strings[0], b"\x01" * 9], table)
    dec = rc.BatchDecoder([strings[0][:-4]], table)
    with pytest.raises(ValueError, match="malformed"):
        for k in range(8):
            dec.decode(idx[:1, k])


@pytest.mark.parametrize("name", ["c3p", "c3p_cw"])
def test_y_string_order(weights, cloud, name):
    """c3p's y strings hold y in NDHWC order, as before the channel-wise
    model; c3p_cw's in NCDHW order (slice by slice)."""
    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec

    tree = weights if name == "c3p_cw" else merge_trees(
        {k: v for k, v in weights["params"].items()
         if not k.startswith(("hyper_synthesis_mean_t", "slice_"))})
    codec = BlockCodec(build_model(name), tree, block_size=B,
                       n_thresholds=32, batch_blocks=4, device="cpu",
                       sweep_backend="xla")
    out = codec.encode_blocks(cloud[1][:5])
    y, idx = out["y_sym"], out["y_idx"]
    if name == "c3p_cw":
        y, idx = np.moveaxis(y, -1, 1), np.moveaxis(idx, -1, 1)
    want = rc.encode_batch(y, idx, codec.strings.y_table)
    got = codec.entropy_encode_all(out)
    assert [s[0] for s in got] == want
    assert all(codec.entropy_encode(out, i) == got[i] for i in range(5))


def test_train_tool_trains_the_added_modules_alone(tmp_path):
    """``tools/train_cw.py``: c3p's modules come from c3p's asset and stay
    as they are; the exported asset holds the added modules alone, and
    its escape count is the range coder's."""
    from pcc_geo_cnn_v2_tpu_torch.tools import train_cw
    from pcc_geo_cnn_v2_tpu_torch.weights import (load_asset_tree,
                                                  params_from_jax)

    trainer = train_cw.train(tmp_path / "run", minutes=0.02, resolution=64,
                             level=2, device="cpu", train_seeds=[5],
                             val_seeds=[6], batch=2, workers=1)
    state = trainer.model.state_dict()
    base = params_from_jax(load_asset_tree(train_cw.BASE_ASSET))
    added = trainer.model.ADDED_PREFIXES
    for name, t in base.items():
        assert torch.equal(state[name], t) != name.startswith(added), name
    asset = train_cw.export(tmp_path / "run", tmp_path / "cw.msgpack.gz")
    tree = load_asset_tree(asset)["params"]
    assert sorted(tree) == sorted({k.split(".")[0] for k in state
                                   if k.startswith(added)})
    table = build_gaussian_cdf()
    rows = np.array([0, 0, 63, 63])
    lo = table.offset[rows]
    syms = np.array([lo[0] - 1, lo[1], lo[2] + table.cdf_length[63] - 2,
                     lo[3]])
    assert train_cw.escape_share(syms, rows, table) == 0.5

"""Blocks round-robin over devices (``BlockCodec(devices=[...])``) on the
CPU, against the single-device codec and the JAX codec's round-robin.

Torch has one CPU device, so ``["cpu"] * n`` checks the replicas, the
chunk → replica assignment, the gathering and the bit-exactness, not
scaling (the JAX package's ``bench.py --devices`` makes the same claim on
its virtual CPU mesh). A small c3p (8 filters, flax-init weights, final
synthesis bias lifted) on a 128³ scan-like cloud in 16³ blocks, batch 8,
as ``tests/test_torch_codec.py``; the bucket budget is cut to 300 so that
chunks re-sweep overflowed blocks on the first device. Against the JAX
codec with ``devices=jax.devices()[:2]`` on the conftest's virtual mesh:
bpp within 1% and D1 PSNR within 0.05 dB, the bounds of
``tests/test_torch_codec.py`` (conv sums differ in order between XLA and
ATen). The round robin also runs a small c3p_cw (the same c3p weights,
its added modules drawn by ``training.init_params``, 2 slices), whose
decoder alternates host and lanes per slice. Also: the launch counter
keeps every count under 8 threads.
"""

import gzip
import inspect
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.codec import BlockCodec as JaxCodec
from pcc_geo_cnn_v2_tpu.models.configs import build_model as jax_build
from pcc_geo_cnn_v2_tpu_torch import codec as codec_mod
from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
from pcc_geo_cnn_v2_tpu_torch.coding.syntax import save_compressed_file
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.ops import kernels
from pcc_geo_cnn_v2_tpu_torch.training import init_params
from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
from pcc_geo_cnn_v2_tpu_torch.weights import params_to_jax

R, LEVEL, B, BS = 128, 3, 16, 8
CFG = dict(model="v2", num_filters=8,
           analysis="AnalysisTransformProgressiveV2",
           synthesis="SynthesisTransformProgressiveV2")
CW_CFG = dict(CFG, model="cw", num_slices=2, slice_widths=(8, 8))
D2 = dict(opt_metrics=("d1_mse", "d2_mse"), with_normals=True)
BUCKET_K = 300


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops: one intra-op thread (the tier-1 run has six
    workers on the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    coords, normals = figure_cloud(3, R, with_normals=True)
    pts = np.hstack([coords, normals])
    blocks, binstr = partition_octree(pts, [0, 0, 0], [R] * 3, LEVEL)
    jm = jax_build(CFG)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), np.zeros((1, B, B, B, 1), np.float32),
        training=False))
    syn = params["params"]["synthesis_t"]
    last = sorted(k for k in syn if k.startswith("ConvTranspose"))[-1]
    syn[last]["bias"] = syn[last]["bias"] + 0.55
    cw = init_params(build_model(CW_CFG), torch.Generator().manual_seed(0))
    cw_params = params_to_jax(cw.state_dict())
    cw_params["params"].update(params["params"])
    return dict(pts=pts, blocks=blocks, binstr=binstr, jm=jm, params=params,
                cw_params=cw_params, single={})


def _codec(s, cw=False, **kw):
    codec = BlockCodec(build_model(CW_CFG if cw else CFG),
                       s["cw_params" if cw else "params"], block_size=B,
                       batch_blocks=BS, **kw)
    codec.bucket_k = BUCKET_K  # after construction: every lane reads it
    return codec


def _streams(s, codec, kw):
    data_list, metadata = codec.compress_blocks_device_opt(
        s["blocks"], s["binstr"], s["pts"], R, LEVEL, **kw)
    raw = [gzip.compress(save_compressed_file(s["binstr"], dl, R, LEVEL),
                         mtime=0) for dl in data_list]
    return raw, data_list, metadata


def _single(s, name, kw):
    if name not in s["single"]:
        s["single"][name] = _streams(
            s, _codec(s, name.startswith("cw"), device="cpu"), kw)
    return s["single"][name]


def _record(monkeypatch, codec, method):
    """Wrap ``method`` of the codec: the index of the lane (replica) each
    call ran on, in call order."""
    calls = []
    real = getattr(codec, method)
    sig = inspect.signature(real)

    def wrapper(*a, **kw):
        lane = sig.bind(*a, **kw).arguments.get("lane")
        calls.append(0 if lane is None else codec._lanes.index(lane))
        return real(*a, **kw)

    monkeypatch.setattr(codec, method, wrapper)
    return calls


def _record_models(monkeypatch, codec, method):
    """Wrap ``method`` of every lane's model replica: the index of the
    lane each call ran on, in call order."""
    calls = []
    for i, lane in enumerate(codec._lanes):
        real = getattr(lane.model, method)

        def wrapper(*a, _i=i, _real=real, **kw):
            calls.append(_i)
            return _real(*a, **kw)

        monkeypatch.setattr(lane.model, method, wrapper)
    return calls


@pytest.mark.parametrize("n, name, kw", [(2, "d1", {}), (3, "d1", {}),
                                         (2, "d1+d2", D2), (2, "cw-d1", {})],
                         ids=["2-d1", "3-d1", "2-d1+d2", "2-cw-d1"])
def test_round_robin_gives_the_single_device_streams(setup, monkeypatch,
                                                     caplog, n, name, kw):
    s = setup
    raw1, _, meta1 = _single(s, name, kw)
    codec = _codec(s, name.startswith("cw"), devices=["cpu"] * n)
    assert len(codec._lanes) == n and codec.devices == [
        torch.device("cpu")] * n
    enc = _record(monkeypatch, codec, "_dispatch_chunk")
    dec = _record_models(monkeypatch, codec, "decode_y")
    with caplog.at_level("INFO", logger="pcc_geo_cnn_v2_tpu_torch.codec"):
        raw, data_list, metadata = _streams(s, codec, kw)
    assert any("overflow" in r.message for r in caplog.records)
    n_chunks = -(-len(s["blocks"]) // BS)
    assert n_chunks > n
    assert enc == [k % n for k in range(n_chunks)]
    assert raw == raw1
    assert [m["idx"] for m in metadata] == [m["idx"] for m in meta1]
    for got, want in zip(metadata, meta1):
        assert got["metrics"] == want["metrics"]
    # the encoder's canonical decodes ran on the chunk's replica
    assert dec == enc
    # the decoder round-robins too, and decodes bit-exactly
    dec.clear()
    for g, payload in enumerate(data_list):
        blocks = codec.decompress_blocks(payload)
        assert sum(map(len, blocks)) > 0
        for d, e in zip(blocks, metadata[g]["x_hat_list"]):
            np.testing.assert_array_equal(d, e)
    assert dec == [k % n for k in range(n_chunks)] * len(data_list)


def test_settings_set_after_construction_reach_every_lane(setup,
                                                         monkeypatch):
    """A lane holds only its device, model replica and thresholds: the
    ``bucket_k`` assigned on the codec after construction (``_codec``)
    budgets every chunk's sweep, whichever lane runs it."""
    s = setup
    codec = _codec(s, devices=["cpu"] * 2)
    real = codec_mod.select_thresholds_d1_bucket
    budgets = []

    def spy(*a, K, **kw):
        budgets.append(K)
        return real(*a, K=K, **kw)

    monkeypatch.setattr(codec_mod, "select_thresholds_d1_bucket", spy)
    enc = _record(monkeypatch, codec, "_dispatch_chunk")
    codec.compress_blocks_device_opt(s["blocks"], s["binstr"],
                                     s["pts"][:, :3], R, LEVEL)
    n_chunks = -(-len(s["blocks"]) // BS)
    assert enc == [k % 2 for k in range(n_chunks)]
    # one sweep a chunk at the budget, then the overflow reruns at B³
    assert budgets.count(BUCKET_K) == n_chunks
    assert set(budgets) == {BUCKET_K, B ** 3}


def test_replicas_follow_set_params(setup):
    s = setup
    codec = _codec(s, devices=["cpu", "cpu"])
    models = [lane.model for lane in codec._lanes]
    assert models[0] is not models[1]
    params = jax.tree_util.tree_map(lambda a: a * 0.5, s["params"])
    codec.set_params(params)
    a, b = (m.state_dict() for m in models)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["synthesis_t.ConvTranspose_0.weight"],
                           build_model(CFG).state_dict()[
                               "synthesis_t.ConvTranspose_0.weight"])


def test_device_and_devices_are_exclusive(setup):
    with pytest.raises(ValueError, match="not both"):
        BlockCodec(build_model(CFG), setup["params"], block_size=B,
                   device="cpu", devices=["cpu", "cpu"])


def test_matches_the_jax_round_robin(setup):
    s = setup
    pts = s["pts"][:, :3]
    port = _codec(s, devices=["cpu", "cpu"])
    jc = JaxCodec(s["jm"], s["params"], block_size=B, batch_blocks=BS,
                  devices=jax.devices()[:2])
    _, pdl, pmd = _streams(dict(s, pts=pts), port, {})
    jdl, jmd = jc.compress_blocks_device_opt(s["blocks"], s["binstr"], pts,
                                             R, LEVEL)

    def bpp(payload):
        blob = save_compressed_file(s["binstr"], payload, R, LEVEL)
        return len(gzip.compress(blob)) * 8 / len(pts)

    b_port, b_jax = bpp(pdl[0]), bpp(jdl[0])
    assert abs(b_port - b_jax) <= 0.01 * b_jax, (b_port, b_jax)
    p_port = pmd[0]["metrics"]["d1_psnr"]
    p_jax = jmd[0]["metrics"]["d1_psnr"]
    assert np.isfinite(p_port)
    assert abs(p_port - p_jax) <= 0.05, (p_port, p_jax)


def test_launch_counter_keeps_every_count_under_threads():
    """8 threads add launches at once with a tiny switch interval: a
    read-modify-write without the lock would lose some."""
    name, per_thread, n_threads = "halo_edt", 20_000, 8
    before = kernels.launches[name]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [kernels.count(name) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launches[name] - before == per_thread * n_threads
    kernels.reset_launches()
    assert not any(kernels.launches.values())

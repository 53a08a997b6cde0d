"""The port's spans and counters (``utils/trace.py``) on the CPU.

With no profiler a span opens no profiler range and the codec's three log
records keep their messages and argument counts; under
``torch.profiler`` the codec, the octree and the transposed convs give
every span, nested as the codec runs them; the encode and overflow
records name the blocks swept and re-swept. A small c3p (8
filters, flax-init weights drawn by ``training.init_params``, final
synthesis bias lifted so that blocks decode to points) on a 128³ figure
in 16³ blocks, batch 8, the bucket budget cut to 300 so that chunks
re-sweep overflowed blocks, as ``tests/test_torch_multidevice.py``.
"""

import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pcc_geo_cnn_v2_tpu_torch import codec as codec_module
from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.models.transforms import ConvTranspose
from pcc_geo_cnn_v2_tpu_torch.ops import kernels
from pcc_geo_cnn_v2_tpu_torch.training import init_params
from pcc_geo_cnn_v2_tpu_torch.utils import trace
from pcc_geo_cnn_v2_tpu_torch.utils.octree import (
    departition_octree,
    partition_octree,
)
from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
from pcc_geo_cnn_v2_tpu_torch.weights import params_to_jax

R, LEVEL, B, BS = 128, 3, 16, 8
CFG = dict(model="v2", num_filters=8,
           analysis="AnalysisTransformProgressiveV2",
           synthesis="SynthesisTransformProgressiveV2")
LOGGER = "pcc_geo_cnn_v2_tpu_torch.codec"
BENCH = Path(__file__).resolve().parent.parent / "benchmark"

# span → the span it opens inside, as the codec runs them (None: top)
PARENTS = {
    "octree.partition": {None},
    "codec.encode": {None},
    "codec.dispatch": {"codec.encode"},
    "codec.fetch": {"codec.encode"},
    "codec.sweep_rerun": {"codec.fetch"},
    "codec.entropy_encode": {"codec.encode"},
    "codec.select": {"codec.encode"},
    "codec.d1_metrics": {"codec.select"},
    "octree.departition": {"codec.select", None},
    "codec.decode": {None},
    "codec.z_rans": {"codec.decode"},
    "codec.decode_z": {"codec.decode"},
    "codec.y_rans": {"codec.decode"},
    "codec.decode_y": {"codec.decode"},
    "codec.unpack": {"codec.decode"},
    "transforms.conv_transpose": {"codec.dispatch", "codec.decode_z",
                                  "codec.decode_y"},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops: one intra-op thread (the tier-1 run has six
    workers on the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codec():
    model = init_params(build_model(CFG), torch.Generator().manual_seed(0))
    tree = params_to_jax(model.state_dict())
    syn = tree["params"]["synthesis_t"]
    last = sorted(k for k in syn if k.startswith("ConvTranspose"))[-1]
    syn[last]["bias"] = syn[last]["bias"] + 0.55
    codec = BlockCodec(build_model(CFG), tree, block_size=B,
                       batch_blocks=BS, device="cpu", sweep_backend="bucket")
    codec.bucket_k = 300  # after construction: every lane reads it
    return codec


@pytest.fixture(scope="module")
def cloud():
    return figure_cloud(3, R, with_normals=False).astype(np.float64)


def _round_trip(codec, pts):
    """partition → device-opt encode → decode → departition: (blocks,
    decoded blocks)."""
    blocks, binstr = partition_octree(pts, [0, 0, 0], [R] * 3, LEVEL)
    data_list, _ = codec.compress_blocks_device_opt(blocks, binstr, pts, R,
                                                    LEVEL)
    decoded = codec.decompress_blocks(data_list[0])
    departition_octree(decoded, binstr, [0, 0, 0], [R] * 3, LEVEL)
    return blocks, decoded


def _codec_records(caplog):
    return [r for r in caplog.records if r.name == LOGGER]


def test_no_profiler_opens_no_range(codec, cloud, monkeypatch, caplog):
    """With no profiler a span never enters ``record_function``; the
    codec's log records keep their messages and argument counts."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with caplog.at_level("INFO", logger=LOGGER):
        blocks, decoded = _round_trip(codec, cloud)
        _, binstr = partition_octree(cloud, [0, 0, 0], [R] * 3, LEVEL)
        codec.compress_blocks(blocks, binstr, cloud, R, LEVEL,
                              fixed_threshold=True)
    assert sum(len(b) for b in decoded) > 0
    forms = {"compress_blocks_device_opt(": (4, "compress_blocks_device_opt"
                                             "(%d blocks): device %.2fs, "
                                             "entropy %.2fs, select %.2fs"),
             "compress_blocks(": (5, "compress_blocks(%d blocks, "
                                     "fixed_threshold=%s): device + host "
                                     "sweep %.2fs, entropy %.2fs, select "
                                     "%.2fs"),
             "decompress_blocks(": (6, "decompress_blocks(%d blocks): z rANS "
                                       "%.3fs, decode_z %.3fs, y rANS "
                                       "%.3fs, decode_y+masks %.3fs, unpack "
                                       "%.3fs")}
    seen = set()
    for r in _codec_records(caplog):
        for prefix, (n_args, msg) in forms.items():
            if r.msg.startswith(prefix):
                seen.add(prefix)
                assert r.msg == msg and len(r.args) == n_args
                assert r.args[0] == len(blocks)
                times = [a for a in r.args[1:] if not isinstance(a, bool)]
                assert all(isinstance(t, float) and t >= 0 for t in times)
    assert seen == set(forms)


def _spans(prof):
    """[(span name, the pcc span it is inside or None)] of the trace's
    host ranges."""
    out = []
    for e in prof.events():
        if not e.name.startswith(trace.PREFIX) or e.device_type != \
                torch.autograd.DeviceType.CPU:
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(
                trace.PREFIX):
            parent = parent.cpu_parent
        strip = len(trace.PREFIX)
        out.append((e.name[strip:],
                    None if parent is None else parent.name[strip:]))
    return out


def test_spans_under_the_profiler(codec, cloud, caplog):
    with caplog.at_level("INFO", logger=LOGGER):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            blocks, _ = _round_trip(codec, cloud)
    spans = _spans(prof)
    names = [n for n, _ in spans]
    assert set(names) == set(PARENTS)
    for name, parent in spans:
        assert parent in PARENTS[name], (name, parent)
    chunks = -(-len(blocks) // BS)
    for name, n in (("codec.encode", 1), ("codec.decode", 1),
                    ("codec.dispatch", chunks), ("codec.fetch", chunks),
                    ("codec.entropy_encode", 1), ("codec.select", 1),
                    ("codec.d1_metrics", 1), ("codec.z_rans", 1),
                    ("octree.partition", 1), ("octree.departition", 2)):
        assert names.count(name) == n, name
    reruns = [r for r in _codec_records(caplog) if "overflow" in r.msg]
    assert names.count("codec.sweep_rerun") == len(reruns) > 0
    # one span a stride-2 transposed conv of each pass: c3p's synthesis
    # has three, its hyper synthesis one
    assert names.count("transforms.conv_transpose") == 4 * chunks * 2


def test_host_path_spans(codec, cloud):
    """``compress_blocks`` takes its log line's three phase spans."""
    blocks, binstr = partition_octree(cloud, [0, 0, 0], [R] * 3, LEVEL)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        codec.compress_blocks(blocks, binstr, cloud, R, LEVEL,
                              fixed_threshold=True)
    spans = {n: p for n, p in _spans(prof)
             if not n.startswith(("transforms.", "octree."))}
    assert spans == {"codec.host_sweep": None, "codec.entropy_encode": None,
                     "codec.select": None}


def test_overflow_records_name_the_reswept_blocks(codec, cloud, caplog,
                                                  monkeypatch):
    """The records that ``sweep_rerun_share.encode`` reads name the work
    the sweep did: the encode record the real blocks, the overflow
    records the blocks re-swept at K = B³ (counted at the sweep's own
    call); the benchmark's reader turns them into the share."""
    real, reswept = codec_module.select_thresholds_d1_bucket, []

    def spy(x_hat, *a, K, **k):
        if K == B ** 3:
            reswept.append(len(x_hat))
        return real(x_hat, *a, K=K, **k)

    monkeypatch.setattr(codec_module, "select_thresholds_d1_bucket", spy)
    with caplog.at_level("INFO", logger=LOGGER):
        blocks, _ = _round_trip(codec, cloud)
    log = [(r.msg, r.args, r.created) for r in _codec_records(caplog)]
    named = sum(args[0] for msg, args, _ in log if "overflow" in msg)
    assert named == sum(reswept) > 0
    encoded = [args[0] for msg, args, _ in log
               if msg.startswith("compress_blocks_device_opt(")]
    assert encoded == [len(blocks)]
    sys.path.insert(0, str(BENCH))
    try:
        from benchlib.codec_log import rerun_share
    finally:
        sys.path.remove(str(BENCH))
    ctx = {"kind": "encode", "log": log,
           "work": {"requests": 1, "blocks": len(blocks), "points": 0}}
    assert rerun_share(ctx) == pytest.approx(100.0 * named / len(blocks))


@pytest.mark.parametrize("stride, grad, ranges", [
    (2, False, 1), (2, True, 0), (1, False, 0)])
def test_conv_transpose_span(stride, grad, ranges):
    """A stride > 1 transposed conv opens its span in a pass that records
    no graph; a training pass and a stride-1 layer open none."""
    layer = ConvTranspose(2, 3, 3, stride)
    x = torch.ones(1, 2, 4, 4, 4)
    with torch.set_grad_enabled(grad), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        layer(x)
    assert [n for n, _ in _spans(prof)] == [
        "transforms.conv_transpose"] * ranges


def test_span_times_without_profiler():
    with trace.span("test.outer") as outer:
        with trace.span("test.inner") as inner:
            time.sleep(0.01)
    assert 0.01 <= inner.seconds <= outer.seconds


@pytest.mark.parametrize("n", [1, 3])
def test_counters_keep_every_count_under_threads(n):
    """More threads than cores add to one counter with a short switch
    interval: a lost update would show in the total."""
    name = f"test.threads.{n}"
    per_thread, n_threads = 2000, 4 * (os.cpu_count() or 1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [trace.count(name, n) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert trace.value(name) == n * per_thread * n_threads
    trace.reset(name)
    assert trace.value(name) == 0


def test_launches_are_registry_counters():
    """``kernels.launches`` reads the registry's ``launches.<kernel>``
    counters, one key a kernel."""
    assert list(kernels.launches) == list(kernels.KERNELS)
    before = dict(kernels.launches)
    kernels.count("halo_edt")
    assert trace.value("launches.halo_edt") == before["halo_edt"] + 1
    assert kernels.launches["halo_edt"] == before["halo_edt"] + 1
    assert kernels.launches != before
    with pytest.raises(KeyError):
        kernels.count("no_such_kernel")
    kernels.reset_launches()
    assert not any(kernels.launches.values())

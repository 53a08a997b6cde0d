"""The port's benchmark driver (``pcc_geo_cnn_v2_tpu_torch.bench``) on the
CPU, at a tiny size.

Two small clouds (``figure_cloud`` at 64³, one 32³ block level) through a
16-filter ProgressiveV2 model from a seeded init (the ``--devices`` mode's
model, its analysis output scaled so that the decoded blocks are not
empty): clouds in flight (``BENCH_PIPELINE`` 2) give the same stream
bytes as one cloud at a time, and every group decodes bit-exactly (the
pipeline raises otherwise). ``main`` is driven with the pipeline replaced
by a recorder: its JSON line has the JAX bench's keys and its switches
reach the codec (``"auto"`` is the plain ``xla`` sweep on the CPU). The
quick-train branch runs two steps at 16³.
"""

import json

import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu_torch import bench
from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.training import init_params
from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
from pcc_geo_cnn_v2_tpu_torch.weights import params_to_jax

R, LEVEL, B = 64, 1, 32
JAX_KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops: one intra-op thread (the tier-1 run has six
    workers on the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    """The ``--devices`` mode's weights, with the analysis output scaled by
    30: at a fresh init every y symbol is 0 on these clouds, x_hat is the
    lifted bias everywhere and every decoded block is empty."""
    model = init_params(build_model(bench.DEVICES_CFG),
                        torch.Generator().manual_seed(0))
    params = params_to_jax(model.state_dict())
    syn = params["params"]["synthesis_t"]
    last = sorted(k for k in syn if k.startswith("ConvTranspose"))[-1]
    syn[last]["bias"] = syn[last]["bias"] + 0.55
    params["params"]["analysis_t"]["Conv_0"]["kernel"] *= 30
    return params


@pytest.fixture(scope="module")
def tiny():
    clouds = []
    for seed in (300, 301):
        pts = figure_cloud(seed, R, with_normals=False)
        clouds.append((pts,) + tuple(partition_octree(pts, [0, 0, 0],
                                                      [R] * 3, LEVEL)))
    codec = BlockCodec(build_model(bench.DEVICES_CFG), _params(),
                       block_size=B, batch_blocks=8, n_thresholds=64,
                       device="cpu", sweep_backend="auto")
    return codec, clouds


def test_clouds_in_flight_give_the_same_streams(tiny):
    codec, clouds = tiny
    logs = []
    runs = [bench.run_pipeline(codec, clouds, R, LEVEL, logs.append,
                               workers=k) for k in (1, 2)]
    assert runs[0]["digest"] == runs[1]["digest"]
    assert runs[0]["decoded_points"] == runs[1]["decoded_points"] > 0
    assert runs[0]["bpp"] == runs[1]["bpp"] > 0
    for k, res in zip((1, 2), runs):
        assert res["pipeline"] == k
        assert res["blocks"] == sum(len(c[1]) for c in clouds) > 2
        assert res["points"] == sum(len(c[0]) for c in clouds)
        assert res["value"] == pytest.approx(
            res["blocks"] / (res["t_enc"] + res["t_dec"]))
        assert res["peak_bytes"] is None  # no device memory on the CPU
        # the plain versions are no launches
        assert not any(res["launches"].values())
    assert any("warmup done" in m for m in logs)
    assert any("[pipeline=2]" in m for m in logs)


def test_clouds_in_flight_keep_the_order_and_raise_a_worker_error(tiny):
    codec, _ = tiny
    with bench.clouds_in_flight(codec, 3) as run:
        assert run(lambda i: i * i, range(7)) == [i * i for i in range(7)]
        with pytest.raises(ZeroDivisionError):
            run(lambda i: 1 // (i - 3), range(5))


def test_a_decode_that_differs_from_the_encoder_raises(tiny, monkeypatch):
    codec, clouds = tiny
    real = codec.decompress_blocks

    def off_by_one(payload):
        blocks = real(payload)
        i = next(i for i, b in enumerate(blocks) if len(b))
        blocks[i] = blocks[i][1:]
        return blocks

    monkeypatch.setattr(codec, "decompress_blocks", off_by_one)
    with pytest.raises(AssertionError, match="group 0"):
        bench.run_pipeline(codec, clouds[:1], R, LEVEL, lambda *a: None,
                           workers=1)


def test_auto_sweep_is_the_plain_sweep_on_the_cpu(tiny):
    assert tiny[0].sweep_backend == "xla"
    with pytest.raises(ValueError, match="auto"):
        BlockCodec(build_model(bench.DEVICES_CFG), _params(), block_size=B,
                   device="cpu", sweep_backend="kernel")


def _fake_pipeline(seen):
    def run_pipeline(codec, clouds, resolution, level, log, **kw):
        seen.update(codec=codec, clouds=clouds, resolution=resolution,
                    level=level, **kw)
        return {"value": 12.5, "blocks": 10, "t_enc": 0.5, "t_dec": 0.3}
    return run_pipeline


def test_main_prints_the_jax_line_and_passes_the_switches(tiny, monkeypatch,
                                                          capsys):
    seen = {}
    monkeypatch.setattr(bench, "run_pipeline", _fake_pipeline(seen))
    monkeypatch.setattr(bench, "held_out_clouds",
                        lambda n, with_normals: tiny[1][:n])
    for key, value in (("BENCH_NUM_CLOUDS", "1"), ("BENCH_PIPELINE", "2"),
                       ("BENCH_BATCH_BLOCKS", "4"),
                       ("BENCH_OPT_METRICS", "d1_mse,d1_sum_AB"),
                       ("BENCH_NEED_METRICS", "0"),
                       ("BENCH_HALO_WIDTH", "7"), ("BENCH_DTYPE", "float32")):
        monkeypatch.setenv(key, value)
    assert bench.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == JAX_KEYS
    assert line == {"metric": "blocks64_enc_dec_per_sec_cpu", "value": 12.5,
                    "unit": "blocks/s",
                    "vs_baseline": 12.5 / bench.BASELINE_BLOCKS_PER_SEC}
    codec = seen["codec"]
    assert (codec.sweep_backend, codec.batch_blocks, codec.halo_width,
            codec.halo_batch) == ("xla", 4, 7, 64)
    assert (codec.model.num_filters, codec.model.dtype,
            codec.model.conv_backend) == (64, None, "xla")
    assert (seen["workers"], seen["opt_metrics"], seen["need_metrics"]) == \
        (2, ("d1_mse", "d1_sum_AB"), False)
    assert (seen["resolution"], seen["level"], len(seen["clouds"])) == \
        (1024, 4, 1)


def test_main_defaults_are_the_jax_benchs(tiny, monkeypatch, capsys):
    seen = {}
    monkeypatch.setattr(bench, "run_pipeline", _fake_pipeline(seen))
    asked = []
    monkeypatch.setattr(bench, "held_out_clouds", lambda n, with_normals: (
        asked.append((n, with_normals)) or tiny[1][:1]))
    for key in ("BENCH_NUM_CLOUDS", "BENCH_PIPELINE", "BENCH_BATCH_BLOCKS",
                "BENCH_OPT_METRICS", "BENCH_NEED_METRICS", "BENCH_DTYPE",
                "BENCH_CONV_BACKEND", "BENCH_SWEEP_BACKEND",
                "BENCH_HALO_BATCH", "BENCH_HALO_WIDTH"):
        monkeypatch.delenv(key, raising=False)
    bench.main(["--device", "cpu"])
    codec = seen["codec"]
    assert asked == [(8, False)]
    assert (seen["workers"], seen["opt_metrics"], seen["need_metrics"]) == \
        (3, ("d1_mse",), True)
    assert (codec.batch_blocks, codec.model.dtype, codec.model.conv_backend,
            codec.block_size, len(codec.thresholds)) == \
        (128, torch.bfloat16, "xla", 64, 256)


def test_main_without_the_checkpoint_quick_trains(monkeypatch, capsys,
                                                  tmp_path):
    calls = []

    def quick_train(steps, device, log):
        calls.append((steps, str(device)))
        return _params_c3p()

    monkeypatch.setattr(bench, "ASSET", tmp_path / "missing.msgpack.gz")
    monkeypatch.setattr(bench, "quick_train", quick_train)
    monkeypatch.setattr(bench, "run_pipeline", _fake_pipeline({}))
    monkeypatch.setattr(bench, "held_out_clouds", lambda n, w: [])
    monkeypatch.setenv("BENCH_TRAIN_STEPS", "3")
    bench.main(["--device", "cpu"])
    assert calls == [(3, "cpu")]


def _params_c3p():
    return params_to_jax(build_model("c3p").state_dict())


def test_quick_train_gives_weights_the_codec_takes():
    params = bench.quick_train(2, torch.device("cpu"), lambda *a: None,
                               block_size=16)
    assert np.isfinite(params["params"]["synthesis_t"]["ConvTranspose_0"]
                       ["kernel"]).all()
    codec = BlockCodec(build_model("c3p"), params, block_size=16,
                       device="cpu")
    assert codec.model.num_filters == 64


def test_devices_mode_refuses_more_cards_than_present():
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match="truncated"):
        bench._mesh_devices(have + 1, torch.device("cuda"))
    assert bench._mesh_devices(3, torch.device("cpu")) == ["cpu"] * 3

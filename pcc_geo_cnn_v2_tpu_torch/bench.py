"""Benchmark: 64³ blocks/s for full encode + decode of the flagship c3p.

    python -m pcc_geo_cnn_v2_tpu_torch.bench [--devices N] [--device cuda|cpu]

Port of the JAX package's ``bench.py`` (``main`` and ``run_pipeline``):
octree partition → voxelize → analysis / hyper transforms, quantization,
CDF indexes → the decoder-canonical decode and the device threshold sweep
→ host rANS → bitstream container → entropy decode → hyper / synthesis
transforms → threshold → points, over 8 held-out 10-bit clouds
(``figure_cloud(seed, 1024)`` for seeds 300…, octree level 4). The last
line of standard output is one JSON object with the JAX keys::

    {"metric": "blocks64_enc_dec_per_sec_per_chip", "value": N,
     "unit": "blocks/s", "vs_baseline": R}

(``…_per_sec_cpu`` when run with ``--device cpu``: a CPU number is not a
chip's.) Standard error carries the log and one ``bench summary: {...}``
line: encode and decode seconds, bpp, peak device memory, kernel launches
and the SHA-256 of every stream, in cloud order.

Switches (environment), with the JAX bench's defaults and meanings:

- ``BENCH_NUM_CLOUDS`` (8), ``BENCH_DTYPE`` (``bfloat16`` | ``float32``),
  ``BENCH_CONV_BACKEND`` (``xla``: module convs in cuDNN; ``pallas``: the
  residual tails on K4a / K4b), ``BENCH_BATCH_BLOCKS`` (128),
  ``BENCH_SWEEP_BACKEND`` (``auto``: the bucket sweep on a card, the
  exact plain sweep on the CPU), ``BENCH_OPT_METRICS`` (``d1_mse``;
  ``d1_mse,d2_mse`` builds clouds with normals and encodes both groups),
  ``BENCH_NEED_METRICS`` (1: the encoder's full-cloud metrics of a lone
  candidate too), ``BENCH_HALO_BATCH`` / ``BENCH_HALO_WIDTH`` (the codec's
  halo-metric knobs), ``BENCH_TRAIN_STEPS`` (1200: quick-train steps when
  the committed ``bench_c3p.msgpack.gz`` is missing).
- ``BENCH_PIPELINE`` (3): clouds in flight. The encodes, then the decodes,
  run on a pool of that many threads; on a card each thread runs under
  its own CUDA stream (one a device of the codec), so that a fetch to the
  host waits for its own cloud's work only, and one cloud's host phases
  (range coding, the container, the metrics' host part) overlap another
  cloud's kernels. The streams do not depend on it.

There is no compile cache to warm (the JAX bench's ``warmup``): one
untimed encode + decode of the first cloud on every worker keeps kernel
builds, cuDNN handles, allocator growth and the kernels' cached tables
out of the timed window. Throughput is blocks over the encode plus decode
wall seconds of all clouds.

``--devices N``: the JAX bench's multi-device mode — a 16-filter
ProgressiveV2 v2 model (seeded init, final synthesis bias + 0.55) on 32³
blocks of a 512-cube sphere, 64 thresholds, batch 16, the ``xla`` sweep,
with the chunks round-robin over ``BlockCodec(devices=...)``: ``cpu`` N
times with ``--device cpu`` (placement, gathering and bit-exactness, not
scaling), ``cuda:0 … cuda:N-1`` on cards (N above the cards present is
refused).
"""

from __future__ import annotations

import time

# the log reports set-up as seconds since process start, imports included
_PROC_T0 = time.time()

import argparse
import contextlib
import functools
import gzip
import hashlib
import io
import json
import logging
import multiprocessing
import os
import sys
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec, resolve_device
from pcc_geo_cnn_v2_tpu_torch.coding.syntax import (
    load_compressed_file,
    save_compressed_file,
)
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.ops import kernels
from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud

__all__ = ["BASELINE_BLOCKS_PER_SEC", "main", "run_pipeline",
           "clouds_in_flight", "held_out_clouds", "devices_setup",
           "quick_train"]

# An estimate of the TF1 reference's per-block throughput on its published
# hardware (one TF1 graph evaluation a 64³ block, CPU range coding
# included; no wall-clock number is published, BASELINE.md), held constant
# as the JAX bench holds it. It is no measurement of any chip.
BASELINE_BLOCKS_PER_SEC = 5.0
ASSET = (Path(__file__).resolve().parent.parent
         / "pcc_geo_cnn_v2_tpu/assets/bench_c3p.msgpack.gz")
RESOLUTION, LEVEL, BLOCK = 1024, 4, 64
FIRST_SEED = 300
NUM_CLOUDS = 8  # BENCH_NUM_CLOUDS' default
DTYPES = {"bfloat16": torch.bfloat16, "float32": None}
DEVICES_CFG = dict(model="v2", num_filters=16,
                   analysis="AnalysisTransformProgressiveV2",
                   synthesis="SynthesisTransformProgressiveV2")


def build_cloud(seed, with_normals):
    """One held-out cloud: (points [N, 3] or [N, 6] with normals, blocks,
    binstr)."""
    if with_normals:
        pts = np.hstack(figure_cloud(seed, RESOLUTION, with_normals=True))
    else:
        pts = figure_cloud(seed, RESOLUTION, with_normals=False)
    blocks, binstr = partition_octree(pts, [0, 0, 0], [RESOLUTION] * 3,
                                      LEVEL)
    return pts, blocks, binstr


def held_out_clouds(n, with_normals):
    """``n`` held-out clouds (seeds 300…), built in parallel processes
    (set-up, outside the timed window)."""
    seeds = range(FIRST_SEED, FIRST_SEED + n)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(n, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        return list(pool.map(build_cloud, seeds, [with_normals] * n))


def devices_setup(devices, log):
    """The ``--devices`` mode: a 16-filter model from a seeded init with
    the final synthesis bias lifted by 0.55 (so that candidate sets are not
    empty), a 512-cube sphere in 32³ blocks, and the round-robin codec.

    :return: (codec, [(points, blocks, binstr)], resolution, level).
    """
    from pcc_geo_cnn_v2_tpu_torch.training import init_params
    from pcc_geo_cnn_v2_tpu_torch.weights import params_to_jax

    rng = np.random.default_rng(123)
    v = rng.normal(size=(60_000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = np.unique(np.clip(np.round(v * 180 + 256), 0, 511), axis=0)
    resolution, level, block_size = 512, 4, 32
    blocks, binstr = partition_octree(pts, [0, 0, 0], [resolution] * 3,
                                      level)
    log(f"{len(pts)} points -> {len(blocks)} blocks of {block_size}^3")
    model = init_params(build_model(DEVICES_CFG),
                        torch.Generator().manual_seed(0))
    params = params_to_jax(model.state_dict())
    syn = params["params"]["synthesis_t"]
    last = sorted(k for k in syn if k.startswith("ConvTranspose"))[-1]
    syn[last]["bias"] = syn[last]["bias"] + 0.55
    codec = BlockCodec(build_model(DEVICES_CFG), params,
                       block_size=block_size, n_thresholds=64,
                       batch_blocks=16, sweep_backend="xla", devices=devices)
    return codec, [(pts, blocks, binstr)], resolution, level


def quick_train(steps, device, log, block_size=BLOCK):
    """Weights for the bench when the committed checkpoint is missing:
    ``steps`` steps of c3p on synthetic blocks (the JAX bench's recipe:
    batch 8, λ 5e-5), on the port's training step. Returns flax-layout
    params."""
    from pcc_geo_cnn_v2_tpu_torch.training import (
        TrainConfig,
        draw_noise,
        init_params,
        make_loss_fn,
        make_optimizer,
    )
    from pcc_geo_cnn_v2_tpu_torch.utils.data import (
        BlockDataset,
        synthetic_blocks,
    )
    from pcc_geo_cnn_v2_tpu_torch.weights import params_to_jax

    cfg = TrainConfig(block_size=block_size, batch_size=8, lmbda=5e-5)
    model = init_params(build_model("c3p"), torch.Generator().manual_seed(0))
    model.to(device).train()
    opt = make_optimizer(model, cfg.lr, cfg.aux_lr)
    loss_fn = make_loss_fn(model, cfg)
    ds = BlockDataset(synthetic_blocks(64, block_size=block_size, seed=1),
                      max_points=4096)
    batches = ds.batches(cfg.batch_size, seed=0)
    gen = torch.Generator(device=device).manual_seed(1)
    t0 = time.time()
    logs = {}
    for _ in range(steps):
        pts = torch.as_tensor(next(batches), device=device)
        opt.zero_grad(set_to_none=True)
        total, logs = loss_fn(pts, draw_noise(model, len(pts), block_size,
                                              gen))
        total.backward()
        opt.step()
    if logs:
        log(f"quick-train {steps} steps in {time.time() - t0:.0f}s (loss "
            f"{float(logs['loss']):.3f}, mbpov {float(logs['mbpov']):.3f})")
    return params_to_jax(model.state_dict())


def _cards(codec):
    return sorted({d for d in codec.devices if d.type == "cuda"}, key=str)


@contextlib.contextmanager
def clouds_in_flight(codec, workers):
    """Yields ``run(fn, items)``: ``[fn(item) for item in items]`` with
    ``workers`` items in flight on a thread pool (in the calling thread when
    ``workers`` is 1). On cards each thread makes, once, its own CUDA
    stream on every device of ``codec`` and runs ``fn`` under them: a
    fetch to the host then waits only for that thread's work, where on
    the shared default stream it would wait for every cloud's queued
    kernels and the clouds would not overlap."""
    cards = _cards(codec)
    local = threading.local()

    def call(fn, item):
        if not cards:
            return fn(item)
        if not hasattr(local, "streams"):
            local.streams = [torch.cuda.Stream(d) for d in cards]
        with contextlib.ExitStack() as stack:
            for s in local.streams:
                stack.enter_context(torch.cuda.stream(s))
            return fn(item)

    if workers <= 1:
        yield lambda fn, items: [call(fn, item) for item in items]
        return
    with ThreadPoolExecutor(workers) as pool:
        yield lambda fn, items: list(pool.map(functools.partial(call, fn),
                                              items))


def run_pipeline(codec, clouds, resolution, level, log, *, workers=3,
                 opt_metrics=("d1_mse",), need_metrics=True, window=None):
    """Encode every cloud, then decode every stream, ``workers`` clouds in
    flight (:func:`clouds_in_flight`), after one untimed round trip of the
    first cloud on every worker. Every decoded group must equal the
    encoder's embedded reconstruction, or this raises.

    :param clouds: [(points, blocks, binstr)].
    :param window: a context manager entered around the timed encode and
        decode (``tools/torch_profile_main_path.py`` passes its profiler).
    :return: dict(blocks, points, decoded_points (of the d1 group), t_enc,
        t_dec, value (blocks / s over both), bpp (the d1 group's streams),
        digest (SHA-256 of every
        group's stream, in cloud order), peak_bytes (device, None on the
        CPU), launches (kernel launches of the timed window), pipeline).
    """
    with_normals = any(m.startswith("d2") for m in opt_metrics)

    def encode_one(cloud):
        pts, blocks, binstr = cloud
        data_list, metadata = codec.compress_blocks_device_opt(
            blocks, binstr, pts, resolution, level, opt_metrics=opt_metrics,
            with_normals=with_normals, need_metrics=need_metrics)
        # one stream per metric group (d1 first, the headline); mtime 0:
        # equal payloads give equal bytes
        raw = [gzip.compress(save_compressed_file(binstr, dl, resolution,
                                                  level), mtime=0)
               for dl in data_list]
        return raw, metadata

    def decode_one(args):
        raw, metadata = args
        for g, r in enumerate(raw):
            payload = load_compressed_file(io.BytesIO(gzip.decompress(r)))[3]
            dec = codec.decompress_blocks(payload)
            enc = metadata[g]["x_hat_list"]
            if len(dec) != len(enc) or not all(
                    np.array_equal(d, e) for d, e in zip(dec, enc)):
                raise AssertionError("decoder output != encoder-embedded "
                                     f"reconstruction (group {g})")

    cards = _cards(codec)

    def settle():
        for d in cards:
            torch.cuda.synchronize(d)

    with clouds_in_flight(codec, workers) as run:
        run(lambda c: decode_one(encode_one(c)), [clouds[0]] * workers)
        settle()
        log(f"warmup done ({time.time() - _PROC_T0:.0f}s since process "
            "start)")
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        kernels.reset_launches()
        with window or contextlib.nullcontext():
            t0 = time.time()
            results = run(encode_one, clouds)
            settle()
            t_enc = time.time() - t0
            t0 = time.time()
            run(decode_one, results)
            settle()
            t_dec = time.time() - t0
    launches = dict(kernels.launches)
    n_blocks = sum(len(blocks) for _, blocks, _ in clouds)
    n_pts = sum(len(pts) for pts, _, _ in clouds)
    raws = [raw for raw, _ in results]
    bpp = sum(len(raw[0]) for raw in raws) * 8 / n_pts
    digest = hashlib.sha256(b"".join(r for raw in raws for r in raw))
    log(f"encode {t_enc:.2f}s ({n_blocks / t_enc:.2f} blocks/s), "
        f"{bpp:.3f} bpp [pipeline={workers}]")
    log(f"decode {t_dec:.2f}s ({n_blocks / t_dec:.2f} blocks/s)")
    if with_normals:
        groups = [g for g in ("d1", "d2")
                  if any(m.startswith(g) for m in opt_metrics)]
        for g, grp in enumerate(groups):
            ms = [m[g]["metrics"] for _, meta in results for m in [meta]
                  if m[g].get("metrics")]
            for key in ("d1_psnr", "d2_psnr"):
                vals = [m[key] for m in ms if key in m]
                if vals:
                    log(f"enc-side {key} ({grp}-optimized): mean "
                        f"{np.mean(vals):.2f} dB over {len(vals)} clouds")
    return {"blocks": n_blocks, "points": n_pts,
            "decoded_points": sum(len(meta[0]["blocks_full"])
                                  for _, meta in results), "t_enc": t_enc,
            "t_dec": t_dec, "value": n_blocks / (t_enc + t_dec), "bpp": bpp,
            "digest": digest.hexdigest(),
            "peak_bytes": (max(torch.cuda.max_memory_allocated(d)
                               for d in cards) if cards else None),
            "launches": launches, "pipeline": workers}


def _mesh_devices(n, device):
    """``--devices N`` on ``device``'s kind: the CPU N times, or the first
    N cards (more than present is refused, as the JAX ``make_mesh``
    refuses a truncated mesh)."""
    if device.type == "cpu":
        return ["cpu"] * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"--devices {n} but only {have} card(s): a "
                         "truncated device list would make the round-robin "
                         "check vacuous")
    return [f"cuda:{i}" for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=0,
                    help="Round-robin mode over N devices (see the module "
                         "docstring).")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="The GPU (default) or, explicitly, the CPU with "
                         "the kernels' plain versions.")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else "cpu")
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    if device.type == "cuda":
        from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs

        deterministic_convs()
        log(f"device: {torch.cuda.get_device_name(device)}")
    else:
        log("device: cpu (the kernels' plain versions)")
    env = os.environ
    workers = int(env.get("BENCH_PIPELINE", "3"))
    opt_metrics = tuple(env.get("BENCH_OPT_METRICS", "d1_mse").split(","))
    need_metrics = env.get("BENCH_NEED_METRICS", "1") != "0"
    run = dict(workers=workers, opt_metrics=opt_metrics,
               need_metrics=need_metrics)

    if args.devices:
        codec, clouds, resolution, level = devices_setup(
            _mesh_devices(args.devices, device), log)
        res = run_pipeline(codec, clouds, resolution, level, log, **run)
        log(f"bench summary: {json.dumps(res)}")
        kind = "cpu_mesh" if device.type == "cpu" else "round_robin"
        print(json.dumps({
            "metric": f"blocks{codec.block_size}_enc_dec_per_sec_{kind}",
            "value": round(res["value"], 3), "unit": "blocks/s",
            "devices": args.devices, "vs_baseline": 0.0}))
        return 0

    dtype_name = env.get("BENCH_DTYPE", "bfloat16")
    if dtype_name not in DTYPES:
        raise ValueError(f"BENCH_DTYPE {dtype_name!r} is not one of "
                         f"{list(DTYPES)}")
    with_normals = any(m.startswith("d2") for m in opt_metrics)
    clouds = held_out_clouds(int(env.get("BENCH_NUM_CLOUDS", NUM_CLOUDS)),
                             with_normals)
    log(f"{len(clouds)} clouds, {sum(len(c[0]) for c in clouds)} points -> "
        f"{sum(len(c[1]) for c in clouds)} blocks of {BLOCK}^3")
    model = build_model("c3p", dtype=DTYPES[dtype_name],
                        conv_backend=env.get("BENCH_CONV_BACKEND", "xla"))
    if ASSET.exists():
        from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

        params = load_asset_tree(ASSET)
        log(f"loaded benchmark checkpoint {ASSET.name}")
    else:
        params = quick_train(int(env.get("BENCH_TRAIN_STEPS", "1200")), device,
                             log)
    codec = BlockCodec(
        model, params, block_size=BLOCK, device=device,
        batch_blocks=int(env.get("BENCH_BATCH_BLOCKS", "128")),
        sweep_backend=env.get("BENCH_SWEEP_BACKEND", "auto"))
    codec.halo_batch = int(env.get("BENCH_HALO_BATCH", codec.halo_batch))
    codec.halo_width = int(env.get("BENCH_HALO_WIDTH", codec.halo_width))
    log(f"c3p {dtype_name}, conv backend {model.conv_backend}, sweep "
        f"{codec.sweep_backend}, batch {codec.batch_blocks}, opt metrics "
        f"{','.join(opt_metrics)}")
    res = run_pipeline(codec, clouds, RESOLUTION, LEVEL, log, **run)
    log(f"bench summary: {json.dumps(res)}")
    kind = "per_chip" if device.type == "cuda" else "cpu"
    print(json.dumps({
        "metric": f"blocks{BLOCK}_enc_dec_per_sec_{kind}",
        "value": round(res["value"], 3), "unit": "blocks/s",
        "vs_baseline": round(res["value"] / BASELINE_BLOCKS_PER_SEC, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What the codec's cells share: the cloud pool of a mix, the program's
codec for a configuration and its encode and decode requests, the window's
sample of answers, and the plain reference of the sampled clouds.

The pool: the mix's figure seeds made by :mod:`cloudgen` (cached as int16
arrays in the checkout's ``.bench_cache``, written once), each mapped by a
cube symmetry drawn from the run's seed, in an order drawn from it. Every
seed therefore gets the same clouds' sizes and the same blocks' point
counts, in other forms and another order.
"""

from __future__ import annotations

import gc
import os

import numpy as np

from benchlib import cloudgen, weights
from benchlib.core import ROOT

__all__ = ["make_pool", "weight_tree", "build_codec", "thresholds",
           "free_device", "reference_model", "sample", "block_count",
           "encoder", "decoder", "debug_decoder", "references", "release"]


def _cache_path(cache_dir, mix, seed):
    c = mix["clouds"]
    return (cache_dir / "clouds" /
            f"figure_{c['resolution']}_{c['density']}_{seed}.npy")


def make_pool(run):
    """The run's clouds: [N_i, 3] float64 integer points, one per figure
    seed, symmetries and order from the run's seed."""
    c = run.mix["clouds"]
    seeds = list(c["figure_seeds"])
    paths = [_cache_path(run.cache_dir, run.mix, s) for s in seeds]
    missing = [s for s, p in zip(seeds, paths) if not p.exists()]
    if missing:
        made = cloudgen.pool_clouds(missing, c["resolution"], c["density"],
                                    min(len(missing), os.cpu_count() or 1))
        for s, pts in zip(missing, made):
            p = _cache_path(run.cache_dir, run.mix, s)
            p.parent.mkdir(parents=True, exist_ok=True)
            tmp = p.with_suffix(".tmp.npy")
            np.save(tmp, pts.astype(np.int16))
            os.replace(tmp, p)
    clouds = [np.load(p).astype(np.float64) for p in paths]
    order = run.rng.permutation(len(clouds))
    return [cloudgen.apply_symmetry(clouds[k], c["resolution"],
                                    cloudgen.symmetry(run.rng))
            for k in order]


def weight_tree(config):
    return weights.load_tree(ROOT / config["weights"])


def build_codec(run, tree):
    """The program's codec for the run's configuration (its convolution
    settings made the process's: f32, TF32 off, deterministic)."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec, deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model

    cfg = run.config
    if cfg["dtype"] != "float32":
        raise ValueError(f"dtype {cfg['dtype']!r}: the codec cells run "
                         "float32")
    if torch.device(run.device).type == "cuda":
        deterministic_convs()
    model = build_model(cfg["model"], dtype=None,
                        conv_backend=cfg["conv_backend"])
    return BlockCodec(model, tree, block_size=cfg["block_size"],
                      n_thresholds=cfg["n_thresholds"],
                      batch_blocks=cfg["batch_blocks"], device=run.device,
                      sweep_backend=cfg["sweep_backend"])


def thresholds(config):
    """The threshold grid the stream's indices point into."""
    return np.linspace(0.0, 1.0, config["n_thresholds"])


def free_device(device):
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference_model(run, tree, tf32=False):
    """The plain reference of the run's configuration."""
    from reference.model import ReferenceModel, f32_convs

    if run.device != "cpu":
        f32_convs(tf32)
    return ReferenceModel(tree, run.config["analysis"],
                          run.config["synthesis"], run.device)


def sample(run, records, k):
    """``k`` of the window's completed requests, drawn from the seed."""
    done = [r for r in records if "out" in r]
    rng = np.random.default_rng([run.seed, 1])
    pick = rng.choice(len(done), size=min(k, len(done)), replace=False)
    return [done[i] for i in sorted(pick)]


def block_count(points, resolution, level):
    """Occupied octree blocks of a cloud."""
    ids = np.asarray(points, np.int64) // (resolution >> level)
    n = 1 << level
    return int(np.unique((ids[:, 0] * n + ids[:, 1]) * n + ids[:, 2]).size)


def encoder(run, codec):
    """One encode as ``cli/compress`` runs it without file I/O: octree
    partition → ``compress_blocks_device_opt`` (with the full-cloud D1
    metrics, as ``cli/compress`` asks for them) → container → gzip.
    Returns the gzipped stream of the d1 group and the full-cloud D1 PSNR
    the encoder reports for it."""
    import gzip

    from pcc_geo_cnn_v2_tpu_torch.coding.syntax import save_compressed_file
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree

    c = run.mix["clouds"]
    res, level = c["resolution"], c["level"]
    opt = tuple(run.mix["opt_metrics"])

    def encode(pts):
        with run.span("partition"):
            blocks, binstr = partition_octree(pts, [0, 0, 0], [res] * 3,
                                              level)
        with run.span("compress"):
            data_list, meta = codec.compress_blocks_device_opt(
                blocks, binstr, pts, res, level, opt_metrics=opt,
                need_metrics=True)
        with run.span("container"):
            raw = save_compressed_file(binstr, data_list[0], res, level)
        with run.span("gzip"):
            return (gzip.compress(raw, mtime=0),
                    meta[0]["metrics"]["d1_psnr"])

    return encode


def decoder(run, codec):
    """One decode as ``cli/decompress`` runs it without file I/O: gunzip →
    container → ``decompress_blocks`` → departition: the points [N, 3]."""
    import gzip
    import io

    from pcc_geo_cnn_v2_tpu_torch.coding.syntax import load_compressed_file
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import departition_octree

    def decode(raw):
        with run.span("gunzip"):
            data = gzip.decompress(raw)
        with run.span("container"):
            res, level, binstr, payload = load_compressed_file(
                io.BytesIO(data))
        with run.span("decompress"):
            blocks = codec.decompress_blocks(payload)
        with run.span("departition"):
            return np.vstack(departition_octree(blocks, binstr, [0, 0, 0],
                                                [res] * 3, level))

    return decode


def debug_decoder(run, codec):
    """A decode as :func:`decoder`'s, with the decoder's debug half
    (``decompress_blocks(return_debug=True)``: its z symbols and y scale
    rows): (points [N, 3], debug dict)."""
    import gzip
    import io

    from pcc_geo_cnn_v2_tpu_torch.coding.syntax import load_compressed_file
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import departition_octree

    def decode(raw):
        res, level, binstr, payload = load_compressed_file(
            io.BytesIO(gzip.decompress(raw)))
        blocks, debug = codec.decompress_blocks(payload, return_debug=True)
        return (np.vstack(departition_octree(blocks, binstr, [0, 0, 0],
                                             [res] * 3, level)), debug)

    return decode


def references(run, tree, clouds, items, tf32=False):
    """{item: CloudReference} of the clouds ``items``."""
    from reference.judge import CloudReference

    model = reference_model(run, tree, tf32)
    c = run.mix["clouds"]
    return {i: CloudReference(model, clouds[i], c["resolution"],
                              c["level"], thresholds(run.config))
            for i in sorted(set(items))}


def release(run, state):
    """Drop the program's objects (codec, client threads) and return their
    device memory, before the reference runs."""
    pool = state.pop("pool", None)
    if pool is not None:
        pool.shutdown(wait=True)
    for key in ("codec", "encode", "decode"):
        state.pop(key, None)
    free_device(run.device)

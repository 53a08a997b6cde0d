"""Driver ``encode``: clients in a closed loop, each encoding its next
cloud of the pool when its last encode is done (points → gzipped stream on
the host). End-to-end: ``encode_rate``, the input points of every encode
of the window over its wall seconds.

Judged after the window: a sample of the window's streams, drawn from the
seed, decoded by the program's decoder and held against the plain
reference of their cloud: each block's threshold index against the
reference's D1-optimal pick (``pick_mismatch``); the decoded points
against the reference's reconstruction at the stream's thresholds
(``pts_mismatch``); each y element's row of the scale table, as the
decoder read it from the stream, against the reference's (``idx_mismatch``:
the z symbols and the hyper synthesis, which encoder and decoder share);
and the full-cloud D1 PSNR that the encoder
reports (K2's sums) against the reference's float64 PSNR of the decoded
points (``psnr_gap_db``).
"""

from __future__ import annotations

import time

import numpy as np

from benchlib import codec_cells as cc
from benchlib.core import client_pool, closed_loop
from reference.judge import (cloud_keys, d1_psnr, keys_points, mismatch,
                             parse_container)

KIND = "encode"


def prepare(run, carry=None):
    tree = cc.weight_tree(run.config)
    clouds = cc.make_pool(run)
    codec = carry["codec"] if carry else cc.build_codec(run, tree)
    clients = run.mix["clients"]
    pool = client_pool(clients)
    encode = cc.encoder(run, codec)
    # every shape the window meets, on every client thread: one pass over
    # the pool, as many at once as in the window
    closed_loop(pool, clients, clouds, encode, None, run.device)
    c = run.mix["clouds"]
    return {"tree": tree, "clouds": clouds, "codec": codec, "pool": pool,
            "encode": encode,
            "blocks": [cc.block_count(p, c["resolution"], c["level"])
                       for p in clouds]}


release = cc.release


def measure(run, state):
    t0 = time.perf_counter()
    records = closed_loop(state["pool"], run.mix["clients"], state["clouds"],
                          state["encode"], t0 + run.seconds, run.device)
    window = time.perf_counter() - t0
    done = [r for r in records if "out" in r]
    points = sum(len(state["clouds"][r["item"]]) for r in done)
    return {"records": records, "window_s": window,
            "metrics": {"encode_rate": (points / 1e6 / window, "Mpts/s")},
            "work": {"requests": len(done), "points": points,
                     "blocks": sum(state["blocks"][r["item"]]
                                   for r in done)}}


def collect(run, state, result):
    """Decode the sampled streams with the program (outside the window)."""
    decode = cc.debug_decoder(run, state["codec"])
    res = run.mix["clouds"]["resolution"]
    answers = []
    for r in cc.sample(run, result["records"], run.mix["check"]["samples"]):
        stream, psnr = r["out"]
        thr = parse_container(stream)[2]
        points, debug = decode(stream)
        answers.append({"item": r["item"], "thr": thr,
                        "keys": cloud_keys(points, res), "psnr": psnr,
                        "y_idx": debug["y_idx"]})
    result["answers"] = answers


def _share(a, b):
    """Share of the elements of ``a`` that differ from ``b`` (1 where the
    shapes differ)."""
    a, b = np.asarray(a), np.asarray(b)
    return 1.0 if a.shape != b.shape else float(np.mean(a != b))


def numbers(refs, answers):
    """The compared numbers, each the worst over the answers. The
    control's answers carry no PSNR of their own, and so no
    ``psnr_gap_db``."""
    out = {}

    def worst(k, v):
        out[k] = max(out.get(k, 0.0), float(v))

    for a in answers:
        ref = refs[a["item"]]
        picks = ref.picks()
        if len(a["thr"]) != len(picks):
            return dict.fromkeys(
                ("pick_mismatch", "pts_mismatch", "idx_mismatch")
                + ("psnr_gap_db",) * ("psnr" in a), 1.0)
        worst("pick_mismatch", np.mean(a["thr"] != picks))
        bad, n = mismatch(a["keys"], ref.recon_keys(a["thr"]))
        worst("pts_mismatch", bad / max(n, 1))
        worst("idx_mismatch", _share(a["y_idx"], ref.rows))
        if "psnr" in a:
            want = d1_psnr(ref.points, keys_points(a["keys"],
                                                   ref.resolution),
                           ref.resolution)
            # an infinite or missing PSNR on one side reads 99 dB
            gap = 0.0 if a["psnr"] == want else abs(a["psnr"] - want)
            worst("psnr_gap_db", gap if gap < 99.0 else 99.0)
    return out


def judge(run, state, result):
    refs = cc.references(run, state["tree"], state["clouds"],
                         [a["item"] for a in result["answers"]])
    return numbers(refs, result["answers"])


def control(run, state, result):
    """The reference with TF32 convolutions in the program's place: its
    own picks, its reconstruction at them and its scale rows, judged as
    the program's answers are."""
    items = [a["item"] for a in result["answers"]]
    low = cc.references(run, state["tree"], state["clouds"], items,
                        tf32=True)
    answers = []
    for i in items:
        thr = low[i].picks()
        answers.append({"item": i, "thr": thr,
                        "keys": low[i].recon_keys(thr),
                        "y_idx": low[i].rows})
    del low
    refs = cc.references(run, state["tree"], state["clouds"], items)
    return numbers(refs, answers)


def _k2_half():
    """K2's full-cloud D1 sums taken over the first half of the blocks
    alone, the mean over the rest."""
    from pcc_geo_cnn_v2_tpu_torch import codec

    real = codec.blockwise_d1_sums

    def half(a, b, origins, size, **kw):
        return real(a, b, origins[:max(1, len(origins) // 2)], size, **kw)

    codec.blockwise_d1_sums = half
    return lambda: setattr(codec, "blockwise_d1_sums", real)


def _hyper(alter):
    """The hyper synthesis's scales altered where they are made (the
    model's ``decode_z``, which encoder and decoder share)."""
    from pcc_geo_cnn_v2_tpu_torch.models.codec_models import \
        CompressionModelV2 as Model

    real = Model.decode_z

    def decode_z(self, z_sym):
        return alter(self, real, z_sym)

    Model.decode_z = decode_z
    return lambda: setattr(Model, "decode_z", real)


def _scaled(self, real, z_sym, factor=1.25):
    sigma = self.conditional.bound_scale(real(self, z_sym)[0] * factor)
    return sigma, self.conditional.indexes(sigma)


def _bf16(self, real, z_sym):
    import torch

    with torch.autocast(z_sym.device.type, dtype=torch.bfloat16):
        return real(self, z_sym)


FAULTS = {"k2_half": _k2_half,
          "hyper_scale": lambda: _hyper(_scaled),
          "hyper_bf16": lambda: _hyper(_bf16)}

"""Driver ``decode``: the pool encoded by the program in set-up, then
clients in a closed loop, each decoding its next stream when its last
decode is done (gzipped stream → points on the host). End-to-end:
``decode_rate``, the input cloud's points of every decode of the window
over its wall seconds, and ``decode_p<q>_s`` for each ``q`` of the mix's
``latency_percentiles``: that percentile of one decode's latency over
every decode of the window.

Judged after the window: a sample of the window's decodes, drawn from the
seed, against the plain reference's reconstruction of their cloud at the
stream's thresholds (the reference codes the cloud itself; it reads only
the thresholds from the stream).
"""

from __future__ import annotations

import time

import numpy as np

from benchlib import codec_cells as cc
from benchlib.core import client_pool, closed_loop
from reference.judge import cloud_keys, mismatch, parse_container

KIND = "decode"


def prepare(run, carry=None):
    tree = cc.weight_tree(run.config)
    clouds = cc.make_pool(run)
    codec = carry["codec"] if carry else cc.build_codec(run, tree)
    clients = run.mix["clients"]
    pool = client_pool(clients)
    recs = closed_loop(pool, clients, clouds, cc.encoder(run, codec), None,
                       run.device)
    streams = [r["out"][0] for r in recs]
    decode = cc.decoder(run, codec)
    # every shape the window meets, on every client thread: one pass over
    # the pool, as many at once as in the window
    closed_loop(pool, clients, streams, decode, None, run.device)
    c = run.mix["clouds"]
    return {"tree": tree, "clouds": clouds, "codec": codec, "pool": pool,
            "decode": decode, "streams": streams,
            "blocks": [cc.block_count(p, c["resolution"], c["level"])
                       for p in clouds]}


release = cc.release


def measure(run, state):
    t0 = time.perf_counter()
    records = closed_loop(state["pool"], run.mix["clients"],
                          state["streams"], state["decode"],
                          t0 + run.seconds, run.device)
    window = time.perf_counter() - t0
    done = [r for r in records if "out" in r]
    points = sum(len(state["clouds"][r["item"]]) for r in done)
    lat = [r["t1"] - r["t0"] for r in done]
    metrics = {"decode_rate": (points / 1e6 / window, "Mpts/s")}
    for q in run.mix.get("latency_percentiles", []):
        metrics[f"decode_p{q}_s"] = (float(np.percentile(lat, q)), "s")
    return {"records": records, "window_s": window, "metrics": metrics,
            "work": {"requests": len(done), "points": points,
                     "blocks": sum(state["blocks"][r["item"]]
                                   for r in done)}}


def collect(run, state, result):
    res = run.mix["clouds"]["resolution"]
    result["answers"] = [
        {"item": r["item"], "thr": parse_container(state["streams"][
            r["item"]])[2], "keys": cloud_keys(r["out"], res)}
        for r in cc.sample(run, result["records"],
                           run.mix["check"]["samples"])]


def numbers(refs, answers):
    pts = 0.0
    for a in answers:
        ref = refs[a["item"]]
        if len(a["thr"]) != len(ref.blocks):
            return {"pts_mismatch": 1.0}
        bad, n = mismatch(a["keys"], ref.recon_keys(a["thr"]))
        pts = max(pts, bad / max(n, 1))
    return {"pts_mismatch": pts}


def judge(run, state, result):
    refs = cc.references(run, state["tree"], state["clouds"],
                         [a["item"] for a in result["answers"]])
    return numbers(refs, result["answers"])


def control(run, state, result):
    """The reference with TF32 convolutions in the program's place: its
    reconstruction at the streams' thresholds."""
    items = [a["item"] for a in result["answers"]]
    low = cc.references(run, state["tree"], state["clouds"], items,
                        tf32=True)
    answers = [{"item": a["item"], "thr": a["thr"],
                "keys": low[a["item"]].recon_keys(a["thr"])}
               for a in result["answers"]]
    del low
    refs = cc.references(run, state["tree"], state["clouds"], items)
    return numbers(refs, answers)


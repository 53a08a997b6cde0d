"""Driver ``decode_cw``: the ``decode`` driver's closed loop of decodes for
a model with the channel-wise context model (``c3p_cw``), whose weights
are its base model's file with its own laid over it. End-to-end:
``decode_rate``, the input cloud's points of every decode of the window
over its wall seconds.

Judged after the window against the plain reference of the channel-wise
model (``reference/c3p_cw.py``), which codes each sampled cloud through
its own slice chain: the window's decoded points against the reference's
reconstruction at the stream's thresholds (``pts_mismatch``), and each y
element's scale-table row as the program's decoder read it from the
stream, slice after slice, against the reference's (``idx_mismatch``; the
sampled streams decoded once more outside the window, through
``decompress_blocks(return_debug=True)``).
"""

from __future__ import annotations

import numpy as np

from benchlib import codec_cells as cc
from benchlib import weights
from benchlib.core import ROOT, load_module
from reference.judge import cloud_keys, mismatch, parse_container

KIND = "decode"
plain = load_module("drivers", "decode")

measure = plain.measure
release = cc.release


def weight_tree(config):
    """The base model's tree with the configuration's own modules laid
    over it."""
    tree = dict(cc.weight_tree(config))
    tree.update(weights.load_tree(ROOT / config["weights_cw"]))
    return tree


def prepare(run, carry=None):
    tree = weight_tree(run.config)
    codec = carry["codec"] if carry else cc.build_codec(run, tree)
    state = plain.prepare(run, {"codec": codec})
    state["tree"] = tree
    return state


def collect(run, state, result):
    res = run.mix["clouds"]["resolution"]
    decode = cc.debug_decoder(run, state["codec"])
    answers = []
    for r in cc.sample(run, result["records"], run.mix["check"]["samples"]):
        stream = state["streams"][r["item"]]
        answers.append({"item": r["item"], "thr": parse_container(stream)[2],
                        "keys": cloud_keys(r["out"], res),
                        "y_idx": decode(stream)[1]["y_idx"]})
    result["answers"] = answers


def references(run, tree, clouds, items, tf32=False):
    """{item: CWCloudReference} of the clouds ``items``."""
    from reference.c3p_cw import CWCloudReference, CWModel
    from reference.model import f32_convs

    if run.device != "cpu":
        f32_convs(tf32)
    cfg, c = run.config, run.mix["clouds"]
    model = CWModel(tree, cfg["analysis"], run.device, cfg["num_slices"],
                    cfg["max_support"])
    return {i: CWCloudReference(model, clouds[i], c["resolution"],
                                c["level"], cc.thresholds(cfg))
            for i in sorted(set(items))}


def numbers(refs, answers):
    """Each compared number, the worst over the answers (1 where a
    shape differs from the reference's)."""
    pts = idx = 0.0
    for a in answers:
        ref = refs[a["item"]]
        if (len(a["thr"]) != len(ref.blocks)
                or np.shape(a["y_idx"]) != ref.rows.shape):
            return {"pts_mismatch": 1.0, "idx_mismatch": 1.0}
        bad, n = mismatch(a["keys"], ref.recon_keys(a["thr"]))
        pts = max(pts, bad / max(n, 1))
        idx = max(idx, float(np.mean(a["y_idx"] != ref.rows)))
    return {"pts_mismatch": pts, "idx_mismatch": idx}


def judge(run, state, result):
    refs = references(run, state["tree"], state["clouds"],
                      [a["item"] for a in result["answers"]])
    return numbers(refs, result["answers"])


def control(run, state, result):
    """The reference with TF32 convolutions in the program's place: its
    reconstruction at the streams' thresholds and its scale rows."""
    items = [a["item"] for a in result["answers"]]
    low = references(run, state["tree"], state["clouds"], items, tf32=True)
    answers = [{"item": a["item"], "thr": a["thr"],
                "keys": low[a["item"]].recon_keys(a["thr"]),
                "y_idx": low[a["item"]].rows} for a in result["answers"]]
    del low
    refs = references(run, state["tree"], state["clouds"], items)
    return numbers(refs, answers)


def _patch(name, make):
    """Replace ``CompressionModelCW.<name>`` by ``make(real)``, in the
    model that encoder and decoder share; returns the undo."""
    from pcc_geo_cnn_v2_tpu_torch.models.codec_models import \
        CompressionModelCW as Model

    real = getattr(Model, name)
    setattr(Model, name, make(real))
    return lambda: setattr(Model, name, real)


def _lrp_off(real):
    def lrp(self, hyper, y_hats, k, y_q):
        return y_q

    return lrp


def _support_last(real):
    def support(self, y_hats, k):
        n = min(k, self.max_support)
        return y_hats[len(y_hats) - n:] if n else []

    return support


def _sigma_scale(real, factor=1.25):
    def slice_params(self, hyper, y_hats, k):
        import torch

        mu, sigma = self._mean_scale(hyper, y_hats, k)
        gc = self.conditional
        sigma = gc.bound_scale(gc.bound_scale(sigma) * factor)
        return mu, gc.indexes(sigma).to(torch.uint8)

    return slice_params


# faults planted in the program, which encoder and decoder share, so that
# every stream still decodes: the latent residual prediction left out, the
# support taken from the last decoded slices, σ scaled by 1.25
FAULTS = {"lrp_off": lambda: _patch("_lrp", _lrp_off),
          "support_last": lambda: _patch("support", _support_last),
          "sigma_scale": lambda: _patch("slice_params", _sigma_scale)}

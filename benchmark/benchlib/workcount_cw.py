"""The conv work count of a model with the channel-wise context model
(``c3p_cw``): its base model's layers (:func:`benchlib.workcount.layers`)
plus the second hyper synthesis (means) and the slice nets, at the same
rules and peaks as :mod:`benchlib.workcount`.

Slice k's mean and scale nets take the latent (``num_filters`` channels)
and the first ``min(k, max_support)`` decoded slices; its latent residual
net takes those and the slice itself. Each net is three stride-1 k3 convs
to ``slice_widths`` and then to the slice's channels, at the latent's
resolution.
"""

from __future__ import annotations

from benchlib import workcount
from benchlib.workcount import PEAK_BYTES, PEAK_FLOPS, _layer

__all__ = ["layers", "pass_work", "roofline_s"]

# the passes one block runs in each kind of work
PASSES = {"decode": ("hyper_synthesis", "slices", "synthesis")}


def layers(config):
    """Every convolution of one block's passes."""
    f, B = config["num_filters"], config["block_size"]
    S, support = config["num_slices"], config["max_support"]
    w0, w1 = config["slice_widths"]
    ry = B // 8
    out = workcount.layers(config)
    out += [_layer("hyper_synthesis", ry // 2, ry // 2, 3, f, f, True),
            _layer("hyper_synthesis", ry // 2, ry, 3, f, f, True),
            _layer("hyper_synthesis", ry, ry, 3, f, f, True)]
    cs = f // S
    for k in range(S):
        cin = f + cs * min(k, support)
        for c0 in (cin, cin, cin + cs):  # mean, scale, latent residual
            out += [_layer("slices", ry, ry, 3, c0, w0, False),
                    _layer("slices", ry, ry, 3, w0, w1, False),
                    _layer("slices", ry, ry, 3, w1, cs, False)]
    return out


def pass_work(config, kind):
    """(FLOPs, bytes) of one block in ``kind`` (``decode``)."""
    sel = [lay for lay in layers(config) if lay["pass"] in PASSES[kind]]
    return (sum(lay["flops"] for lay in sel),
            sum(lay["bytes"] for lay in sel))


def roofline_s(config, kind):
    """Σ over one block's layers of ``kind`` of max(FLOPs / peak FLOP/s,
    bytes / peak B/s)."""
    return sum(max(lay["flops"] / PEAK_FLOPS, lay["bytes"] / PEAK_BYTES)
               for lay in layers(config) if lay["pass"] in PASSES[kind])

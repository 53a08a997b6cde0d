"""The benchmark's count of convolution work, from a configuration's
published layer shapes, and the H100's published peaks.

A forward convolution (stride 1 or strided) does 2·k³·Cin·Cout FLOPs per
output voxel; a transposed convolution of stride s does that per input
voxel (the useful products: the zeros of the dilated input are no work).
Bytes are each input element read once, each output element written once,
and the weights, in float32. The count reads the same work whatever
computes the convolution.
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "layers", "pass_work", "step_work",
           "roofline_s"]

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def _layer(pass_name, res_in, res_out, k, cin, cout, transposed):
    vox = res_in ** 3 if transposed else res_out ** 3
    flops = 2 * vox * k ** 3 * cin * cout
    nbytes = F32 * (res_in ** 3 * cin + res_out ** 3 * cout + k ** 3 * cin
                    * cout)
    return {"pass": pass_name, "flops": flops, "bytes": nbytes,
            "shape": (res_in, res_out, k, cin, cout, transposed)}


def layers(config):
    """Every convolution of one block's passes: analysis, hyper_analysis,
    hyper_synthesis, synthesis (a v2 hyperprior model of the configuration's
    ``num_filters``, ``analysis`` / ``synthesis`` families and
    ``block_size``)."""
    f, B = config["num_filters"], config["block_size"]
    out = []
    if config["analysis"].endswith("V1"):
        for r, k, cin in ((B, 9, 1), (B // 2, 5, f), (B // 4, 5, f)):
            out.append(_layer("analysis", r, r // 2, k, cin, f, False))
        for r, k, cout in ((B // 8, 5, f), (B // 4, 5, f), (B // 2, 9, 1)):
            out.append(_layer("synthesis", r, 2 * r, k, f, cout, True))
    else:
        widths = ([f // 4, f // 2, f] if "Progressive" in config["analysis"]
                  else [f // 2, f, f])
        cin, r = 1, B
        for w in widths:
            out.append(_layer("analysis", r, r // 2, 3, cin, w, False))
            out += [_layer("analysis", r // 2, r // 2, 3, w, w, False)] * 2
            cin, r = w, r // 2
        out.append(_layer("analysis", r, r, 3, cin, f, False))
        cin, r = f, B // 8
        for w in reversed(widths):
            out.append(_layer("synthesis", r, 2 * r, 3, cin, w, True))
            out += [_layer("synthesis", 2 * r, 2 * r, 3, w, w, True)] * 2
            cin, r = w, 2 * r
        out.append(_layer("synthesis", r, r, 3, cin, 1, True))
    ry = B // 8
    out += [_layer("hyper_analysis", ry, ry, 3, f, f, False),
            _layer("hyper_analysis", ry, ry // 2, 3, f, f, False),
            _layer("hyper_analysis", ry // 2, ry // 2, 3, f, f, False),
            _layer("hyper_synthesis", ry // 2, ry // 2, 3, f, f, True),
            _layer("hyper_synthesis", ry // 2, ry, 3, f, f, True),
            _layer("hyper_synthesis", ry, ry, 3, f, f, True)]
    return out


# the passes one block runs in each kind of work
PASSES = {
    # the encoder reconstructs what the decoder will, to sweep thresholds
    "encode": ("analysis", "hyper_analysis", "hyper_synthesis", "synthesis"),
    "decode": ("hyper_synthesis", "synthesis"),
    "train": ("analysis", "hyper_analysis", "hyper_synthesis", "synthesis"),
}
# a training step: the forward, and a backward of twice its work
TRAIN_FACTOR = 3


def pass_work(config, kind):
    """(FLOPs, bytes) of one block in ``kind`` (``encode``, ``decode`` or
    ``train``)."""
    sel = [lay for lay in layers(config) if lay["pass"] in PASSES[kind]]
    factor = TRAIN_FACTOR if kind == "train" else 1
    return (factor * sum(lay["flops"] for lay in sel),
            factor * sum(lay["bytes"] for lay in sel))


def roofline_s(config, kind):
    """The least time one block's convolutions of ``kind`` take on the
    peaks: Σ over layers of max(FLOPs / peak FLOP/s, bytes / peak B/s)."""
    factor = TRAIN_FACTOR if kind == "train" else 1
    return factor * sum(max(lay["flops"] / PEAK_FLOPS,
                            lay["bytes"] / PEAK_BYTES)
                        for lay in layers(config)
                        if lay["pass"] in PASSES[kind])


def step_work(config, kind, blocks):
    """FLOPs of ``blocks`` blocks of ``kind``."""
    return pass_work(config, kind)[0] * blocks

"""conv_roofline_cw.decode: the least time of the window's convolutions of
a channel-wise model's decoder (its base model's, the second hyper
synthesis and the slice nets: ``benchlib/workcount_cw.py``) on the H100's
f32 and HBM peaks over the device time of the convolution kernels, in
percent."""

from benchlib import workcount_cw
from benchlib.tracing import family


def read(ctx):
    if (ctx["kind"] != "decode" or "num_slices" not in ctx["config"]
            or not ctx["work"]["blocks"]):
        return None
    conv_s = sum(hi - lo for name, lo, hi in ctx["trace"]["kernels"]
                 if family(name) == "convolution")
    if conv_s <= 0:
        return None
    least = workcount_cw.roofline_s(ctx["config"], "decode") \
        * ctx["work"]["blocks"]
    return 100.0 * least / conv_s

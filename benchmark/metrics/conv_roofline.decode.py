"""conv_roofline.decode: the least time of the window's convolutions on the
H100's f32 and HBM peaks over their kernels' device time, in percent."""

from benchlib.layer_metrics import conv_roofline


def read(ctx):
    return conv_roofline(ctx, "decode")

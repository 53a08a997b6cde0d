"""mfu.encode: the convolutions' FLOPs (frozen count) of the blocks the traced
window stepped through in encode, over the window's seconds and the H100's f32
peak, in percent."""

from benchlib.layer_metrics import mfu


def read(ctx):
    return mfu(ctx, "encode")

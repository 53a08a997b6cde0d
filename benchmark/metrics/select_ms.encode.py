"""select_ms.encode: wall ms a cloud in the encoder's selection (the
program's ``codec.select`` span: mask unpack, K2's full-cloud D1 sums,
outlier resolve, departition), from the codec's
``compress_blocks_device_opt`` log records of the traced window (full
precision), over the window's completed requests."""

from benchlib.codec_log import encode_phase_ms


def read(ctx):
    return encode_phase_ms(ctx, 3)

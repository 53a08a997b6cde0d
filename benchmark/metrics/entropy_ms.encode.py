"""entropy_ms.encode: host ms a cloud in the encoder's range coder (the
program's ``codec.entropy_encode`` span), from the codec's
``compress_blocks_device_opt`` log records of the traced window (full
precision), over the window's completed requests."""

from benchlib.codec_log import encode_phase_ms


def read(ctx):
    return encode_phase_ms(ctx, 2)

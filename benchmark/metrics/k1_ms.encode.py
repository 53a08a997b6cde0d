"""k1_ms.encode: kernel K1's (``csrc/bucket_colsums.cu``, every kernel of
it by name) device ms a cloud encoded in the traced window."""

from benchlib.layer_metrics import kernel_ms


def read(ctx):
    return kernel_ms(ctx, "encode", "K1 bucket_colsums")

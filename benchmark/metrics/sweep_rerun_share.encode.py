"""sweep_rerun_share.encode: percent of the blocks swept in the traced
window that the threshold sweep swept again at K = B³ after a bucket
overflow, from the codec's log records of the window: each overflow
record names the blocks re-swept, each ``compress_blocks_device_opt``
record the blocks swept."""

from benchlib.codec_log import rerun_share


def read(ctx):
    return rerun_share(ctx)

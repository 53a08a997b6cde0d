"""slice_ms.decode: host ms a cloud of the channel-wise decoder's slice
loop (its μ / σ-row, slice rANS and latent-residual phases summed), from
the arguments of the codec's ``decompress_blocks_cw`` log records of the
traced window (host clock, full precision)."""

from benchlib.codec_log import args_of

# decompress_blocks_cw(blocks, z rANS, decode_z, slice params, slice rANS,
# slice lrp, decode_y, unpack)
RECORD = ("decompress_blocks_cw(", 8)


def read(ctx):
    recs = args_of(ctx, RECORD) if ctx["kind"] == "decode" else []
    if not recs:
        return None
    return 1e3 * sum(a[3] + a[4] + a[5] for a in recs) / len(recs)

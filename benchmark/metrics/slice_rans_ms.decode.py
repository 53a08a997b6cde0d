"""slice_rans_ms.decode: host ms a cloud of the channel-wise decoder's
range decoding of the y slices, from the arguments of the codec's
``decompress_blocks_cw`` log records of the traced window (host clock,
full precision)."""

from benchlib.codec_log import args_of

# decompress_blocks_cw(blocks, z rANS, decode_z, slice params, slice rANS,
# slice lrp, decode_y, unpack)
RECORD = ("decompress_blocks_cw(", 8)


def read(ctx):
    recs = args_of(ctx, RECORD) if ctx["kind"] == "decode" else []
    if not recs:
        return None
    return 1e3 * sum(a[4] for a in recs) / len(recs)

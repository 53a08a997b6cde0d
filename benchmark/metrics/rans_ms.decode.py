"""rans_ms.decode: host ms of z-rANS plus y-rANS decoding a cloud, from
the arguments of the codec's ``decompress_blocks`` log records of the
traced window (host clock, full precision)."""


def read(ctx):
    if ctx["kind"] != "decode":
        return None
    ms = [1e3 * (args[1] + args[3]) for msg, args, _ in ctx["log"]
          if msg.startswith("decompress_blocks(") and len(args) == 6]
    return sum(ms) / len(ms) if ms else None

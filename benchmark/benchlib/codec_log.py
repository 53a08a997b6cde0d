"""Per-layer arithmetic on the codec's log records of the traced window
(``ctx["log"]``: message, raw arguments, time; the mix's
``program_logs``): the encoder's phase durations, which the program
takes from its spans (``utils/trace.span``), and its sweep's block
counts."""

from __future__ import annotations

__all__ = ["ENCODE", "OVERFLOW", "args_of", "encode_phase_ms",
           "rerun_share"]

# compress_blocks_device_opt(blocks, device s, entropy s, select s)
ENCODE = ("compress_blocks_device_opt(", 4)
# the blocks one chunk re-sweeps at K = B³ after a bucket overflow
OVERFLOW = ("bucket sweep overflow", 1)


def args_of(ctx, record):
    """The arguments of the window's log records of kind ``record``
    ((message prefix, argument count))."""
    prefix, n = record
    return [args for msg, args, _ in ctx["log"]
            if msg.startswith(prefix) and len(args) == n]


def encode_phase_ms(ctx, arg):
    """Host ms a completed request spent in the encoder's phase that
    argument ``arg`` of its log record times."""
    if ctx["kind"] != "encode" or not ctx["work"]["requests"]:
        return None
    recs = args_of(ctx, ENCODE)
    if not recs:
        return None
    return 1e3 * sum(a[arg] for a in recs) / ctx["work"]["requests"]


def rerun_share(ctx):
    """Percent of the window's swept blocks that were swept again at
    K = B³."""
    if ctx["kind"] != "encode":
        return None
    blocks = sum(a[0] for a in args_of(ctx, ENCODE))
    if not blocks:
        return None
    return 100.0 * sum(a[0] for a in args_of(ctx, OVERFLOW)) / blocks

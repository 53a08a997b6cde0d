"""Arithmetic shared by the per-layer metric readers (``metrics/*.py``):
each reader is one call of these on the traced run's context."""

from __future__ import annotations

from benchlib import workcount
from benchlib.tracing import family

__all__ = ["mfu", "conv_roofline", "kernel_ms", "idle_share"]


def mfu(ctx, kind):
    """Percent of the f32 peak: the conv FLOPs of the window's blocks (the
    frozen count) over the traced window's seconds."""
    if ctx["kind"] != kind or not ctx["work"]["blocks"]:
        return None
    flops = workcount.step_work(ctx["config"], kind, ctx["work"]["blocks"])
    return 100.0 * flops / (ctx["trace"]["window_s"] * workcount.PEAK_FLOPS)


def conv_roofline(ctx, kind):
    """Percent: the window's blocks' least conv time on the peaks (Σ over
    layers of the larger of FLOPs / peak and bytes / peak) over the device
    time of the convolution kernels."""
    if ctx["kind"] != kind or not ctx["work"]["blocks"]:
        return None
    conv_s = sum(hi - lo for name, lo, hi in ctx["trace"]["kernels"]
                 if family(name) == "convolution")
    if conv_s <= 0:
        return None
    least = workcount.roofline_s(ctx["config"], kind) * ctx["work"]["blocks"]
    return 100.0 * least / conv_s


def kernel_ms(ctx, kind, fam):
    """Device ms of the kernels of family ``fam`` a request."""
    if ctx["kind"] != kind or not ctx["work"]["requests"]:
        return None
    s = sum(hi - lo for name, lo, hi in ctx["trace"]["kernels"]
            if family(name) == fam)
    return 1e3 * s / ctx["work"]["requests"] if s > 0 else None


def idle_share(ctx, kind):
    """Percent of the traced window with no operation on the device."""
    if ctx["kind"] != kind:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

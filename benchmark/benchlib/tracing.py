"""Reduction of a ``torch.profiler`` trace of the measured window: device
kernels with their times, device busy time (the union of kernel intervals
over streams), the idle gaps labelled by the benchmark's host spans, and
the kernel families (a frozen copy of the port's profile tool's family
arithmetic, ``tools/torch_profile_main_path.py``).
"""

from __future__ import annotations

__all__ = ["FAMILIES", "family", "WINDOW_SPAN", "reduce"]

FAMILIES = (("K1 bucket_colsums", ("bucket_colsums",)),
            ("K2 halo_edt", ("halo_edt",)),
            ("K3 bucket_colsums_d2", ("bucket_d2",)),
            ("K5 edt_sweep", ("edt_sweep",)),
            ("K4a fused_tail", ("tail_kernel",)),
            ("K4b fused_tail_slab", ("tail_slab_kernel",)),
            # cuDNN's own kernels and its xmma / implicit-GEMM convolution
            # tiles; not a plain GEMM (cuBLAS) or a dtype conversion
            ("convolution", ("cudnn", "xmma_fprop", "xmma_dgrad",
                             "xmma_wgrad", "implicit_gemm", "convolve",
                             "wgrad", "dgrad")),
            ("sort", ("sort", "radix")),
            ("copy / fill", ("copy", "fill", "memset", "memcpy")))

WINDOW_SPAN = "bench.window"


def family(name):
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _union(intervals):
    """Merged, sorted intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def reduce(prof, spans, host_window, top=10):
    """The traced window of ``prof`` (the ``record_function`` range
    :data:`WINDOW_SPAN` the harness opens around it, ``host_window`` =
    (start, end) of the same on the host's ``perf_counter``): dict(kernels
    [(name, start_s, end_s)], window_s, busy_s, device_ops, idle_gaps),
    times in seconds on the profiler's clock, clipped to the window.
    ``spans`` are the benchmark's host spans [(name, thread, start, end)]
    on ``perf_counter``, placed on the profiler's clock by the window's
    start."""
    from torch.autograd import DeviceType

    events = prof.events()
    # user annotations also appear on the device's timeline: only the
    # host's copies are spans, and none of them is device work
    window = [e for e in events if e.name == WINDOW_SPAN
              and getattr(e, "device_type", None) != DeviceType.CUDA]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    kernels = []
    for e in events:
        if (getattr(e, "device_type", None) != DeviceType.CUDA
                or e.name == WINDOW_SPAN):
            continue
        lo, hi = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if hi > lo:
            kernels.append((e.name, lo / 1e6, hi / 1e6))
    shift = w0 - host_window[0] * 1e6
    spans = [(n, th, lo * 1e6 + shift, hi * 1e6 + shift)
             for n, th, lo, hi in spans]
    busy = _union([(lo, hi) for _, lo, hi in kernels])
    busy_s = sum(hi - lo for lo, hi in busy)
    gaps, prev = [], w0 / 1e6
    for lo, hi in busy + [[w1 / 1e6, w1 / 1e6]]:
        if lo > prev:
            gaps.append((prev, lo))
        prev = max(prev, hi)
    gaps.sort(key=lambda g: g[0] - g[1])

    def label(t_s):
        """The innermost benchmark span of each host thread at ``t_s``."""
        t = t_s * 1e6
        inner = {}
        for name, thread, lo, hi in spans:
            if lo <= t < hi and (thread not in inner
                                 or lo > inner[thread][1]):
                inner[thread] = (name, lo)
        return "+".join(sorted(n for n, _ in inner.values())) or "no span"

    by_name = {}
    for name, lo, hi in kernels:
        by_name[name] = by_name.get(name, 0.0) + (hi - lo)
    return {
        "kernels": kernels,
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_s,
        "device_ops": [[n[:160], s] for n, s in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[label((lo + hi) / 2), hi - lo]
                      for lo, hi in gaps[:top]],
    }

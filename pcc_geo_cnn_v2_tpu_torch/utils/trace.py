"""The port's spans and counters: one place that times its phases and
counts its events.

``span(name)`` times a phase on ``time.perf_counter`` (its ``seconds``
after exit), whatever else is running: the
codec's INFO log lines take their durations from spans. Only while a
torch profiler is active does a span also open the profiler range
``pcc.<name>`` (``record_function``), so that the phase and the kernels
launched inside it share the profiler's clock; ranges nest on the calling
thread as the spans do, so a range's parent is the span that caused it.
The profiler's enabled flag is read once at entry; with no profiler a
span takes no lock and keeps nothing but its duration. Torch is never
imported here: with no torch loaded no profiler can be active.

``count(name, n)`` adds to the one registry of counters, under one lock
(clients call the port from several threads at once):
``launches.<kernel>`` (:mod:`ops.kernels`, its ``launches`` view).
"""

from __future__ import annotations

import sys
import threading
import time

__all__ = ["PREFIX", "span", "count", "value", "reset"]

# every profiler range of the port starts with this
PREFIX = "pcc."


class span:
    """A timed phase; a ``pcc.<name>`` profiler range while profiling."""

    __slots__ = ("name", "t0", "seconds", "_range")

    def __init__(self, name):
        self.name = name
        self.seconds = 0.0
        self._range = None

    def __enter__(self):
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is not None and prof._is_profiler_enabled:
            self._range = prof.record_function(PREFIX + self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


_counts = {}
_lock = threading.Lock()


def count(name, n=1):
    """Add ``n`` to counter ``name`` (a read-modify-write of a dict that
    several threads share, so under the lock)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def value(name):
    """Counter ``name`` (0 before its first count)."""
    with _lock:
        return _counts.get(name, 0)


def reset(prefix=""):
    """Set the counters whose names start with ``prefix`` to 0."""
    with _lock:
        for k in _counts:
            if k.startswith(prefix):
                _counts[k] = 0

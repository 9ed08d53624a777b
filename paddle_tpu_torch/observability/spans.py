"""Timed sections of the port (``paddle_tpu/observability/spans.py``).

A ``span("collective.all_reduce")`` block:

1. opens a ``torch.profiler.record_function`` range, so the section shows
   in a ``torch.profiler`` trace (the reference opens a ``RecordEvent``);
2. records its wall duration into the bounded histogram metric of the same
   name (``metrics.observe``);
3. emits a ``span`` run-log event when a trace context is attached
   (:mod:`.trace`), with ``error=true`` if the body raised.

Gated by ``FLAGS_monitor``: with the flag off, ``span(...)`` returns a
shared no-op context, so hot paths keep their instrumentation
unconditionally. The reference's ``introspect`` is not ported.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..framework.flags import flag
from . import metrics
from . import trace as _trace

__all__ = ["span", "Span"]


class Span:
    """One timed section; after exit ``seconds`` holds its wall duration and
    ``error`` whether the body raised. The exception always propagates."""

    __slots__ = ("name", "seconds", "error", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.seconds: Optional[float] = None
        self.error = False
        self._t0 = 0
        self._rf = None

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = (time.perf_counter_ns() - self._t0) / 1e9
        self.error = exc_type is not None
        try:
            self._rf.__exit__(exc_type, exc, tb)
        finally:
            self._rf = None
            self.seconds = dt
            metrics.observe(self.name, dt)
            if _trace.current_trace() is not None:
                _trace.span_event(self.name, trace_id=_trace.current_trace(), seconds=dt,
                                  error=self.error)
        return False


class _NullSpan:
    __slots__ = ()
    name = ""
    seconds = None
    error = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def span(name: str):
    """A timed section: a real :class:`Span` when ``FLAGS_monitor`` is on,
    the shared no-op otherwise."""
    if not flag("FLAGS_monitor"):
        return _NULL
    return Span(name)

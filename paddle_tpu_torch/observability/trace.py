"""Distributed tracing plane of the port (a copy of
``paddle_tpu/observability/trace.py``): deterministic trace/span ids and
context propagation.

One **trace id** names one logical operation end-to-end, across every
process that touches it: a fleet request carries its id from
``ServingFleet.submit`` through Router placement, scheduler admission,
per-chunk prefill, fused decode steps, requeue-after-kill, and
delivery, in the parent and in replica processes alike. A **span** is one
timed section inside a trace, emitted as a ``span`` run-log event::

    {"event": "span", "name": ..., "trace": ..., "span": ...,
     "parent": ..., "seconds": ..., "error": false, ...attrs}

so one request's whole path can be rebuilt from N processes' run logs
(``python -m paddle_tpu_torch.observability report --merge <dir>``).

Ids are **deterministic**: seeded via
:func:`paddle_tpu_torch.framework.random.host_generator` on (the host seed,
tag, ``PADDLE_TRAINER_ID``) — rank/replica-decorrelated (distinct ranks
draw independent streams) yet bitwise-replayable under chaos tests, the
same discipline as the retry-jitter stream.

Clock alignment for merged timelines: :func:`sync_clocks` publishes this
process's wall-clock epoch to a TCPStore under ``__obs__/<rank>/epoch``,
reads every peer's, and records the offset against rank 0 as a
``clock_sync`` run-log event, by which a merged timeline shifts each
process's events so cross-host skew doesn't scramble the lanes.

Gated by ``FLAGS_trace`` AND ``FLAGS_monitor``: when either is off no ids
are allocated and no span events are emitted (the bench's tracing-off arm
measures exactly this).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

from ..framework.flags import flag
from . import metrics
from . import runlog as _runlog

__all__ = [
    "enabled", "new_trace_id", "new_span_id", "current_trace",
    "current_span", "attach", "trace_span", "span_event", "sync_clocks",
    "EPOCH_KEY_PREFIX",
]

EPOCH_KEY_PREFIX = "__obs__"


class _TraceState(threading.local):
    def __init__(self):
        self.stack = []  # [(trace_id, span_id)] innermost last


_TLS = _TraceState()

# One numpy generator per (seed, tag, rank): host_generator returns an
# identically-seeded stream per call, so successive ids must come from a
# cached generator, not a fresh one.
_GENS: Dict[Tuple[int, str], object] = {}
_GEN_LOCK = threading.Lock()


def enabled() -> bool:
    """Tracing is on: both the telemetry spine and the trace plane."""
    return bool(flag("FLAGS_monitor")) and bool(flag("FLAGS_trace"))


def _rank() -> str:
    return os.environ.get("PADDLE_TRAINER_ID", "0")


def _gen(tag: str):
    from ..framework import random as _random

    key = (_random.seed_value(), tag)
    g = _GENS.get(key)
    if g is None:
        with _GEN_LOCK:
            g = _GENS.get(key)
            if g is None:
                g = _GENS[key] = _random.host_generator(f"trace/{tag}/{_rank()}")
    return g


def _hex_id(tag: str) -> str:
    import numpy as np

    return f"{int(_gen(tag).integers(1, 2 ** 64, dtype=np.uint64)):016x}"


def new_trace_id(tag: str = "trace") -> Optional[str]:
    """A fresh 16-hex trace id, or None when tracing is off. Deterministic:
    same seed + same tag + same rank ⇒ the same id sequence (chaos replays
    reproduce the exact trace graph); distinct ranks/replicas decorrelate
    through the rank folded into the generator tag."""
    if not enabled():
        return None
    metrics.counter_inc("trace.traces")
    return _hex_id(tag)


def new_span_id() -> str:
    return _hex_id("span")


def current_trace() -> Optional[str]:
    """The innermost attached trace id, or None."""
    return _TLS.stack[-1][0] if _TLS.stack else None


def current_span() -> Optional[str]:
    return _TLS.stack[-1][1] if _TLS.stack else None


class _Attach:
    """Context manager installing (trace_id, span_id) as the current trace
    context for the block — exception-safe: the stack pops in ``finally``
    semantics whether or not the body raised."""

    __slots__ = ("trace_id", "span_id", "_pushed")

    def __init__(self, trace_id: Optional[str], span_id: Optional[str]):
        self.trace_id = trace_id
        self.span_id = span_id
        self._pushed = False

    def __enter__(self):
        if self.trace_id is not None:
            _TLS.stack.append((self.trace_id, self.span_id))
            self._pushed = True
        return self

    def __exit__(self, *exc):
        if self._pushed:
            _TLS.stack.pop()
            self._pushed = False
        return False


def attach(trace_id: Optional[str], span_id: Optional[str] = None) -> _Attach:
    """Install an EXISTING trace id (e.g. a fleet request's) as the ambient
    context: spans opened inside the block link to it. ``trace_id=None``
    (tracing off) attaches nothing — the block runs untraced."""
    return _Attach(trace_id, span_id)


class TraceSpan:
    """One timed, trace-linked section. On exit — exception-safe — it pops
    the nesting stack, emits a ``span`` run-log event carrying
    trace/span/parent ids, duration, and ``error`` (true when the body
    raised), and records the duration histogram."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "seconds", "error", "_t0", "_pushed")

    def __init__(self, name: str, trace_id: Optional[str] = None, **attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id: Optional[str] = None
        self.parent_id: Optional[str] = None
        self.attrs = attrs
        self.seconds: Optional[float] = None
        self.error = False
        self._t0 = 0
        self._pushed = False

    def __enter__(self):
        if self.trace_id is None:
            self.trace_id = current_trace()
        self.parent_id = current_span()
        self.span_id = new_span_id()
        _TLS.stack.append((self.trace_id, self.span_id))
        self._pushed = True
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = (time.perf_counter_ns() - self._t0) / 1e9
        self.seconds = dt
        self.error = exc_type is not None
        try:
            span_event(self.name, trace_id=self.trace_id, seconds=dt,
                       span_id=self.span_id, parent_id=self.parent_id,
                       error=self.error, **self.attrs)
            metrics.observe(self.name, dt)
        finally:
            if self._pushed:
                _TLS.stack.pop()
                self._pushed = False
        return False


class _NullTraceSpan:
    """Shared no-op for the tracing-off path."""

    __slots__ = ()
    name = ""
    trace_id = span_id = parent_id = seconds = None
    error = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullTraceSpan()


def trace_span(name: str, trace_id: Optional[str] = None, **attrs):
    """A trace-linked timed section: a real :class:`TraceSpan` when tracing
    is enabled, the shared no-op otherwise."""
    if not enabled():
        return _NULL
    return TraceSpan(name, trace_id=trace_id, **attrs)


def span_event(name: str, trace_id: Optional[str], seconds: Optional[float] = None,
               span_id: Optional[str] = None, parent_id: Optional[str] = None,
               error: bool = False, **attrs) -> Optional[str]:
    """Emit one ``span`` run-log event directly (the cheap spelling for hot
    loops that already measured their own duration — per-chunk prefill,
    fused decode). Returns the span id, or None when tracing is off or the
    event carries no trace linkage at all."""
    if not enabled() or (trace_id is None and not attrs.get("traces")):
        return None
    sid = span_id or new_span_id()
    metrics.counter_inc("trace.spans")
    _runlog.emit("span", name=name, trace=trace_id, span=sid,
                 parent=parent_id if parent_id is not None else current_span(),
                 seconds=seconds, error=bool(error), **attrs)
    return sid


def sync_clocks(store, rank: int, world_size: int,
                timeout: Optional[float] = None,
                epoch: Optional[float] = None) -> float:
    """Publish this process's wall-clock epoch under
    ``__obs__/<rank>/epoch`` and compute its offset against rank 0's.

    Every participating process calls this once (any time after the store
    rendezvous); the offset — ``own_epoch - rank0_epoch`` — lands in the
    run log as a ``clock_sync`` event, by which a merged timeline shifts
    each process's events onto rank 0's clock. ``epoch`` overrides the sampled wall
    clock (tests inject known skew). Returns the offset in seconds."""
    own = time.time() if epoch is None else float(epoch)
    store.set(f"{EPOCH_KEY_PREFIX}/{rank}/epoch", repr(own))
    epochs = {}
    for peer in range(int(world_size)):
        if peer == rank:
            epochs[peer] = own
            continue
        raw = store.get(f"{EPOCH_KEY_PREFIX}/{peer}/epoch", timeout=timeout)
        epochs[peer] = float(raw if isinstance(raw, str) else raw.decode())
    offset = own - epochs[0]
    _runlog.emit("clock_sync", rank=int(rank), epoch=own, offset=offset,
                 world_size=int(world_size))
    return offset

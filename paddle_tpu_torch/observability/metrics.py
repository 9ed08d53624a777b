"""Host-side metrics registry of the port: counters, gauges and bounded
histograms.

A copy of the counter/gauge/histogram core of
``paddle_tpu/observability/metrics.py`` (the port imports nothing of
``paddle_tpu``), with its ``snapshot`` and the serving fleet's pre-declared
counters. The run log, traces and the flight recorder are
:mod:`.runlog`, :mod:`.trace` and :mod:`.flightrec`; exports and SLOs are
not ported (ROADMAP.md, Queue 1 item 11). ``counter_inc``/``observe`` are
one dict operation under the GIL, so hot paths call them unconditionally.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Histogram", "counter_inc", "counters", "reset_counters", "declare_counter",
    "gauge_set", "gauges", "observe", "histogram", "histograms", "snapshot",
    "FLEET_COUNTERS", "INGRESS_COUNTERS",
]

# Default bucket bounds (seconds): half-decade geometric ladder, 1us to 100s.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(10.0 ** (e / 2.0) for e in range(-12, 5))

_COUNTERS: Dict[str, float] = {}
_DECLARED_COUNTERS: set = set()
_GAUGES: Dict[str, float] = {}
_HISTOGRAMS: Dict[str, "Histogram"] = {}
_CREATE_LOCK = threading.Lock()  # two threads first-observing one name


class Histogram:
    """Bounded histogram: fixed bucket upper bounds + running aggregates;
    observing never allocates."""

    __slots__ = ("bounds", "bucket_counts", "count", "sum", "min", "max", "overflow_min")

    def __init__(self, bounds: Optional[Iterable[float]] = None):
        self.bounds: Tuple[float, ...] = tuple(bounds) if bounds is not None else DEFAULT_BUCKETS
        if any(nxt <= prev for prev, nxt in zip(self.bounds, self.bounds[1:])):
            raise ValueError("histogram bucket bounds must be strictly increasing")
        self.bucket_counts: List[int] = [0] * (len(self.bounds) + 1)  # +overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.overflow_min = math.inf  # the overflow bucket's true lower edge

    def observe(self, value: float) -> None:
        i = 0
        for b in self.bounds:
            if value <= b:
                break
            i += 1
        self.bucket_counts[i] += 1
        if i == len(self.bounds) and value < self.overflow_min:
            self.overflow_min = value
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def percentile(self, q: float) -> Optional[float]:
        """Approximate percentile (0..100) by linear interpolation inside the
        bucket holding the q-th observation, clamped to the observed min and
        max; None when empty."""
        if self.count == 0:
            return None
        target = max(1.0, (q / 100.0) * self.count)
        seen = 0
        for i, n in enumerate(self.bucket_counts):
            if n == 0:
                continue
            if seen + n >= target:
                if i >= len(self.bounds):  # overflow bucket
                    lo, hi = self.overflow_min, self.max
                elif i > 0:
                    lo, hi = self.bounds[i - 1], self.bounds[i]
                else:
                    lo, hi = min(self.min, self.bounds[0]), self.bounds[0]
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                return lo + (hi - lo) * (target - seen) / n
            seen += n
        return self.max

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        return {"count": self.count, "sum": self.sum, "mean": self.sum / self.count,
                "min": self.min, "max": self.max, "p50": self.percentile(50),
                "p90": self.percentile(90), "p99": self.percentile(99)}


def counter_inc(name: str, n: float = 1) -> None:
    """Bump a named monotonic counter."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters(prefix: str = "") -> Dict[str, float]:
    return {k: v for k, v in _COUNTERS.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Zero counters matching ``prefix`` (all when empty); declared names stay
    present at 0."""
    for k in [k for k in _COUNTERS if k.startswith(prefix)]:
        if k in _DECLARED_COUNTERS:
            _COUNTERS[k] = 0
        else:
            del _COUNTERS[k]


def declare_counter(name: str) -> None:
    """Pre-register ``name`` so it reads 0 before its first increment."""
    _DECLARED_COUNTERS.add(name)
    _COUNTERS.setdefault(name, 0)


def gauge_set(name: str, value: float) -> None:
    _GAUGES[name] = value


def gauges(prefix: str = "") -> Dict[str, float]:
    return {k: v for k, v in _GAUGES.items() if k.startswith(prefix)}


def histogram(name: str, bounds: Optional[Iterable[float]] = None) -> Histogram:
    """The histogram registered under ``name`` (created on first use)."""
    h = _HISTOGRAMS.get(name)
    if h is None:
        with _CREATE_LOCK:
            h = _HISTOGRAMS.get(name)
            if h is None:
                h = _HISTOGRAMS[name] = Histogram(bounds)
    return h


def observe(name: str, value: float) -> None:
    """Record ``value`` into the bounded histogram ``name``."""
    h = _HISTOGRAMS.get(name)
    if h is None:
        h = histogram(name)
    h.observe(value)


def histograms(prefix: str = "") -> Dict[str, Histogram]:
    return {k: v for k, v in _HISTOGRAMS.items() if k.startswith(prefix)}


def snapshot() -> dict:
    """JSON-able snapshot of every series: counters, gauges, and histogram
    summaries."""
    return {
        "counters": dict(_COUNTERS),
        "gauges": dict(_GAUGES),
        "histograms": {k: h.summary() for k, h in sorted(_HISTOGRAMS.items())},
    }


# Serving-fleet tier (inference/fleet.py, procfleet.py, router.py), with the
# reference's names: requeues counts in-flight requests replayed off dead
# replicas, sheds the admissions refused by queue-depth control, the
# routed_* pair splits placements by affinity and least load.
FLEET_COUNTERS: Tuple[str, ...] = (
    "fleet.requests_submitted", "fleet.requests_completed",
    "fleet.requeues", "fleet.sheds", "fleet.deadline_hits",
    "fleet.replica_deaths", "fleet.scale_outs",
    "fleet.routed_affinity", "fleet.routed_load",
    "fleet.stream_chunks", "fleet.cancels",
)
# The HTTP ingress's admission ledger and the RPC transport's split between
# the fast-path socket and the TCPStore (inference/ingress.py, rpc.py).
INGRESS_COUNTERS: Tuple[str, ...] = (
    "ingress.requests", "ingress.responses",
    "ingress.rejected_overload", "ingress.rejected_backpressure",
    "ingress.rejected_draining",
    "ingress.idempotent_hits", "ingress.disconnect_cancels",
    "ingress.drains",
    "rpc.socket_msgs", "rpc.store_msgs", "rpc.socket_connects",
    "rpc.socket_fallbacks", "rpc.partial_drains",
)
# The serving scheduler's cancel paths, the observability plane's own cost,
# and the reference's warm-up counters: the fleet's heartbeat exempts a tick
# in which ``infer.compiles`` or ``infer.aot_cache_hits`` moved. The port
# compiles no serving program, so both stay 0 (ROADMAP.md, Queue 1 item 4).
_OTHER_COUNTERS: Tuple[str, ...] = (
    "serving.requests_cancelled", "serving.deadline_exceeded",
    "trace.traces", "trace.spans", "flightrec.dumps",
    "runlog.rotations", "runlog.gc_removed",
    "infer.compiles", "infer.aot_cache_hits",
)
for _name in FLEET_COUNTERS + INGRESS_COUNTERS + _OTHER_COUNTERS:
    declare_counter(_name)

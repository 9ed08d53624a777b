"""Host-side metrics registry of the port: counters, gauges and bounded
histograms, with the Prometheus text export.

A copy of ``paddle_tpu/observability/metrics.py`` (the port imports nothing
of ``paddle_tpu``): the same series names, the same ``snapshot`` document,
and a ``prometheus_text`` whose exposition for the same series is byte for
byte the reference's (the ``paddle_tpu_`` name prefix included, so either
package's scrapers read the other's ``/metrics``). ``counter_inc``/
``observe`` are one dict operation under the GIL, so hot paths call them
unconditionally; the SLO monitor reads the live registries through
:func:`counter_value`, :func:`gauge_value` and :func:`find_histogram`.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Histogram", "counter_inc", "counters", "reset_counters", "declare_counter",
    "declare_help", "gauge_set", "gauges", "observe", "histogram", "declare_histogram",
    "histograms", "counter_value", "gauge_value", "find_histogram", "snapshot",
    "prometheus_text", "escape_help", "escape_label_value", "reset_all",
    "FLEET_COUNTERS", "INGRESS_COUNTERS", "SERVING_COUNTERS", "OBS_COUNTERS", "SLO_COUNTERS",
    "RECSYS_COUNTERS", "DATALOADER_COUNTERS", "DATALOADER_SPANS", "HAPI_HISTOGRAMS", "HAPI_GAUGES",
]

# Default bucket bounds (seconds): half-decade geometric ladder, 1us to 100s.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(10.0 ** (e / 2.0) for e in range(-12, 5))

_COUNTERS: Dict[str, float] = {}
_DECLARED_COUNTERS: set = set()
_HELP: Dict[str, str] = {}
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
        max; None when empty. A delta histogram built from bucket counts
        (the SLO monitor's windows) has no finite min/max and interpolates
        on the bucket bounds alone."""
        if self.count == 0:
            return None
        target = max(1.0, (q / 100.0) * self.count)
        seen = 0
        for i, n in enumerate(self.bucket_counts):
            if n == 0:
                continue
            if seen + n >= target:
                if i >= len(self.bounds):  # overflow bucket
                    lo = self.overflow_min
                    if not math.isfinite(lo):
                        lo = self.bounds[-1] if self.bounds else 0.0
                    hi = self.max if math.isfinite(self.max) else lo
                elif i > 0:
                    lo, hi = self.bounds[i - 1], self.bounds[i]
                else:
                    lo = self.min if math.isfinite(self.min) else min(0.0, self.bounds[0])
                    hi = self.bounds[0]
                if math.isfinite(self.min):
                    lo = max(lo, self.min)
                if math.isfinite(self.max) and self.max >= lo:
                    hi = min(hi, self.max)
                frac = (target - seen) / n
                return lo + (hi - lo) * frac
            seen += n
        return self.max if math.isfinite(self.max) else None

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


def counter_value(name: str) -> float:
    """One counter's current value (0 before its first increment)."""
    return _COUNTERS.get(name, 0.0)


def reset_counters(prefix: str = "") -> None:
    """Zero counters matching ``prefix`` (all when empty); declared names stay
    present at 0."""
    for k in [k for k in _COUNTERS if k.startswith(prefix)]:
        if k in _DECLARED_COUNTERS:
            _COUNTERS[k] = 0
        else:
            del _COUNTERS[k]


def declare_counter(name: str, help_str: str = "") -> None:
    """Pre-register ``name`` so it reads and exports 0 before its first
    increment; ``help_str`` becomes its ``# HELP`` line."""
    _DECLARED_COUNTERS.add(name)
    _COUNTERS.setdefault(name, 0)
    if help_str:
        _HELP[name] = help_str


def declare_help(name: str, help_str: str) -> None:
    """Attach ``# HELP`` text to any series (counter, gauge, histogram)."""
    _HELP[name] = help_str


def gauge_set(name: str, value: float) -> None:
    _GAUGES[name] = value


def gauges(prefix: str = "") -> Dict[str, float]:
    return {k: v for k, v in _GAUGES.items() if k.startswith(prefix)}


def gauge_value(name: str) -> Optional[float]:
    """One gauge's current value, None while unset."""
    return _GAUGES.get(name)


def histogram(name: str, bounds: Optional[Iterable[float]] = None) -> Histogram:
    """The histogram registered under ``name`` (created on first use)."""
    h = _HISTOGRAMS.get(name)
    if h is None:
        with _CREATE_LOCK:
            h = _HISTOGRAMS.get(name)
            if h is None:
                h = _HISTOGRAMS[name] = Histogram(bounds)
    return h


declare_histogram = histogram


def find_histogram(name: str) -> Optional[Histogram]:
    """The histogram registered under ``name``, None when nothing observed
    into it yet (unlike :func:`histogram`, never creates one)."""
    return _HISTOGRAMS.get(name)


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


def _prom_name(name: str, suffix: str = "") -> str:
    base = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)
    if not base or not (base[0].isalpha() or base[0] == "_"):
        base = "_" + base
    return f"paddle_tpu_{base}{suffix}"


def escape_help(text: str) -> str:
    """Escape ``# HELP`` text per the exposition format: backslash and
    newline (double quotes are legal raw in help text)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(value: str) -> str:
    """Escape a label value per the exposition format: backslash, newline,
    and double quote."""
    return str(value).replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _help_lines(name: str, pn: str) -> List[str]:
    help_str = _HELP.get(name)
    return [f"# HELP {pn} {escape_help(help_str)}"] if help_str else []


def prometheus_text(prefix: str = "") -> str:
    """Every series (those whose name starts with ``prefix``) in the
    Prometheus text exposition format: counters with the ``_total`` suffix,
    gauges bare, histograms as ``<name>_seconds_bucket{le=...}``
    (cumulative), ``_sum`` and ``_count``; declared help text as
    ``# HELP``."""
    lines: List[str] = []
    for name in sorted(_COUNTERS):
        if not name.startswith(prefix):
            continue
        pn = _prom_name(name, "_total")
        lines.extend(_help_lines(name, pn))
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_COUNTERS[name]:g}")
    for name in sorted(_GAUGES):
        if not name.startswith(prefix):
            continue
        pn = _prom_name(name)
        lines.extend(_help_lines(name, pn))
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_GAUGES[name]:g}")
    for name in sorted(_HISTOGRAMS):
        if not name.startswith(prefix):
            continue
        h = _HISTOGRAMS[name]
        pn = _prom_name(name, "_seconds")
        lines.extend(_help_lines(name, pn))
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for bound, n in zip(h.bounds, h.bucket_counts):
            cum += n
            le = escape_label_value(f"{bound:g}")
            lines.append(f'{pn}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{pn}_sum {h.sum:g}")
        lines.append(f"{pn}_count {h.count}")
    return "\n".join(lines) + "\n"


def reset_all() -> None:
    """Test helper: clear every series (declared counters re-zero)."""
    _COUNTERS.clear()
    _GAUGES.clear()
    _HISTOGRAMS.clear()
    for name in _DECLARED_COUNTERS:
        _COUNTERS[name] = 0


# Pre-declared series, with the reference's names, so a scrape of an idle
# process shows the full surface at 0.
# The serving engine and scheduler. ``infer.compiles`` counts each engine's
# first dispatch of a new (program, shapes, dtypes) signature, where the port
# pays its cold build; the fleet's heartbeat exempts a tick in which it (or
# ``infer.aot_cache_hits``, 0 in the port: no AOT cache) moved.
SERVING_COUNTERS: Tuple[str, ...] = (
    "infer.compiles", "infer.runs",
    "infer.prefill_dispatches", "infer.decode_dispatches", "infer.tokens",
    "infer.prefill_chunk_dispatches",
    "infer.prefix_insert_dispatches", "infer.prefix_extract_dispatches",
    "infer.aot_cache_hits", "infer.aot_cache_stores",
    "serving.requests_submitted", "serving.requests_admitted",
    "serving.requests_completed", "serving.tokens_generated",
    "serving.requests_cancelled", "serving.deadline_exceeded",
    "serving.prefix_hits", "serving.prefix_misses",
    "serving.prefix_tokens_reused",
    "infer.spec_draft_tokens", "infer.spec_accepted_tokens",
)
# Serving-fleet tier (inference/fleet.py, procfleet.py, router.py):
# requeues counts in-flight requests replayed off dead replicas, sheds the
# admissions refused by queue-depth control, the routed_* pair splits
# placements by affinity and least load.
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
# The recommender workload (distributed/embedding.py, models/dlrm.py):
# ``embedding.lookups`` counts ShardedEmbedding forwards; ``rows_touched`` the
# unique rows of eager lookups (none inside a TrainStep, as the reference
# counts none in its compiled step); ``ids_exchanged`` and ``a2a_bytes`` a
# row-sharded lookup's ids and this rank's share of its exchange bytes (the
# ranks' counts sum to the reference's); ``rows_checkpointed`` the table rows
# EmbeddingCheckpointRotation publishes; ``recsys.steps`` and
# ``recsys.examples`` are bumped by the training driver.
RECSYS_COUNTERS: Tuple[str, ...] = (
    "recsys.steps", "recsys.examples",
    "embedding.lookups", "embedding.ids_exchanged", "embedding.a2a_bytes",
    "embedding.rows_touched", "embedding.rows_checkpointed",
)
# The observability plane's own cost (trace, flight recorder, run-log
# rotation and GC, measured step times, the /metrics exporter).
OBS_COUNTERS: Tuple[str, ...] = (
    "trace.traces", "trace.spans",
    "flightrec.dumps",
    "runlog.rotations", "runlog.gc_removed",
    "measured.persists",
    "exporter.requests", "exporter.bind_failures",
)
# The judgment layer (slo.py, regress.py): the monitor's passes and
# violations, the burn-rate alert ledger split by severity, and the
# perf-regression sentinel.
SLO_COUNTERS: Tuple[str, ...] = (
    "slo.evaluations", "slo.violations",
    "alerts.fired", "alerts.cleared", "alerts.page", "alerts.warn",
    "regress.checks", "regress.regressions", "regress.cleared",
    "regress.flightrecs",
)
# The input pipeline and the training loop (io/, hapi/), as the reference
# emits them: the DataLoader's counters and its spans (each a histogram of
# the same name), hapi's ``hapi.step`` histogram (a fit step's wall time,
# ``paddle_tpu/observability/metrics.py:364``) and the ``hapi.<log key>``
# gauges of ``MetricsLogger`` (``loss`` and ``lr`` always, a metric's name
# when metrics are set). Not declared at 0: the reference declares none of
# them, and an idle scrape stays byte for byte the reference's.
DATALOADER_COUNTERS: Tuple[str, ...] = (
    "dataloader.batches", "dataloader.device_puts", "dataloader.bad_batches",
)
DATALOADER_SPANS: Tuple[str, ...] = (
    "dataloader.fetch", "dataloader.prefetch", "dataloader.device_put",
)
HAPI_HISTOGRAMS: Tuple[str, ...] = ("hapi.step",)
HAPI_GAUGES: Tuple[str, ...] = ("hapi.loss", "hapi.lr")
# ...and the runtime sanitizer's ledger-growth trips (analysis/sanitizer.py)
for _name in (SERVING_COUNTERS + FLEET_COUNTERS + INGRESS_COUNTERS + RECSYS_COUNTERS
              + OBS_COUNTERS + SLO_COUNTERS + ("sanitizer.ledger_growth",)):
    declare_counter(_name)
del _name


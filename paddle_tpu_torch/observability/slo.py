"""Declarative SLO engine: objectives, error budgets, burn-rate alerts (a
copy of ``paddle_tpu/observability/slo.py``: the same specs, windows, state
docs and ``alert`` events, so either package's tools read the other's).

The runtime's counters, gauges, histograms and run-log events make it
*collectable*; this module is the judgment layer on top: a declarative :class:`SLO` spec names a service
level indicator (a selector over the lock-free metrics registries or the
run-log event ring) and an objective (``ttft_p50_ms <= 50``,
``deadline_rate <= 1%``); an :class:`SLOMonitor` evaluates the registered
spec set on a cadence, tracks each SLO's error budget, and fires
**multi-window burn-rate alerts**:

- the **fast window** (~5 min, ``FLAGS_slo_fast_window_s``) is the page
  signal: a burn rate at or above the spec's ``page_burn`` sustained over
  it means the error budget is being spent fast enough to exhaust within
  days — someone should look *now*;
- the **slow window** (~1 h, ``FLAGS_slo_slow_window_s``) is the warn
  signal and — for ratio SLOs — the second gate of the page condition
  (the classic two-window rule: a burst must ALSO have moved the long
  window before it pages, so a 10-second blip cannot page). Value SLOs
  (percentile/gauge objectives) page on the fast window alone: a long
  window dilutes a latency spike into the median and would suppress
  exactly the alert the spike warrants.

Firing and clearing are **structured events**: an ``alert`` run-log event
(slo, severity, sli, objective, burn rates, budget) plus ``alerts.*`` /
``slo.*`` counters, surfaced live by the exporter's ``/alerts`` endpoint;
``/healthz`` reports ``degraded`` (HTTP 503) while any page-severity
alert is firing so a load balancer can rotate the process out.

Evaluation is **host-side and sync-free**: one pass reads counter/gauge
floats and histogram bucket-count lists out of the registries under the
GIL, appends one snapshot to a bounded ring, and compares windowed deltas
— never a device sync, never a lock. The tick-loop hooks
(:func:`on_tick` from the scheduler/fleet/procfleet loops and
``TrainStep.run_steps``) are a single flag check until ``FLAGS_slo``
installs the default spec set.

Default spec sets (:func:`default_specs`) cover serving (TTFT / latency /
shed / deadline / speculative acceptance), training (bad-step / rollback /
AMP skip) and runtime health (recompile churn, host transfers, heartbeat
staleness), the reference's set name for name.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..framework.flags import flag
from . import metrics, runlog

__all__ = ["SLO", "SLOMonitor", "default_specs", "install", "installed",
           "uninstall", "on_tick"]

# burn-rate defaults: ratio SLOs use the SRE-workbook page threshold
# (14.4x burns a 30-day budget in ~2 days) with a 3x slow-window gate;
# value SLOs (latency percentiles, gauges) use multiples of the objective
_RATIO_PAGE_BURN = 14.4
_RATIO_WARN_BURN = 3.0
_VALUE_PAGE_BURN = 2.0
_VALUE_WARN_BURN = 1.0


def _as_tuple(x) -> Tuple[str, ...]:
    if x is None:
        return ()
    if isinstance(x, str):
        return (x,)
    return tuple(x)


class SLO:
    """One service-level objective: an indicator selector + a target.

    ``kind`` picks the selector:

    - ``"ratio"`` — bad events / total events over the window, from
      counter deltas (``counter_bad`` / ``counter_total``, each one name
      or a tuple summed). Objective is the allowed bad fraction
      (``threshold``); burn rate = observed rate / allowed rate.
    - ``"percentile"`` — percentile ``q`` of ``histogram`` over the
      window (bucket-count deltas), times ``scale`` (1e3 renders seconds
      as ms). Burn rate = SLI / threshold (``<=``) or threshold / SLI
      (``>=``).
    - ``"gauge"`` — the gauge's current value; inactive while unset.
    - ``"events"`` — percentile ``q`` of ``field`` over run-log ring
      events of kind ``event`` within the window, times ``scale``.

    An SLO with no data in the window is **inactive**: no SLI, no alert,
    no budget spend. ``min_count`` (ratio kind) requires that many total
    events in the fast window before the spec can fire — recompile churn
    is 100% at step one by construction and must not page a cold start.
    """

    def __init__(self, name: str, kind: str, *, threshold: float,
                 op: str = "<=", description: str = "",
                 counter_bad=None, counter_total=None,
                 histogram: Optional[str] = None, q: float = 50.0,
                 scale: float = 1.0, gauge: Optional[str] = None,
                 event: Optional[str] = None, field: Optional[str] = None,
                 min_count: int = 1, budget: Optional[float] = None,
                 page_burn: Optional[float] = None,
                 warn_burn: Optional[float] = None,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None):
        if kind not in ("ratio", "percentile", "gauge", "events"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if op not in ("<=", ">="):
            raise ValueError(f"SLO op must be '<=' or '>=', got {op!r}")
        self.name = name
        self.kind = kind
        self.op = op
        self.threshold = float(threshold)
        self.description = description
        self.counter_bad = _as_tuple(counter_bad)
        self.counter_total = _as_tuple(counter_total)
        self.histogram = histogram
        self.q = float(q)
        self.scale = float(scale)
        self.gauge = gauge
        self.event = event
        self.field = field
        self.min_count = int(min_count)
        ratio = kind == "ratio"
        # allowed bad fraction backing the error budget: the threshold
        # itself for ratio SLOs; for value SLOs, the allowed fraction of
        # evaluation passes that may violate the objective
        self.budget = float(budget) if budget is not None else (
            self.threshold if ratio else 0.1)
        self.page_burn = float(page_burn) if page_burn is not None else (
            _RATIO_PAGE_BURN if ratio else _VALUE_PAGE_BURN)
        self.warn_burn = float(warn_burn) if warn_burn is not None else (
            _RATIO_WARN_BURN if ratio else _VALUE_WARN_BURN)
        # ratio pages gate on the slow window too (two-window rule);
        # value SLOs page on the fast window alone — see module docstring
        self.page_slow_gate = self.warn_burn if ratio else 0.0
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s

    @property
    def objective(self) -> str:
        return f"{self.name} {self.op} {self.threshold:g}"

    def series(self) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        """(counter names, histogram names) this spec snapshots."""
        return (self.counter_bad + self.counter_total,
                (self.histogram,) if self.histogram else ())

    def _burn(self, sli: float) -> float:
        """Violation pressure: 1.0 = exactly at the objective."""
        if self.kind == "ratio":
            return sli / self.budget if self.budget > 0 else math.inf
        if self.op == "<=":
            return sli / self.threshold if self.threshold > 0 else math.inf
        return self.threshold / sli if sli > 0 else math.inf

    def violated(self, sli: float) -> bool:
        return sli > self.threshold if self.op == "<=" else sli < self.threshold


class _SLOState:
    """Per-SLO mutable evaluation state inside one monitor."""

    __slots__ = ("spec", "severity", "since", "sli", "burn_fast",
                 "burn_slow", "bad_total", "total_total", "violations",
                 "evaluations")

    def __init__(self, spec: SLO):
        self.spec = spec
        self.severity: Optional[str] = None
        self.since: Optional[float] = None
        self.sli: Optional[float] = None
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.bad_total = 0.0     # cumulative since install (ratio kinds)
        self.total_total = 0.0
        self.violations = 0      # cumulative violating evals (value kinds)
        self.evaluations = 0

    def budget_remaining(self) -> float:
        """Unspent fraction of the error budget since the monitor
        installed (1.0 = untouched, 0.0 = exhausted)."""
        spec = self.spec
        if spec.kind == "ratio":
            if self.total_total <= 0:
                return 1.0
            used = self.bad_total / (spec.budget * self.total_total)
        else:
            if self.evaluations <= 0:
                return 1.0
            used = (self.violations / self.evaluations) / spec.budget
        return max(0.0, 1.0 - used)


class SLOMonitor:
    """Evaluates a spec set on a cadence and manages burn-rate alerts.

    One ``evaluate`` pass snapshots the referenced series, computes each
    spec's SLI over the fast and slow windows, updates error budgets, and
    drives the per-SLO alert state machine (fire / escalate / clear) —
    each transition is an ``alert`` run-log event plus counters. A
    :class:`~.regress.RegressionSentinel` rides the same cadence when
    attached (the default under :func:`install`).
    """

    def __init__(self, specs: Optional[Sequence[SLO]] = None, *,
                 eval_every_s: Optional[float] = None,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None,
                 history: int = 2048):
        self.specs: Dict[str, SLO] = {}
        self._states: Dict[str, _SLOState] = {}
        self.eval_every_s = float(
            eval_every_s if eval_every_s is not None
            else flag("FLAGS_slo_eval_every_s"))
        self.fast_window_s = float(
            fast_window_s if fast_window_s is not None
            else flag("FLAGS_slo_fast_window_s"))
        self.slow_window_s = float(
            slow_window_s if slow_window_s is not None
            else flag("FLAGS_slo_slow_window_s"))
        # snapshot ring: (ts, {counter: value}, {hist: (count, bucket_counts)})
        self._history: deque = deque(maxlen=int(history))
        self._last_eval: Optional[float] = None
        self._baseline: Optional[tuple] = None
        self.regress = None  # RegressionSentinel, attached by install()
        for spec in (specs if specs is not None else []):
            self.register(spec)

    # ------------------------------------------------------------ spec set
    def register(self, spec: SLO) -> SLO:
        self.specs[spec.name] = spec
        self._states[spec.name] = _SLOState(spec)
        return spec

    def unregister(self, name: str) -> None:
        self.specs.pop(name, None)
        self._states.pop(name, None)

    # ----------------------------------------------------------- snapshots
    def _snapshot(self, now: float) -> tuple:
        counters_needed: set = set()
        hists_needed: set = set()
        for spec in self.specs.values():
            cs, hs = spec.series()
            counters_needed.update(cs)
            hists_needed.update(hs)
        c = {name: metrics.counter_value(name) for name in counters_needed}
        h = {}
        for name in hists_needed:
            hist = metrics.find_histogram(name)
            if hist is not None:
                h[name] = (hist.count, tuple(hist.bucket_counts))
        return (now, c, h)

    def _at_window(self, now: float, window_s: float) -> Optional[tuple]:
        """The newest snapshot at least ``window_s`` old (else the oldest
        available — windows are capped at the observed history)."""
        best = None
        for snap in self._history:
            if snap[0] <= now - window_s:
                best = snap
            else:
                break
        if best is None and self._history:
            best = self._history[0]
        return best

    # ---------------------------------------------------------- indicators
    @staticmethod
    def _counter_delta(cur: tuple, old: tuple, names: Tuple[str, ...]) -> float:
        c_cur, c_old = cur[1], old[1]
        return sum(c_cur.get(n, 0.0) - c_old.get(n, 0.0) for n in names)

    @staticmethod
    def _hist_delta_percentile(cur: tuple, old: tuple, name: str,
                               q: float) -> Optional[float]:
        entry = cur[2].get(name)
        if entry is None:
            return None
        live = metrics.find_histogram(name)
        if live is None:
            return None
        old_entry = old[2].get(name, (0, (0,) * len(entry[1])))
        h = metrics.Histogram(live.bounds)
        h.bucket_counts = [c - o for c, o in zip(entry[1], old_entry[1])]
        h.count = max(0, entry[0] - old_entry[0])
        # min/max/overflow_min stay non-finite: a delta histogram never
        # observed values, so percentile() interpolates on bucket bounds
        # alone (the overflow-anchor satellite fix makes that well-defined)
        return h.percentile(q)

    def _event_percentile(self, spec: SLO, now: float,
                          window_s: float) -> Tuple[Optional[float], int]:
        cutoff = now - window_s
        vals = [float(e[spec.field]) for e in runlog.monitor().events(spec.event)
                if e.get("ts", 0.0) >= cutoff and e.get(spec.field) is not None]
        if not vals:
            return None, 0
        vals.sort()
        idx = min(len(vals) - 1, max(0, int(round(
            (spec.q / 100.0) * (len(vals) - 1)))))
        return vals[idx], len(vals)

    def _sli(self, spec: SLO, cur: tuple, now: float,
             window_s: float) -> Tuple[Optional[float], float]:
        """(SLI over the window or None when inactive, total event count
        backing it — ratio denominators for min_count gating)."""
        old = self._at_window(now, window_s)
        if old is None:
            old = cur
        if spec.kind == "ratio":
            total = self._counter_delta(cur, old, spec.counter_total)
            if total <= 0:
                return None, 0.0
            bad = self._counter_delta(cur, old, spec.counter_bad)
            return max(0.0, bad) / total, total
        if spec.kind == "percentile":
            p = self._hist_delta_percentile(cur, old, spec.histogram, spec.q)
            return (None, 0.0) if p is None else (p * spec.scale, 1.0)
        if spec.kind == "gauge":
            v = metrics.gauge_value(spec.gauge)
            return (None, 0.0) if v is None else (float(v) * spec.scale, 1.0)
        p, n = self._event_percentile(spec, now, window_s)
        return (None, 0.0) if p is None else (p * spec.scale, float(n))

    # ----------------------------------------------------------- evaluation
    def maybe_evaluate(self, now: Optional[float] = None) -> Optional[dict]:
        """Cadence-gated :meth:`evaluate` — the tick-loop hook. One time
        read + compare when not due."""
        t = time.time() if now is None else now
        if self._last_eval is not None and t - self._last_eval < self.eval_every_s:
            return None
        return self.evaluate(t)

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One full evaluation pass; returns ``{slo: state-doc}``."""
        t0 = time.perf_counter()
        now = time.time() if now is None else now
        self._last_eval = now
        cur = self._snapshot(now)
        if self._baseline is None:
            self._baseline = cur
        out: Dict[str, dict] = {}
        firing = page = 0
        for name, spec in self.specs.items():
            st = self._states[name]
            fast_w = spec.fast_window_s or self.fast_window_s
            slow_w = spec.slow_window_s or self.slow_window_s
            sli_fast, n_fast = self._sli(spec, cur, now, fast_w)
            sli_slow, _ = self._sli(spec, cur, now, slow_w)
            st.sli = sli_fast
            if sli_fast is None:
                st.burn_fast = st.burn_slow = 0.0
                self._transition(st, None, now)
            else:
                st.evaluations += 1
                st.burn_fast = spec._burn(sli_fast)
                st.burn_slow = spec._burn(sli_slow) if sli_slow is not None else 0.0
                if spec.violated(sli_fast):
                    st.violations += 1
                    metrics.counter_inc("slo.violations")
                if spec.kind == "ratio":
                    st.bad_total = self._counter_delta(
                        cur, self._baseline, spec.counter_bad)
                    st.total_total = self._counter_delta(
                        cur, self._baseline, spec.counter_total)
                active = spec.kind != "ratio" or n_fast >= spec.min_count
                sev = None
                if active:
                    if (st.burn_fast >= spec.page_burn
                            and st.burn_slow >= spec.page_slow_gate):
                        sev = "page"
                    elif max(st.burn_fast, st.burn_slow) >= spec.warn_burn:
                        sev = "warn"
                self._transition(st, sev, now)
            if st.severity is not None:
                firing += 1
                if st.severity == "page":
                    page += 1
            out[name] = self._state_doc(st)
        self._history.append(cur)
        # trim beyond the slow window (plus slack for the window lookup)
        horizon = now - self.slow_window_s - 2 * self.eval_every_s
        while len(self._history) > 2 and self._history[0][0] < horizon:
            self._history.popleft()
        metrics.counter_inc("slo.evaluations")
        metrics.gauge_set("slo.firing", firing)
        metrics.gauge_set("slo.firing_page", page)
        if self.regress is not None:
            self.regress.maybe_check(now)
        metrics.observe("slo.eval_seconds", time.perf_counter() - t0)
        return out

    def _transition(self, st: _SLOState, sev: Optional[str],
                    now: float) -> None:
        if sev == st.severity:
            return
        prev, st.severity = st.severity, sev
        if sev is not None:
            if prev is None:
                st.since = now
                metrics.counter_inc("alerts.fired")
            metrics.counter_inc("alerts.page" if sev == "page" else "alerts.warn")
            runlog.emit("alert", component="slo", slo=st.spec.name,
                        state="firing", severity=sev, previous=prev,
                        objective=st.spec.objective, sli=st.sli,
                        burn_fast=st.burn_fast, burn_slow=st.burn_slow,
                        budget_remaining=st.budget_remaining(),
                        since=st.since)
        else:
            metrics.counter_inc("alerts.cleared")
            runlog.emit("alert", component="slo", slo=st.spec.name,
                        state="cleared", severity=prev,
                        objective=st.spec.objective, sli=st.sli,
                        burn_fast=st.burn_fast, burn_slow=st.burn_slow,
                        budget_remaining=st.budget_remaining(),
                        since=st.since)
            st.since = None

    def _state_doc(self, st: _SLOState) -> dict:
        return {"slo": st.spec.name, "kind": st.spec.kind,
                "objective": st.spec.objective, "sli": st.sli,
                "severity": st.severity, "since": st.since,
                "burn_fast": st.burn_fast, "burn_slow": st.burn_slow,
                "budget_remaining": st.budget_remaining(),
                "description": st.spec.description}

    # ------------------------------------------------------------ surfaces
    def states(self) -> List[dict]:
        """Every spec's latest state doc (firing or not) — the watch
        console's per-SLO table."""
        return [self._state_doc(st) for st in self._states.values()]

    def alerts(self) -> List[dict]:
        """Currently-firing alerts (the /alerts contract rows)."""
        return [self._state_doc(st) for st in self._states.values()
                if st.severity is not None]

    def health_probe(self) -> dict:
        """ok=False (degraded /healthz) while any page-severity alert —
        SLO or critical perf regression — is firing."""
        page = [st.spec.name for st in self._states.values()
                if st.severity == "page"]
        if self.regress is not None:
            page += [a["fingerprint"] for a in self.regress.alerts()
                     if a.get("severity") == "critical"]
        firing = [st.spec.name for st in self._states.values()
                  if st.severity is not None]
        return {"ok": not page, "firing": firing, "page": page}


# ------------------------------------------------------- default spec sets
def default_specs() -> List[SLO]:
    """The shipped spec set: serving, training, runtime health, as the
    reference ships it (a test holds the two sets equal)."""
    dispatch_total = ("train_step.dispatches", "executor.runs", "infer.runs")
    return [
        # ------------------------------------------------------- serving
        SLO("serving.ttft_p50_ms", "percentile", threshold=50.0,
            histogram="serving.ttft_seconds", q=50, scale=1e3,
            description="median time-to-first-token"),
        SLO("serving.latency_p99_ms", "percentile", threshold=500.0,
            histogram="serving.latency_seconds", q=99, scale=1e3,
            description="p99 end-to-end request latency"),
        SLO("serving.shed_rate", "ratio", threshold=0.01,
            counter_bad="fleet.sheds",
            counter_total=("fleet.requests_submitted", "fleet.sheds"),
            min_count=5, description="admission-control load sheds"),
        SLO("serving.deadline_rate", "ratio", threshold=0.01,
            counter_bad="serving.deadline_exceeded",
            counter_total=("serving.requests_completed",
                           "serving.requests_cancelled"),
            min_count=5, description="per-request deadline expiries"),
        SLO("serving.spec_acceptance", "gauge", threshold=0.5, op=">=",
            gauge="serving.spec_acceptance_rate",
            description="speculative-decoding draft acceptance"),
        SLO("ingress.reject_rate", "ratio", threshold=0.05,
            counter_bad=("ingress.rejected_overload",
                         "ingress.rejected_backpressure",
                         "ingress.rejected_draining"),
            counter_total=("ingress.requests",),
            min_count=5, description="front-door 429/503 rejections"),
        # ------------------------------------------------------ training
        SLO("train.bad_step_rate", "ratio", threshold=0.001,
            counter_bad="train_step.skipped", counter_total="train_step.steps",
            min_count=10, description="guard-skipped (non-finite) steps"),
        SLO("train.rollback_rate", "ratio", threshold=0.01,
            counter_bad="stability.rollbacks",
            counter_total="train_step.dispatches",
            min_count=10, description="divergence rollbacks"),
        SLO("train.amp_skip_rate", "ratio", threshold=0.01,
            counter_bad="amp.skipped_steps", counter_total="train_step.steps",
            min_count=10, description="loss-scaler skipped steps"),
        # ------------------------------------------------------- runtime
        SLO("runtime.recompile_churn", "ratio", threshold=0.05,
            counter_bad=("train_step.compiles", "executor.compiles",
                         "infer.compiles"),
            counter_total=dispatch_total, min_count=20,
            description="compiles per dispatch past warm-up"),
        SLO("runtime.host_transfer_rate", "ratio", threshold=0.001,
            counter_bad="sanitizer.host_transfers",
            counter_total=dispatch_total, min_count=20,
            description="sanitizer-caught device->host transfers"),
        SLO("runtime.heartbeat_staleness_s", "gauge", threshold=10.0,
            gauge="fleet.heartbeat_staleness_seconds",
            description="age of the stalest alive replica heartbeat"),
    ]


# -------------------------------------------------------- process plumbing
_INSTALLED: Optional[SLOMonitor] = None


def install(specs: Optional[Sequence[SLO]] = None,
            with_regress: bool = True, **kw) -> SLOMonitor:
    """Install ``specs`` (default: :func:`default_specs`) as the
    process-global monitor: tick loops feed it, the exporter surfaces its
    alerts (``/alerts``) and health (``/healthz`` degrades on page)."""
    global _INSTALLED
    mon = SLOMonitor(specs if specs is not None else default_specs(), **kw)
    if with_regress:
        from . import regress as _regress

        mon.regress = _regress.RegressionSentinel()
    from . import exporter as _exporter

    _exporter.register_health("slo", mon.health_probe)
    _exporter.register_alerts("slo", mon.alerts)
    if mon.regress is not None:
        _exporter.register_alerts("regress", mon.regress.alerts)
    _INSTALLED = mon
    return mon


def installed() -> Optional[SLOMonitor]:
    return _INSTALLED


def uninstall() -> None:
    """Detach the process-global monitor (test teardown)."""
    global _INSTALLED
    from . import exporter as _exporter

    _exporter.unregister_health("slo")
    _exporter.unregister_alerts("slo")
    _exporter.unregister_alerts("regress")
    _INSTALLED = None


def on_tick(now: Optional[float] = None) -> Optional[dict]:
    """The tick-loop hook: a single flag check until ``FLAGS_slo``
    installs the default spec set, then a cadence-gated evaluate."""
    mon = _INSTALLED
    if mon is None:
        if not flag("FLAGS_slo"):
            return None
        mon = install()
    return mon.maybe_evaluate(now)

"""Perf-regression sentinel: robust drift detection over measured history
(a copy of ``paddle_tpu/observability/regress.py``).

A :class:`RegressionSentinel` periodically

- scans every ``measured/`` doc (merged across pid shards) and tests the
  newest samples of ``recent_step_seconds`` against the baseline before
  them, and
- samples live serving rates off the counter registry
  (``decode_tokens_per_sec`` = Δ``infer.tokens``/Δt, ``dispatches_per_token``
  = Δ``infer.decode_dispatches``/Δ``infer.tokens``) into its own history
  ring and tests those the same way.

The test is a **median + MAD modified z-score** — robust to the outliers
step-time samples always carry (GCs, straggler ticks): with baseline
median *m* and MAD *s*, the tail median *t* regresses when
``0.6745*(t-m)/s >= z`` (default 3.5) AND the relative shift clears
``min_shift`` (default 10%) — both gates, so a microscopic-but-consistent
drift doesn't fire and a single wild sample doesn't either. The MAD is
floored at 1% of the baseline median so identical-sample baselines
stay finite and deterministic.

Each regression fires **once** per fingerprint while the drift persists
(an active ledger dedupes re-scans — a doctored 2x doc trips exactly one
alert) as a ``perf_regression`` run-log event naming the fingerprint and
the before/after numbers, plus ``regress.*`` counters, surfaced by the
exporter's ``/alerts``. A shift at or past ``critical_ratio`` (default
2x) is **critical** severity: it also dumps a flight record via the
existing :mod:`.flightrec` hook, so the metrics/ring context around the
regression is on disk before anyone asks. When the drift subsides the
entry clears (``state="cleared"`` event) and may fire again later.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Dict, List, Optional

from . import measured, metrics, runlog

__all__ = ["RegressionSentinel", "check_history", "mad_z"]

_MIN_SAMPLES = 12   # history shorter than this is never judged
_TAIL = 8           # newest samples judged against the baseline before them
_MAD_FLOOR = 0.01   # MAD floored at this fraction of the baseline median


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def mad_z(baseline: List[float], value: float) -> float:
    """Modified z-score of ``value`` against ``baseline``:
    ``0.6745 * (value - median) / MAD`` with the MAD floored at 1% of the
    median (identical-sample baselines stay finite)."""
    med = _median(baseline)
    mad = _median([abs(x - med) for x in baseline])
    mad = max(mad, abs(med) * _MAD_FLOOR, 1e-12)
    return 0.6745 * (value - med) / mad


def check_history(values: List[float], *, z: float = 3.5,
                  min_shift: float = 0.10,
                  worse: str = "up") -> Optional[dict]:
    """Drift verdict over a chronological sample history, or None.

    Splits ``values`` into baseline + newest-``_TAIL`` tail and compares
    medians; ``worse`` says which direction is a regression (``"up"`` for
    durations, ``"down"`` for throughputs)."""
    if len(values) < _MIN_SAMPLES:
        return None
    tail, base = values[-_TAIL:], values[:-_TAIL]
    before, after = _median(base), _median(tail)
    if before <= 0:
        return None
    signed = mad_z(base, after)
    if worse == "down":
        signed = -signed
        shift = (before - after) / before
        ratio = before / after if after > 0 else math.inf
    else:
        shift = (after - before) / before
        ratio = after / before
    if signed < z or shift < min_shift:
        return None
    # ratio is the direction-aware worsening factor (>= 1 when drifting):
    # slowdown factor for durations, speedup-loss factor for throughputs —
    # the number the critical_ratio severity gate compares against
    return {"before": before, "after": after, "shift": shift,
            "ratio": ratio, "z": signed, "samples": len(values)}


class RegressionSentinel:
    """Periodic drift checks over measured docs + live serving rates.

    Rides the :class:`~.slo.SLOMonitor` cadence when attached by
    ``slo.install()`` (``maybe_check`` gates on ``every_s``); standalone
    callers drive :meth:`check` directly. ``alerts()`` feeds the
    exporter's ``/alerts``; critical entries degrade ``/healthz`` through
    the SLO health probe.
    """

    def __init__(self, *, every_s: float = 30.0, z: float = 3.5,
                 min_shift: float = 0.10, critical_ratio: float = 2.0,
                 rate_history: int = 64):
        self.every_s = float(every_s)
        self.z = float(z)
        self.min_shift = float(min_shift)
        self.critical_ratio = float(critical_ratio)
        self._last_check: Optional[float] = None
        # active regressions: key -> alert doc (fire-once dedup ledger)
        self._active: Dict[str, dict] = {}
        self._rates: Dict[str, deque] = {
            "decode_tokens_per_sec": deque(maxlen=int(rate_history)),
            "dispatches_per_token": deque(maxlen=int(rate_history)),
        }
        self._last_sample: Optional[tuple] = None  # (ts, tokens, dispatches)

    # -------------------------------------------------------------- driving
    def maybe_check(self, now: Optional[float] = None) -> Optional[List[dict]]:
        t = time.time() if now is None else now
        if self._last_check is not None and t - self._last_check < self.every_s:
            return None
        return self.check(t)

    def check(self, now: Optional[float] = None) -> List[dict]:
        """One full pass: sample serving rates, scan every measured doc,
        fire/clear. Returns the alerts fired this pass."""
        now = time.time() if now is None else now
        self._last_check = now
        metrics.counter_inc("regress.checks")
        fired: List[dict] = []
        self._sample_rates(now)
        live: set = set()
        for fp in measured.fingerprints():
            doc = measured.load(fp)
            if not doc:
                continue
            key = f"measured/{fp}"
            verdict = check_history(
                [float(x) for x in doc.get("recent_step_seconds", [])],
                z=self.z, min_shift=self.min_shift)
            self._update(key, "measured", fp, verdict, "step_seconds",
                         now, fired, live)
        for rate, worse in (("decode_tokens_per_sec", "down"),
                            ("dispatches_per_token", "up")):
            verdict = check_history(list(self._rates[rate]), z=self.z,
                                    min_shift=self.min_shift, worse=worse)
            self._update(f"serving/{rate}", "serving_rate", rate, verdict,
                         rate, now, fired, live)
        for key in [k for k in self._active if k not in live]:
            self._clear(key, now)
        return fired

    # ------------------------------------------------------------- plumbing
    def _sample_rates(self, now: float) -> None:
        tokens = metrics.counter_value("infer.tokens")
        dispatches = metrics.counter_value("infer.decode_dispatches")
        if self._last_sample is not None:
            t0, tok0, dis0 = self._last_sample
            dt, dtok, ddis = now - t0, tokens - tok0, dispatches - dis0
            if dt > 0 and dtok > 0:
                self._rates["decode_tokens_per_sec"].append(dtok / dt)
                self._rates["dispatches_per_token"].append(ddis / dtok)
        self._last_sample = (now, tokens, dispatches)

    def _update(self, key: str, kind: str, fingerprint: str,
                verdict: Optional[dict], unit: str, now: float,
                fired: List[dict], live: set) -> None:
        if verdict is None:
            return  # not drifting (an active entry not in `live` clears)
        live.add(key)
        if key in self._active:
            return  # fire-once while the drift persists
        severity = ("critical" if verdict["ratio"] >= self.critical_ratio
                    else "warn")
        alert = {"kind": kind, "fingerprint": fingerprint, "unit": unit,
                 "severity": severity, "since": now, **verdict}
        self._active[key] = alert
        fired.append(alert)
        metrics.counter_inc("regress.regressions")
        runlog.emit("perf_regression", component="regress", state="firing",
                    **alert)
        if severity == "critical":
            from . import flightrec as _flightrec

            metrics.counter_inc("regress.flightrecs")
            _flightrec.dump("perf_regression", fingerprint=fingerprint,
                            kind=kind, before=verdict["before"],
                            after=verdict["after"], shift=verdict["shift"])

    def _clear(self, key: str, now: float) -> None:
        alert = self._active.pop(key)
        metrics.counter_inc("regress.cleared")
        runlog.emit("perf_regression", component="regress", state="cleared",
                    kind=alert["kind"], fingerprint=alert["fingerprint"],
                    severity=alert["severity"], since=alert["since"])

    # ------------------------------------------------------------- surfaces
    def alerts(self) -> List[dict]:
        """Currently-active regressions (the /alerts contract rows)."""
        return [dict(a, slo=None, state="firing") for a in self._active.values()]

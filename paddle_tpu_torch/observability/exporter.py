"""Live metrics export: a stdlib-only HTTP endpoint per process (a copy of
``paddle_tpu/observability/exporter.py``, with its paths and documents).

A long-lived process (a :class:`~..inference.fleet.ServingFleet` driver)
serves its metrics registry live instead of only writing a post-mortem run
log:

- ``GET /metrics``  — the Prometheus text exposition
  (:func:`.metrics.prometheus_text`);
- ``GET /healthz``  — JSON liveness: process pid/uptime plus every
  registered component health probe (fleet replica liveness); HTTP 200 + ``status: "ok"`` when all probes
  pass, 503 + ``status: "degraded"`` otherwise — the SLO monitor's probe
  degrades it while any page-severity alert fires, so a load balancer
  can rotate the process out before a human reads a dashboard;
- ``GET /alerts``   — JSON of the currently-firing alerts from every
  registered provider (the SLO engine's burn-rate alerts, the
  perf-regression sentinel), ``{"alerts": [...], "firing": n, "page": n}``;
- ``GET /snapshot`` — the full JSON metrics snapshot (counters, gauges,
  histogram summaries).

The server is ``http.server`` + a daemon thread — no dependencies, no
event loop, bounded cost (scrapes are rare; the handler renders on the
caller's thread). ``FLAGS_metrics_port`` gates it: 0 (the default) means
no server at all; tests construct :class:`MetricsExporter` directly with
``port=0`` to get an ephemeral OS-assigned port. When a TCPStore is at
hand, :func:`ensure_started` publishes the bound address under
``__obs__/<rank>/metrics_addr`` so peers/tooling discover scrape targets
through the rendezvous they already share.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from ..framework.flags import flag
from . import metrics

__all__ = ["MetricsExporter", "ensure_started", "register_health",
           "register_alerts", "current", "stop", "ADDR_KEY_PREFIX"]

ADDR_KEY_PREFIX = "__obs__"

# name -> zero-arg probe returning a JSON-able health doc; a probe that
# raises or returns {"ok": False, ...} degrades /healthz to 503.
_HEALTH: Dict[str, Callable[[], dict]] = {}
# name -> zero-arg provider returning the currently-firing alert docs
# (SLO engine, perf-regression sentinel); /alerts merges them all.
_ALERTS: Dict[str, Callable[[], list]] = {}
_EXPORTER: Optional["MetricsExporter"] = None
_START_TIME = time.time()


def register_health(name: str, probe: Callable[[], dict]) -> None:
    """Register (or replace) a component liveness probe aggregated by
    ``/healthz``. The probe returns a dict with at least ``ok``."""
    _HEALTH[name] = probe


def unregister_health(name: str) -> None:
    _HEALTH.pop(name, None)


def register_alerts(name: str, provider: Callable[[], list]) -> None:
    """Register (or replace) a firing-alerts provider merged into
    ``/alerts``. The provider returns a list of JSON-able alert docs,
    each with at least ``severity``."""
    _ALERTS[name] = provider


def unregister_alerts(name: str) -> None:
    _ALERTS.pop(name, None)


def _alerts_doc() -> dict:
    alerts = []
    for name, provider in list(_ALERTS.items()):
        try:
            for a in provider():
                alerts.append(dict(a, source=name))
        except Exception as exc:
            alerts.append({"source": name, "severity": "warn",
                           "error": f"{type(exc).__name__}: {exc}"})
    page = sum(1 for a in alerts
               if a.get("severity") in ("page", "critical"))
    return {"ts": time.time(), "pid": os.getpid(),
            "firing": len(alerts), "page": page, "alerts": alerts}


def _health_doc() -> dict:
    components = {}
    ok = True
    for name, probe in list(_HEALTH.items()):
        try:
            doc = probe()
        except Exception as exc:
            doc = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        if not doc.get("ok", True):
            ok = False
        components[name] = doc
    return {"ok": ok, "status": "ok" if ok else "degraded",
            "pid": os.getpid(),
            "uptime_seconds": time.time() - _START_TIME,
            "components": components}


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - http.server API
        metrics.counter_inc("exporter.requests")
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = metrics.prometheus_text().encode()
            ctype, code = "text/plain; version=0.0.4; charset=utf-8", 200
        elif path == "/healthz":
            doc = _health_doc()
            body = (json.dumps(doc, default=repr) + "\n").encode()
            ctype, code = "application/json", 200 if doc["ok"] else 503
        elif path == "/alerts":
            body = (json.dumps(_alerts_doc(), default=repr) + "\n").encode()
            ctype, code = "application/json", 200
        elif path == "/snapshot":
            body = (json.dumps(metrics.snapshot(), default=repr) + "\n").encode()
            ctype, code = "application/json", 200
        else:
            body = b"not found\n"
            ctype, code = "text/plain", 404
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes must not spam stderr
        pass


class MetricsExporter:
    """One process's metrics endpoint: a ThreadingHTTPServer on localhost
    run by a daemon thread. ``port=0`` binds an ephemeral OS-assigned port
    (read it back from ``.port`` after :meth:`start`)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self.host = host
        self._requested_port = int(port)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self._server.server_address[1] if self._server else None

    @property
    def address(self) -> Optional[str]:
        return f"{self.host}:{self.port}" if self._server else None

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        self._server = ThreadingHTTPServer(
            (self.host, self._requested_port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="paddle-tpu-metrics",
            daemon=True)
        self._thread.start()
        from . import runlog as _runlog

        _runlog.emit("metrics_exporter", address=self.address)
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None


def current() -> Optional[MetricsExporter]:
    """The process-global exporter, if one was started."""
    return _EXPORTER


def ensure_started(store=None, rank: int = 0) -> Optional[MetricsExporter]:
    """Start the process-global exporter on ``FLAGS_metrics_port`` (no-op
    returning None when the flag is 0). Idempotent — runtime layers call
    this opportunistically. With a ``store``, the bound address is
    published under ``__obs__/<rank>/metrics_addr`` for discovery."""
    global _EXPORTER
    port = int(flag("FLAGS_metrics_port") or 0)
    if port <= 0:
        return None
    if _EXPORTER is None:
        exp = MetricsExporter(port)
        try:
            exp.start()
        except OSError:  # port taken (another local worker won) — not fatal
            metrics.counter_inc("exporter.bind_failures")
            return None
        _EXPORTER = exp
    if store is not None:
        try:
            store.set(f"{ADDR_KEY_PREFIX}/{int(rank)}/metrics_addr",
                      _EXPORTER.address)
        except Exception:
            pass
    return _EXPORTER


def stop() -> None:
    """Stop the process-global exporter (test teardown)."""
    global _EXPORTER
    if _EXPORTER is not None:
        _EXPORTER.stop()
        _EXPORTER = None

"""Runtime telemetry of the port (``paddle_tpu/observability``), host-side:

- :mod:`.metrics`: counters, gauges and bounded histograms, with the
  Prometheus text export (``prometheus_text``) and a JSON ``snapshot``;
- :mod:`.runlog`: the structured JSONL run log (``FLAGS_run_log_dir``);
- :mod:`.trace`: trace ids through the serving fleet, ``span`` events and
  the store clock sync behind merged timelines;
- :mod:`.flightrec`: the crash flight recorder;
- :mod:`.measured`: measured step times per plan fingerprint;
- :mod:`.exporter`: the stdlib HTTP ``/metrics``, ``/healthz``,
  ``/alerts`` and ``/snapshot`` endpoint (``FLAGS_metrics_port``);
- :mod:`.slo` and :mod:`.regress`: the judgment layer, SLO specs with
  multi-window burn-rate alerts and the perf-regression sentinel, armed
  by ``FLAGS_slo`` from the serving and training tick loops;
- :mod:`.spans`: timed sections (``span``), each a ``torch.profiler``
  range and a histogram, around the collectives.

Reading logs back: ``python -m paddle_tpu_torch.observability report
<run.jsonl>`` (``--merge <dir>`` fleet-wide), ``trace <dir> --out
trace.json`` and ``watch <dir> --once``. The reference's ``introspect``
(compiled-program cost capture) is not ported.
"""
from __future__ import annotations

from . import exporter, flightrec, measured, metrics, regress, runlog, slo, spans, trace  # noqa: F401
from .metrics import observe, prometheus_text, snapshot  # noqa: F401
from .runlog import Monitor, emit, monitor  # noqa: F401
from .spans import Span, span  # noqa: F401
from .trace import attach, new_trace_id, span_event, trace_span  # noqa: F401

__all__ = [
    "metrics", "runlog", "trace", "exporter", "flightrec", "measured", "slo", "regress", "spans",
    "Span", "span",
    "Monitor", "monitor", "emit", "observe", "snapshot", "prometheus_text",
    "new_trace_id", "attach", "trace_span", "span_event",
]

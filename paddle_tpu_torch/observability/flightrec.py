"""Crash flight recorder of the port (a copy of
``paddle_tpu/observability/flightrec.py``): a post-mortem artifact for runs
that never wrote a clean report.

The Monitor already keeps a bounded in-memory ring of recent run-log
events; the flight recorder snapshots that ring — plus the metrics
registry, the active trace context, and the triggering exception — into
``flightrec-<pid>.json`` the moment something fatal-shaped happens:

- a serving-fleet replica dies (``ChaosCrash``, heartbeat loss, a real
  tick fault, or a replica process's death) —
  ``ServingFleet._on_replica_death`` and
  ``ProcServingFleet._on_replica_death``.

The dump is written atomically (temp + rename) next to the run log
(``FLAGS_run_log_dir``; the system temp dir when unset, so an incident
always leaves an artifact), and the count per process is bounded — the
FIRST incidents matter most in a post-mortem, a requeue storm must not
turn the recorder into its own disk-filler. ``FLAGS_flightrec_events``
sizes the event tail (0 disables the recorder entirely).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional

from ..framework.flags import flag
from . import metrics
from . import runlog as _runlog
from . import trace as _trace

__all__ = ["dump", "dump_path", "reset"]

_MAX_DUMPS = 4
_dump_count = 0


def reset() -> None:
    """Test helper: re-arm the per-process dump budget."""
    global _dump_count
    _dump_count = 0


def dump_path(index: int = 0) -> str:
    """Where dump ``index`` lands: ``flightrec-<pid>.json`` for the first
    incident, ``flightrec-<pid>.<i>.json`` for the next ones."""
    d = flag("FLAGS_run_log_dir") or tempfile.gettempdir()
    suffix = "" if index == 0 else f".{index}"
    return os.path.join(d, f"flightrec-{os.getpid()}{suffix}.json")


def dump(reason: str, exc: Optional[BaseException] = None,
         **context: Any) -> Optional[str]:
    """Write one flight-recorder dump; returns its path, or None when the
    recorder is disabled or the per-process budget is spent. Never raises:
    the recorder runs inside failure paths — a full disk must not mask the
    original fault."""
    global _dump_count
    tail = int(flag("FLAGS_flightrec_events") or 0)
    if tail <= 0 or _dump_count >= _MAX_DUMPS:
        return None
    path = dump_path(_dump_count)
    _dump_count += 1
    doc: Dict[str, Any] = {
        "format": 1,
        "ts": time.time(),
        "pid": os.getpid(),
        "reason": reason,
        "trace": _trace.current_trace(),
        "context": {k: _jsonable(v) for k, v in context.items()},
        "events": _event_tail(tail),
        "metrics": metrics.snapshot(),
    }
    if exc is not None:
        doc["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": traceback.format_exception(type(exc), exc,
                                                    exc.__traceback__),
        }
    try:
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=_runlog._json_default)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        return None
    metrics.counter_inc("flightrec.dumps")
    _runlog.emit("flightrec", reason=reason, path=path,
                 events=len(doc["events"]))
    return path


def _event_tail(tail: int) -> List[dict]:
    events = _runlog.monitor().events()
    return events[-tail:]


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)

"""Structured run log of the port (a copy of
``paddle_tpu/observability/runlog.py``): a JSONL event stream per process.

The :class:`Monitor` is the single sink every runtime layer reports to.
Each event is one JSON object per line::

    {"ts": <unix wall time>, "event": "<kind>", "step": <idx>, ...payload}

Event kinds emitted by the port's wired layers:

- ``run_start``    — first event of a sink file (pid, argv)
- ``request``      — the serving scheduler's request lifecycle
- ``fleet``        — the serving fleet's membership, placement, death,
                     requeue, shed, deadline and completion events
- ``ingress``      — the HTTP front door's requests, rejects and drain
- ``span``         — a trace span (observability/trace.py)
- ``clock_sync``   — a process's clock offset against rank 0
- ``flightrec``    — a flight-recorder dump was written
- ``chaos_inject`` — a deterministic fault fired (testing/chaos.py)

Gating: ``FLAGS_monitor`` (default on) switches every ``emit`` into a
single flag check; events are kept in a bounded in-memory ring always, and
mirrored to ``FLAGS_run_log_dir/run-<pid>.jsonl`` when that flag names a
directory. The file is line-buffered so a crashed run's log is complete up
to the crash — that is the point.

Growth is bounded two ways: ``FLAGS_run_log_max_mb`` rotates an
oversized ``run-<pid>.jsonl`` to ``run-<pid>.1.jsonl`` (one rotation
generation — the flight recorder covers deeper history), and opening a
sink GC's dead pids' stale logs beyond the newest ``FLAGS_run_log_keep``.
"""
from __future__ import annotations

import atexit
import json
import os
import re
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..framework.flags import flag

__all__ = ["Monitor", "monitor", "emit"]

_RUN_LOG_RE = re.compile(r"^run-(\d+)(?:\.1)?\.jsonl$")


def _pid_alive(pid: int) -> bool:
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - exists under another uid
        return True
    except OSError:
        return False
    return True


def _gc_stale_logs(d: str) -> int:
    """Delete dead pids' run logs under ``d`` beyond the newest
    ``FLAGS_run_log_keep`` (grouped per pid, ranked by mtime). Returns the
    number of files removed."""
    keep = int(flag("FLAGS_run_log_keep") or 0)
    if keep <= 0:
        return 0
    by_pid: Dict[int, List[str]] = {}
    try:
        names = os.listdir(d)
    except OSError:
        return 0
    for name in names:
        m = _RUN_LOG_RE.match(name)
        if m:
            by_pid.setdefault(int(m.group(1)), []).append(os.path.join(d, name))
    dead = []
    for pid, paths in by_pid.items():
        if _pid_alive(pid):
            continue
        try:
            mtime = max(os.path.getmtime(p) for p in paths)
        except OSError:
            mtime = 0.0
        dead.append((mtime, paths))
    dead.sort(reverse=True)
    removed = 0
    for _, paths in dead[keep:]:
        for p in paths:
            try:
                os.unlink(p)
                removed += 1
            except OSError:
                pass
    if removed:
        from . import metrics as _metrics

        _metrics.counter_inc("runlog.gc_removed", removed)
    return removed


class Monitor:
    """Append-only event sink: bounded in-memory ring + optional JSONL file."""

    def __init__(self, capacity: int = 4096):
        self._ring: deque = deque(maxlen=capacity)
        self._file = None
        self._dir: Optional[str] = None  # dir the open file belongs to
        self._bytes = 0                  # current sink size, drives rotation
        self.path: Optional[str] = None
        self.rotations = 0

    # ------------------------------------------------------------- plumbing
    def enabled(self) -> bool:
        return bool(flag("FLAGS_monitor"))

    def _sink(self):
        """The open line-buffered JSONL file for the current
        FLAGS_run_log_dir, or None. Re-opens when the flag changes."""
        d = flag("FLAGS_run_log_dir")
        if not d:
            if self._file is not None:
                self.close()
            return None
        if self._file is None or self._dir != d:
            self.close()
            os.makedirs(d, exist_ok=True)
            _gc_stale_logs(d)
            self.path = os.path.join(d, f"run-{os.getpid()}.jsonl")
            self._file = open(self.path, "a", buffering=1)
            self._dir = d
            try:
                self._bytes = os.path.getsize(self.path)
            except OSError:
                self._bytes = 0
            self._write({"ts": time.time(), "event": "run_start",
                         "pid": os.getpid(), "argv": list(sys.argv)})
        return self._file

    def _write(self, ev: dict):
        line = json.dumps(ev, default=_json_default) + "\n"
        self._file.write(line)
        self._bytes += len(line)
        max_mb = float(flag("FLAGS_run_log_max_mb") or 0)
        if max_mb > 0 and self._bytes > max_mb * (1 << 20):
            self._rotate()

    def _rotate(self):
        """``run-<pid>.jsonl`` → ``run-<pid>.1.jsonl`` (replacing any prior
        rotation) + a fresh sink. The merge CLI reads both generations."""
        path = self.path
        try:
            self._file.close()
        except OSError:
            pass
        self._file = None
        rotated = path[:-len(".jsonl")] + ".1.jsonl"
        try:
            os.replace(path, rotated)
        except OSError:
            rotated = None
        self._file = open(path, "a", buffering=1)
        self._bytes = 0
        self.rotations += 1
        from . import metrics as _metrics

        _metrics.counter_inc("runlog.rotations")
        self._write({"ts": time.time(), "event": "run_start",
                     "pid": os.getpid(), "argv": list(sys.argv),
                     "rotated_from": rotated, "rotation": self.rotations})

    # ----------------------------------------------------------------- API
    def emit(self, event: str, step: Optional[int] = None, **payload) -> None:
        """Record one event (no-op when FLAGS_monitor is off)."""
        if not self.enabled():
            return
        ev: Dict[str, Any] = {"ts": time.time(), "event": event}
        if step is not None:
            ev["step"] = int(step)
        if payload:
            ev.update(payload)
        self._ring.append(ev)
        try:
            if self._sink() is not None:
                self._write(ev)
        except OSError:  # a full/readonly disk must never kill the run
            pass

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """In-memory ring contents (newest last), optionally one kind."""
        if kind is None:
            return list(self._ring)
        return [e for e in self._ring if e["event"] == kind]

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
            self._dir = None

    def clear(self) -> None:
        """Test helper: drop ring events (the file, if any, keeps its lines)."""
        self._ring.clear()


def _json_default(o):
    """Arrays / numpy scalars in payloads degrade to plain Python."""
    try:
        import numpy as np

        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except ImportError:  # pragma: no cover
        pass
    if hasattr(o, "item"):
        try:
            return o.item()
        except Exception:
            pass
    return repr(o)


_MONITOR = Monitor()
atexit.register(_MONITOR.close)


def monitor() -> Monitor:
    """The process-global Monitor every runtime layer reports to."""
    return _MONITOR


def emit(event: str, step: Optional[int] = None, **payload) -> None:
    """Module-level shorthand for ``monitor().emit(...)``."""
    _MONITOR.emit(event, step, **payload)

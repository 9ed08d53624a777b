"""Measured step-time persistence, keyed by plan fingerprint (a copy of
``paddle_tpu/observability/measured.py``, with the same on-disk schema, so
either package reads the other's docs).

The reference's ``TrainStep.run_steps`` reports every dispatch of a plan
that its auto-parallel planner fingerprinted; the port has no planner yet,
so here only a caller that names a fingerprint records. Samples accumulate
under::

    FLAGS_compile_cache_dir/measured/<fingerprint>.<pid>.json

one JSON shard per (plan fingerprint, writer pid). ``record`` only ever
rewrites its *own* pid's shard (load-own, mutate, temp + atomic rename), so
two processes recording the same fingerprint never lose each other's
samples. ``load`` merges every shard (plus any legacy un-sharded
``<fingerprint>.json`` doc) into one document; the merged schema is the
contract::

    {"format": 1, "fingerprint": ..., "samples": <dispatch count>,
     "steps": <fused steps total>, "total_seconds": ...,
     "mean_step_seconds": ..., "recent_step_seconds": [... last 64 ...],
     "updated_unix": ...}

Writes are best effort: a read-only cache dir never fails a step. No-op
when ``FLAGS_compile_cache_dir`` is unset. The perf-regression sentinel
(:mod:`.regress`) reads these docs back; ``fingerprints()`` lists what is
on disk.
"""
from __future__ import annotations

import json
import os
import re
from typing import List, Optional

from ..framework.flags import flag

__all__ = ["record", "load", "path_for", "shard_paths", "fingerprints"]

_RECENT_KEEP = 64
_SHARD_RE = re.compile(r"^(?P<fp>.+)\.(?P<pid>\d+)\.json$")


def _measured_dir() -> Optional[str]:
    d = flag("FLAGS_compile_cache_dir")
    if not d:
        return None
    return os.path.join(str(d), "measured")


def path_for(fingerprint: str) -> Optional[str]:
    """Where ``fingerprint``'s legacy (un-sharded) measurement doc lives,
    or None when persistence is off (no compile cache dir). Current
    writers shard per pid — see :func:`shard_paths` for everything
    :func:`load` merges."""
    d = _measured_dir()
    if d is None:
        return None
    return os.path.join(d, f"{fingerprint}.json")


def _shard_path(fingerprint: str, pid: Optional[int] = None) -> Optional[str]:
    d = _measured_dir()
    if d is None:
        return None
    return os.path.join(d, f"{fingerprint}.{pid or os.getpid()}.json")


def shard_paths(fingerprint: str) -> List[str]:
    """Every on-disk doc holding samples for ``fingerprint``: the legacy
    combined ``<fp>.json`` (if an older writer left one) plus all per-pid
    ``<fp>.<pid>.json`` shards, sorted for determinism."""
    d = _measured_dir()
    if d is None:
        return []
    out = []
    legacy = os.path.join(d, f"{fingerprint}.json")
    if os.path.exists(legacy):
        out.append(legacy)
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in sorted(names):
        m = _SHARD_RE.match(name)
        if m and m.group("fp") == fingerprint:
            out.append(os.path.join(d, name))
    return out


def fingerprints() -> List[str]:
    """Distinct plan fingerprints with measurement docs on disk."""
    d = _measured_dir()
    if d is None:
        return []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    fps = set()
    for name in names:
        if not name.endswith(".json"):
            continue
        m = _SHARD_RE.match(name)
        fps.add(m.group("fp") if m else name[:-len(".json")])
    return sorted(fps)


def _read_doc(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if doc.get("format") == 1 else None


def load(fingerprint: str) -> Optional[dict]:
    """The merged measurement doc for ``fingerprint`` (all pid shards +
    any legacy combined doc), or None when nothing is persisted. Counts
    sum across shards; ``recent_step_seconds`` concatenates shard recents
    in ``updated_unix`` order and keeps the newest 64."""
    docs = [d for d in (_read_doc(p) for p in shard_paths(fingerprint)) if d]
    if not docs:
        return None
    docs.sort(key=lambda d: d.get("updated_unix", 0.0))
    merged = {
        "format": 1, "fingerprint": fingerprint,
        "samples": sum(int(d.get("samples", 0)) for d in docs),
        "steps": sum(int(d.get("steps", 0)) for d in docs),
        "total_seconds": sum(float(d.get("total_seconds", 0.0)) for d in docs),
        "updated_unix": max(float(d.get("updated_unix", 0.0)) for d in docs),
    }
    merged["mean_step_seconds"] = (
        merged["total_seconds"] / merged["steps"] if merged["steps"] else 0.0)
    recent: List[float] = []
    for d in docs:
        recent.extend(float(x) for x in d.get("recent_step_seconds", []))
    merged["recent_step_seconds"] = recent[-_RECENT_KEEP:]
    return merged


def record(fingerprint: Optional[str], seconds: float,
           k: int = 1) -> Optional[str]:
    """Fold one measured dispatch (``k`` fused steps over ``seconds``
    wall) into this process's shard of ``fingerprint``'s doc; returns the
    shard path written, or None when persistence is off. Never raises.
    Only the caller's own pid shard is rewritten, so concurrent writers
    never drop each other's samples."""
    if not fingerprint:
        return None
    path = _shard_path(fingerprint)
    if path is None:
        return None
    doc = _read_doc(path) or {
        "format": 1, "fingerprint": fingerprint, "samples": 0, "steps": 0,
        "total_seconds": 0.0, "recent_step_seconds": [],
    }
    k = max(1, int(k))
    doc["samples"] += 1
    doc["steps"] += k
    doc["total_seconds"] += float(seconds)
    doc["mean_step_seconds"] = doc["total_seconds"] / doc["steps"]
    recent = doc.get("recent_step_seconds", [])
    recent.append(float(seconds) / k)
    doc["recent_step_seconds"] = recent[-_RECENT_KEEP:]
    import time

    doc["updated_unix"] = time.time()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except OSError:
        return None
    from . import metrics

    metrics.counter_inc("measured.persists")
    return path

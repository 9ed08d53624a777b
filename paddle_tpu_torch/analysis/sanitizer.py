"""Runtime sanitizer of the port (``FLAGS_sanitize``): the host-ledger growth
sentinel of ``paddle_tpu/analysis/sanitizer.py``, with its names, counter
and run-log event.

:func:`note_ledger` is the runtime form of the reference's PTA305 static
pass: a per-request host ledger on a serving tick loop growing past its
bound warns once per ledger (raises :class:`LedgerGrowthError` under
``FLAGS_sanitize_strict``), bumps ``sanitizer.ledger_growth`` and emits a
``sanitizer`` run-log event. The in-process and the cross-process fleet
call it after their keep-last-k GC each tick.

That is all ``FLAGS_sanitize`` arms in the port. The reference's other
guards (the transfer guard, the recompile-churn sentinel and donated-state
poisoning, ``sanitizer.py:121-273``) are built on JAX's transfer guard,
traced signatures and donated buffers; they are not ported (ROADMAP.md,
Queue 1 item 15), and the flag's help text says so.
"""
from __future__ import annotations

import threading
import warnings
from typing import Dict, Tuple

from ..framework.flags import flag
from ..observability import runlog as _runlog
from ..observability.metrics import counter_inc

__all__ = ["enabled", "strict", "LedgerGrowthError", "note_ledger", "reset", "stats"]


def enabled() -> bool:
    return bool(flag("FLAGS_sanitize"))


def strict() -> bool:
    return bool(flag("FLAGS_sanitize_strict"))


class LedgerGrowthError(RuntimeError):
    """A per-request host ledger on a serving tick loop grew past its
    configured bound — the runtime form of the PTA305 static finding."""

    def __init__(self, component: str, ledger: str, size: int, bound: int):
        self.component = component
        self.ledger = ledger
        self.size = int(size)
        self.bound = int(bound)
        super().__init__(
            f"unbounded host-state growth at {component}.{ledger}: "
            f"{size} entries > bound {bound}. Delivered requests must be "
            f"GC'd past keep-last-k or the serving process leaks per-request "
            f"state forever.")


# (component, ledger) -> trips of the growth sentinel
_TRIPS: Dict[Tuple[str, str], int] = {}
_LOCK = threading.Lock()


def note_ledger(component: str, ledger: str, size: int, bound: int) -> None:
    """A per-request host ledger exceeding ``bound`` entries warns once per
    ledger (raises under ``FLAGS_sanitize_strict``). The fleets' keep-last-k
    GC keeps bounded ledgers far below this."""
    if not enabled() or bound <= 0 or size <= bound:
        return
    counter_inc("sanitizer.ledger_growth")
    key = (component, ledger)
    err = LedgerGrowthError(component, ledger, size, bound)
    with _LOCK:
        first = key not in _TRIPS
        _TRIPS[key] = _TRIPS.get(key, 0) + 1
    if first:
        _runlog.emit("sanitizer", kind="ledger_growth", component=component,
                     ledger=ledger, size=int(size), bound=int(bound))
    if strict():
        raise err
    warnings.warn(str(err), RuntimeWarning, stacklevel=3)


def reset() -> None:
    """Drop the ledger warn state (tests; a fresh serving process starts
    clean by construction)."""
    with _LOCK:
        _TRIPS.clear()


def stats() -> Dict[str, int]:
    """Growth-sentinel trips per ``component.ledger``. (The reference's
    ``stats`` counts compiled signatures per callsite, which the port's
    sanitizer does not track.)"""
    with _LOCK:
        return {f"{c}.{l}": n for (c, l), n in _TRIPS.items()}

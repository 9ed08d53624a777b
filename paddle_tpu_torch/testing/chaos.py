"""Deterministic fault injection of the port (a copy of
``paddle_tpu/testing/chaos.py``).

Production code calls the hooks below at its failure seams (in the port:
TCPStore ops, the checkpoint manager, the elastic supervisor and node, the
training step's NaN injection, and the serving fleet, its RPC transport and
its ingress).
With ``FLAGS_chaos`` off — the default — every hook is a single dict
lookup; tests turn individual failure modes on through flags (or the
``inject`` context manager) and get the *same* failure on every run:
no randomness, no timing races.

Injection points:

- **crash-at-step**: ``crash_if_due(point, step)`` raises ``ChaosCrash``
  when ``FLAGS_chaos_crash_point`` matches and ``FLAGS_chaos_crash_at_step``
  is the current step (-1 = first hit). Each (point, step) fires at most
  once per process, so a supervisor that restarts the step can make
  progress — exactly the preempted-worker shape.
- **corrupt-checkpoint-on-disk**: ``corrupt_due()`` tells the
  CheckpointManager to flip bytes in the checkpoint it just published.
- **drop/delay store ops**: ``store_op(op, key)`` raises ``ChaosError``
  for ops matching ``FLAGS_chaos_store_drop_ops`` ('op' or
  'op:key-prefix' specs), healing after ``FLAGS_chaos_store_drop_count``
  failures; ``FLAGS_chaos_store_delay_s`` adds latency to every op.
- **freeze heartbeat**: ``heartbeat_frozen(node_id)`` silences an
  elastic node's refresh thread (a zombie/partitioned host).
- **NaN gradients**: ``nan_grads_due()`` says when a train step should
  inject non-finite gradients (``FLAGS_chaos_nan_at_step``).
- **kill / slow a serving replica**: ``replica_kill_due(rid, tick)`` is
  True exactly once when ``FLAGS_chaos_replica_kill_at`` ('R:K') names
  replica R and it has served K decode ticks — the fleet turns it into a
  mid-stream replica death (drain + requeue); ``replica_slow_ms(rid)``
  reads ``FLAGS_chaos_replica_slow_ms`` ('MS' or 'R:MS') as per-tick
  injected latency (a straggler the heartbeat tracker must catch).
- **real-process replica faults** (the cross-process fleet):
  ``replica_sigkill_due(rid, tick)`` is True exactly once when
  ``FLAGS_chaos_replica_sigkill_at`` ('R:K') names replica R and the
  parent has harvested K of its tick messages — the ProcServingFleet
  supervisor answers True by sending the child a real SIGKILL (no
  exception, no cleanup: the kill -9 the requeue ledger must survive);
  ``replica_hang_due_ms(rid)`` reads ``FLAGS_chaos_replica_hang_ms``
  ('MS' or 'R:MS') exactly once as a heartbeat blackout — the child stays
  alive but stops beating for MS milliseconds (a zombie only the parent's
  stale-beat sweep can catch, since the process never exits).
- **network faults** (ingress + socket fast path):
  ``socket_drop_due(rid, nsent)`` is True exactly once when
  ``FLAGS_chaos_socket_drop_at`` ('R:K' or 'K') says the fast-path socket
  should die right before replica R's K-th socket send — the
  SocketChannel answers True by killing the connection, which must
  degrade to the store transport with zero chunk loss or duplication;
  ``ingress_disconnect_due(nchunks)`` is True exactly once per process
  when ``FLAGS_chaos_ingress_disconnect_at`` chunks have been streamed —
  the ingress answers True by dropping the client socket (the
  disconnect -> mid-decode cancel path); ``net_delay_ms()`` adds
  deterministic latency before every fast-path frame send.
"""
from __future__ import annotations

import contextlib
import time

from ..framework.flags import flag, get_flags, set_flags


class ChaosError(OSError):
    """Injected transient store failure (an OSError so production retry
    paths treat it exactly like a real socket error)."""


class ChaosCrash(RuntimeError):
    """Injected process death. Raised (not os._exit) so single-process
    tests can drive multi-process recovery protocols end-to-end."""


_fired: set = set()  # (point, step) crash points that already fired
_dropped: dict = {}  # drop spec -> count of failures injected so far


def _emit_inject(step=None, **payload):
    """Record the injected fault in the structured run log (chaos fires are
    exactly the events a postmortem wants timestamped)."""
    from ..observability import runlog

    runlog.emit("chaos_inject", step=step, **payload)


def reset():
    """Forget fired crash points and drop counters (fresh experiment)."""
    _fired.clear()
    _dropped.clear()


def enabled() -> bool:
    return bool(flag("FLAGS_chaos"))


def crash_if_due(point: str, step=None):
    """Raise ChaosCrash when ``point`` is armed (at most once per
    (point, step) per process)."""
    if not enabled() or flag("FLAGS_chaos_crash_point") != point:
        return
    at = flag("FLAGS_chaos_crash_at_step")
    if at >= 0 and step is not None and step != at:
        return
    # keyed by the ARMED step (not the current one) so '-1: first hit'
    # fires exactly once per point instead of once per visited step
    key = (point, at if at >= 0 else None)
    if key in _fired:
        return
    _fired.add(key)
    _emit_inject(kind="crash", point=point, step=step)
    raise ChaosCrash(f"chaos: injected crash at point {point!r} step {step}")


def corrupt_due() -> bool:
    return enabled() and bool(flag("FLAGS_chaos_corrupt_ckpt"))


def store_op(op: str, key: str):
    """Called by TCPStore before each wire op; may delay or fail it."""
    if not enabled():
        return
    delay = flag("FLAGS_chaos_store_delay_s")
    if delay > 0:
        time.sleep(delay)
    specs = [s for s in flag("FLAGS_chaos_store_drop_ops").split(",") if s]
    limit = flag("FLAGS_chaos_store_drop_count")
    for spec in specs:
        sop, _, prefix = spec.partition(":")
        if sop != op or (prefix and not key.startswith(prefix)):
            continue
        n = _dropped.get(spec, 0)
        if limit >= 0 and n >= limit:
            return  # healed: budget of injected failures spent
        _dropped[spec] = n + 1
        _emit_inject(kind="store_drop", op=op, key=key)
        raise ChaosError(f"chaos: dropped store op {op}({key!r}) "
                         f"[{n + 1}{'/' + str(limit) if limit >= 0 else ''}]")


def nan_grads_due():
    """``(step, n_steps)`` when the NaN-gradient injection is armed
    (FLAGS_chaos + FLAGS_chaos_nan_at_step >= 0), else None."""
    if not enabled():
        return None
    at = flag("FLAGS_chaos_nan_at_step")
    if at < 0:
        return None
    n = max(int(flag("FLAGS_chaos_nan_steps")), 1)
    _emit_inject(step=at, kind="nan_grads", n_steps=n)
    return int(at), n


def replica_kill_due(replica_id, tick) -> bool:
    """True — exactly once per (replica, process) — when
    ``FLAGS_chaos_replica_kill_at`` ('R:K') names ``replica_id`` and it has
    served at least K decode ticks. The serving fleet answers True with a
    :class:`ChaosCrash` replica death (mark dead, drain, requeue)."""
    if not enabled():
        return False
    spec = flag("FLAGS_chaos_replica_kill_at")
    if not spec:
        return False
    rid, _, at = spec.partition(":")
    if str(replica_id) != rid or int(tick) < int(at or 0):
        return False
    key = ("replica_kill", str(replica_id))
    if key in _fired:
        return False
    _fired.add(key)
    _emit_inject(kind="replica_kill", replica=replica_id, tick=int(tick))
    return True


def replica_sigkill_due(replica_id, tick) -> bool:
    """True — exactly once per (replica, process) — when
    ``FLAGS_chaos_replica_sigkill_at`` ('R:K') names ``replica_id`` and the
    parent supervisor has harvested at least K of its tick messages. The
    cross-process fleet answers True with a real ``SIGKILL`` to the child:
    no exception path, no drain — the process is simply gone, which is the
    failure the exactly-once requeue ledger exists for."""
    if not enabled():
        return False
    spec = flag("FLAGS_chaos_replica_sigkill_at")
    if not spec:
        return False
    rid, _, at = spec.partition(":")
    if str(replica_id) != rid or int(tick) < int(at or 0):
        return False
    key = ("replica_sigkill", str(replica_id))
    if key in _fired:
        return False
    _fired.add(key)
    _emit_inject(kind="replica_sigkill", replica=replica_id, tick=int(tick))
    return True


def replica_hang_due_ms(replica_id) -> float:
    """Heartbeat blackout in milliseconds — nonzero exactly once per
    (replica, process) — when ``FLAGS_chaos_replica_hang_ms`` ('MS' for
    every replica, 'R:MS' for one) names ``replica_id``. The subprocess
    replica answers a nonzero return by suppressing its heartbeat
    publications for that long WITHOUT exiting: process liveness stays
    green, only the stale-beat sweep can tell it's wedged."""
    if not enabled():
        return 0.0
    spec = flag("FLAGS_chaos_replica_hang_ms")
    if not spec:
        return 0.0
    rid, sep, ms = spec.partition(":")
    if sep:
        if str(replica_id) != rid:
            return 0.0
        ms = float(ms)
    else:
        ms = float(rid)
    key = ("replica_hang", str(replica_id))
    if ms <= 0 or key in _fired:
        return 0.0
    _fired.add(key)
    _emit_inject(kind="replica_hang", replica=replica_id, hang_ms=ms)
    return ms


def replica_slow_ms(replica_id) -> float:
    """Injected per-tick latency in milliseconds for ``replica_id``:
    ``FLAGS_chaos_replica_slow_ms`` is 'MS' (every replica) or 'R:MS' (one).
    0.0 when chaos is off or the spec names another replica."""
    if not enabled():
        return 0.0
    spec = flag("FLAGS_chaos_replica_slow_ms")
    if not spec:
        return 0.0
    rid, sep, ms = spec.partition(":")
    if not sep:
        return float(rid)
    return float(ms) if str(replica_id) == rid else 0.0


def socket_drop_due(replica_id, nsent) -> bool:
    """True — exactly once per (replica, process) — when
    ``FLAGS_chaos_socket_drop_at`` ('R:K' for replica R, bare 'K' for any
    replica) says the fast-path socket should die right before the K-th
    socket send. The SocketChannel writer answers True by killing its
    connection mid-stream — the degradation the store fallback must
    absorb without losing or duplicating a chunk."""
    if not enabled():
        return False
    spec = flag("FLAGS_chaos_socket_drop_at")
    if not spec:
        return False
    rid, sep, at = spec.partition(":")
    if sep:
        if str(replica_id) != rid:
            return False
        at = int(at or 0)
    else:
        at = int(rid)
    if int(nsent) < at:
        return False
    key = ("socket_drop", str(replica_id))
    if key in _fired:
        return False
    _fired.add(key)
    _emit_inject(kind="socket_drop", replica=replica_id, nsent=int(nsent))
    return True


def ingress_disconnect_due(nchunks) -> bool:
    """True — exactly once per process — when the ingress has streamed
    ``FLAGS_chaos_ingress_disconnect_at`` chunks to a client. The ingress
    answers True by force-closing the client socket, which must turn into
    a mid-decode ``cancel()`` that frees the slot."""
    if not enabled():
        return False
    at = int(flag("FLAGS_chaos_ingress_disconnect_at"))
    if at < 0 or int(nchunks) < at:
        return False
    key = ("ingress_disconnect",)
    if key in _fired:
        return False
    _fired.add(key)
    _emit_inject(kind="ingress_disconnect", chunks=int(nchunks))
    return True


def net_delay_ms() -> float:
    """Deterministic latency (milliseconds) injected before every
    fast-path socket frame send; 0.0 when chaos is off."""
    if not enabled():
        return 0.0
    return float(flag("FLAGS_chaos_net_delay_ms"))


def heartbeat_frozen(node_id) -> bool:
    if not enabled():
        return False
    frozen = flag("FLAGS_chaos_freeze_heartbeat")
    return frozen != "" and str(node_id) in frozen.split(",")


@contextlib.contextmanager
def inject(**overrides):
    """Temporarily set chaos flags (FLAGS_chaos is implied on), e.g.::

        with chaos.inject(FLAGS_chaos_store_drop_ops="get"):
            ...

    Restores previous flag values and resets counters on exit.
    """
    overrides.setdefault("FLAGS_chaos", True)
    prev = get_flags(list(overrides))
    reset()
    set_flags(overrides)
    try:
        yield
    finally:
        set_flags(prev)
        reset()

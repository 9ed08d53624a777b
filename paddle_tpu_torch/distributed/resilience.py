"""Fault-tolerant training runtime of the port
(``paddle_tpu/distributed/resilience.py``): checkpoints that survive torn
writes, store ops that survive transient failures, and a supervisor that
survives membership churn.

Parity: fleet/elastic/manager.py's HOLD -> RESTART protocol plus the
fault-tolerance the reference delegates to infra (etcd leases, k8s
restarts), rebuilt on the port's own primitives:

- **CheckpointManager** wraps ``checkpoint.save_state/load_state`` with
  write-to-temp-then-rename publication, a manifest carrying the step and
  per-leaf CRCs (``checkpoint.checksum_pytree``), keep-last-k rotation,
  and ``restore_latest`` that walks back past corrupt/truncated
  checkpoints to the newest one whose checksums verify. A ``TrainStep``
  is written whole (gathered over its mesh; world rank 0 writes) and
  restored onto its own mesh through the converter.
- **retry** decorates transient store/IO calls with bounded
  exponential-backoff retries. ``FLAGS_store_retry_jitter`` (default on)
  applies capped FULL jitter — uniform(0, cap) — seeded through
  ``framework.random.host_generator``, so N replicas retrying one dead
  store de-correlate while injected-fault tests still replay exactly.
- **watchdog** arms a timer around a block that cannot be cancelled (a
  collective, a blocking store op) and reports — to stderr and an
  optional handler — when it is still pending past the deadline, instead
  of the silent infinite hang a dead peer otherwise produces.
- **run_resilient** is the elastic supervisor: it consumes
  ``ElasticNode.alive_nodes()`` membership changes and worker-raised
  faults, and executes HOLD -> checkpoint -> wait-for-settle -> resume
  with rescaled ranks, bounded restart attempts, and backoff.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import shutil
import sys
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ..framework.flags import flag
from ..observability import runlog as _runlog
from ..observability import span as _span
from ..observability.metrics import counter_inc as _counter_inc
from ..testing import chaos
from . import checkpoint as ckpt_mod
from .store import BarrierTimeoutError  # noqa: F401  (re-export: one seam)

__all__ = ["CheckpointCorruption", "WorkerFault", "CheckpointManager", "retry", "RetryingStore",
           "watchdog", "run_resilient"]

_MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d{8})$")


class CheckpointCorruption(RuntimeError):
    """A checkpoint on disk failed verification (missing manifest, unreadable
    arrays, or checksum mismatch)."""


class WorkerFault(RuntimeError):
    """Raised by a train step to signal a recoverable worker fault the
    supervisor should answer with checkpoint + restart (e.g. a failed
    collective, a preemption notice)."""


# --------------------------------------------------------------------------
# CheckpointManager
# --------------------------------------------------------------------------


class CheckpointManager:
    """Rotating, integrity-checked checkpoints under one directory.

    Layout: ``<dir>/step_00000042/{state/state.pt, manifest.json}``. A
    checkpoint is *published* by renaming its temp directory into place,
    and *valid* only if the manifest — written last, after the arrays are
    durable — is present and every per-leaf CRC matches. A crash at any
    point therefore leaves either the previous checkpoints untouched (temp
    dir never renamed, GC'd later) or a complete new one; there is no
    window where the latest checkpoint is half-written yet looks
    restorable.

    ``last_save`` holds the seconds of the last save's parts (``gather``:
    the host copy, ``write``, ``crc``) and its ``bytes``; ``last_restore``
    those of the last restore (``read``, ``crc``, ``convert``).
    """

    def __init__(self, directory: str, keep_last_k: int = 3):
        if keep_last_k < 1:
            raise ValueError(f"keep_last_k must be >= 1, got {keep_last_k}")
        self.directory = os.path.abspath(directory)
        self.keep_last_k = keep_last_k
        os.makedirs(self.directory, exist_ok=True)
        self.last_save: dict = {}
        self.last_restore: dict = {}

    # ------------------------------------------------------------- layout
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> List[int]:
        """Published step numbers, ascending (validity not yet checked)."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # --------------------------------------------------------------- save
    def save(self, state: Any, step: int) -> str:
        """Atomically publish ``state`` (a tree, or a ``TrainStep`` written
        whole) as the checkpoint for ``step``. Under a mesh of several
        ranks every rank calls it; world rank 0 writes."""
        with _span("checkpoint.save") as sp:
            final = self._save(state, step)
        _counter_inc("checkpoint.saves")
        _runlog.emit("checkpoint_save", step=step, path=final,
                     seconds=sp.seconds)
        return final

    def _save(self, state: Any, step: int) -> str:
        final = self._step_dir(step)
        t0 = time.perf_counter()
        host = ckpt_mod.host_state(state)
        t1 = time.perf_counter()
        if not ckpt_mod._writes(state):
            ckpt_mod._mesh_barrier(state)
            return final
        tmp = os.path.join(self.directory, f".tmp-step_{step:08d}-{os.getpid()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        ckpt_mod.save_state(host, os.path.join(tmp, "state"))
        t2 = time.perf_counter()
        # kill-mid-save lands here: arrays on disk, manifest absent -> the
        # temp dir is never published and restore skips it entirely
        chaos.crash_if_due("checkpoint_save", step)
        manifest = {"format": 1, "step": step,
                    "leaves": ckpt_mod.checksum_pytree(host)}
        t3 = time.perf_counter()
        mpath = os.path.join(tmp, _MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)  # same-step re-save: replace
        os.rename(tmp, final)
        if chaos.corrupt_due():
            _corrupt_array_data(final)
            _runlog.emit("chaos_inject", step=step, kind="corrupt_ckpt",
                         path=final)
        self.gc()
        self.last_save = {"gather": t1 - t0, "write": t2 - t1, "crc": t3 - t2,
                          "bytes": os.path.getsize(os.path.join(final, "state",
                                                                ckpt_mod.DATA_FILE))}
        ckpt_mod._mesh_barrier(state)
        return final

    # ------------------------------------------------------------ restore
    def restore_latest(self, target: Optional[Any] = None,
                       shardings: Optional[Any] = None,
                       ) -> Optional[Tuple[Any, int]]:
        """(state, step) from the newest checkpoint that passes
        verification, walking backwards past corrupt/truncated ones;
        None when no valid checkpoint exists.

        ``target``/``shardings`` need NOT match the placement the
        checkpoint was saved under: after CRC verification the state is
        routed through :mod:`~paddle_tpu_torch.distributed.converter` — a
        tree is placed as ``target``'s leaves (onto ``shardings``' devices),
        and a ``TrainStep`` target gets its rank's pieces loaded into it
        (then the state returned is the step's own) — so a checkpoint
        written on mesh A restores onto mesh B. A target the checkpoint
        *cannot* convert to (shape/dtype/structure drift) raises
        :class:`~.converter.CheckpointConversionError` naming the first
        mismatched leaf — that is a caller bug, not corruption, so it
        propagates instead of falling back to an older checkpoint."""
        from .converter import CheckpointConversionError

        with _span("checkpoint.restore") as sp:
            result = None
            for step in reversed(self.steps()):
                try:
                    result = self._load_verified(step, target, shardings), step
                    break
                except CheckpointConversionError:
                    raise
                except Exception as exc:
                    print(f"[resilience] checkpoint step {step} invalid "
                          f"({type(exc).__name__}: {exc}); falling back",
                          file=sys.stderr)
        if result is not None:
            _counter_inc("checkpoint.restores")
            _runlog.emit("checkpoint_restore", step=result[1],
                         seconds=sp.seconds)
        return result

    def _load_verified(self, step: int, target, shardings) -> Any:
        d = self._step_dir(step)
        mpath = os.path.join(d, _MANIFEST)
        if not os.path.exists(mpath):
            raise CheckpointCorruption(f"{d}: no manifest (interrupted save)")
        with open(mpath) as f:
            manifest = json.load(f)
        # raw read first: the CRC is computed over the same bytes the
        # manifest recorded at save time (placement-independent), THEN the
        # verified state converts onto the requested target/shardings
        t0 = time.perf_counter()
        state = ckpt_mod.load_state(os.path.join(d, "state"))
        t1 = time.perf_counter()
        got = ckpt_mod.checksum_pytree(state)
        want = manifest["leaves"]
        bad = sorted(k for k in set(want) | set(got)
                     if want.get(k, {}).get("crc32") != got.get(k, {}).get("crc32"))
        if bad:
            raise CheckpointCorruption(
                f"{d}: checksum mismatch for {bad} (on-disk corruption)")
        t2 = time.perf_counter()
        if target is not None or shardings is not None:
            from . import converter as _converter

            state = _converter.convert(state, target=target,
                                       shardings=shardings,
                                       label=f"step_{step:08d}")
            if ckpt_mod._is_step(target):
                state = target
        self.last_restore = {"read": t1 - t0, "crc": t2 - t1,
                             "convert": time.perf_counter() - t2}
        return state

    # ----------------------------------------------------------- rotation
    def gc(self):
        """Keep the newest ``keep_last_k`` published checkpoints; drop the
        rest plus any stale temp dirs from crashed saves."""
        for step in self.steps()[:-self.keep_last_k]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        for name in os.listdir(self.directory):
            if name.startswith(".tmp-step_"):
                p = os.path.join(self.directory, name)
                # a LIVE writer's temp dir belongs to this pid; stale ones
                # come from crashed saves and are safe to reap
                if not name.endswith(f"-{os.getpid()}"):
                    shutil.rmtree(p, ignore_errors=True)


def _corrupt_array_data(step_dir: str):
    """Chaos helper: bit-flip the middle half of the array file of a
    published checkpoint (the tensors' bytes; the archive's headers at
    either end stay). The manifest stays intact, so the checkpoint still
    LOOKS restorable — only loading it (loader-level error) or verifying
    it (checksum mismatch) can tell."""
    path = os.path.join(step_dir, "state", ckpt_mod.DATA_FILE)
    size = os.path.getsize(path)
    lo, hi = size // 4, max(size // 4 + 1, 3 * size // 4)
    data = np.memmap(path, dtype=np.uint8, mode="r+")
    chunk = 1 << 26
    for start in range(lo, hi, chunk):
        end = min(hi, start + chunk)
        np.bitwise_xor(data[start:end], 0xFF, out=data[start:end])
    data.flush()
    del data


# --------------------------------------------------------------------------
# Store hardening
# --------------------------------------------------------------------------


def retry(max_attempts: int = 3, base_delay: float = 0.05,
          max_delay: float = 2.0,
          retry_on: Tuple[type, ...] = (OSError, TimeoutError),
          jitter: Optional[bool] = None,
          deadline_s: Optional[float] = None):
    """Bounded exponential-backoff retry for transient store/IO failures.

    Attempt i's backoff cap is ``min(max_delay, base_delay * 2**i)``; after
    ``max_attempts`` failures the last exception propagates unchanged.

    ``deadline_s`` adds an overall wall-clock budget per CALL (measured
    from its first attempt): once the budget is spent no further attempt
    is made and the last exception propagates unchanged — the bound a
    caller's SLA actually needs, where ``max_attempts x max_delay`` only
    bounds the sleep time and says nothing about how long the attempts
    themselves block. A backoff sleep is clamped to the remaining budget,
    so the final retry fires just before the deadline instead of
    overshooting it. None (the default) keeps the attempts-only bound.

    ``jitter`` selects the sleep inside that cap (None defers to
    ``FLAGS_store_retry_jitter``, read per call so ``set_flags`` applies to
    already-decorated functions):

    - **full jitter** (the AWS discipline): sleep ``uniform(0, cap)``. N
      replicas hammering a dead store spread their retries across the whole
      window instead of thundering-herding on the same schedule. The stream
      comes from :func:`framework.random.host_generator` seeded on
      (the host seed, the decorated function's name, PADDLE_TRAINER_ID) —
      bitwise-replayable under chaos tests, de-correlated across ranks.
    - **off**: the pre-jitter deterministic sleeps (exactly ``cap``).
    """
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
    if deadline_s is not None and deadline_s <= 0:
        raise ValueError(f"deadline_s must be > 0, got {deadline_s}")

    def deco(fn: Callable):
        from ..framework import random as _random

        tag = (f"retry/{getattr(fn, '__qualname__', fn)}"
               f"/{os.environ.get('PADDLE_TRAINER_ID', '0')}")
        rng_box: list = []  # created lazily so a host seed set later applies

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.monotonic() if deadline_s is not None else 0.0
            for attempt in range(max_attempts):
                try:
                    return fn(*args, **kwargs)
                except retry_on:
                    if attempt == max_attempts - 1:
                        raise
                    cap = min(max_delay, base_delay * (2 ** attempt))
                    use = flag("FLAGS_store_retry_jitter") if jitter is None else jitter
                    if use:
                        if not rng_box:
                            rng_box.append(_random.host_generator(tag))
                        cap = float(rng_box[0].uniform(0.0, cap))
                    if deadline_s is not None:
                        remaining = deadline_s - (time.monotonic() - t0)
                        if remaining <= 0:
                            raise  # budget spent: last exception unchanged
                        cap = min(cap, remaining)
                    time.sleep(cap)

        return wrapper

    return deco


class RetryingStore:
    """Proxy wrapping a TCPStore's transient-failure-prone ops (set/get/
    add/wait/delete_key/num_keys) in the ``retry`` decorator; everything
    else passes through. ``jitter`` has :func:`retry` semantics (None
    defers to ``FLAGS_store_retry_jitter`` — full jitter by default, so a
    fleet of replicas retrying one dead store doesn't thundering-herd);
    ``deadline_s`` is the per-call wall-clock retry budget (None keeps the
    attempts-only bound)."""

    _RETRIED = ("set", "get", "add", "wait", "delete_key", "num_keys")

    def __init__(self, store, max_attempts: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, jitter: Optional[bool] = None,
                 deadline_s: Optional[float] = None):
        self._store = store
        deco = retry(max_attempts=max_attempts, base_delay=base_delay,
                     max_delay=max_delay, retry_on=(OSError,), jitter=jitter,
                     deadline_s=deadline_s)
        for name in self._RETRIED:
            setattr(self, name, deco(getattr(store, name)))

    def __getattr__(self, name):
        return getattr(self._store, name)


def watchdog(name: str, timeout: Optional[float] = None,
             on_timeout: Optional[Callable[[str, float], None]] = None):
    """Context manager arming a timer around a block that cannot be
    cancelled (a collective, a blocking store op). If the block is still
    pending after ``timeout`` seconds, the handler runs on a daemon thread
    — default: print a diagnostic to stderr — turning a silent distributed
    hang into an attributable report. ``timeout`` defaults to
    FLAGS_collective_timeout_s; <= 0 disarms (no timer at all).

    The block itself keeps running (a collective gives no cancellation
    handle); pair with the elastic layer, whose membership view replaces
    the hung worker.
    """

    @contextlib.contextmanager
    def cm():
        tmo = flag("FLAGS_collective_timeout_s") if timeout is None else timeout
        if not tmo or tmo <= 0:
            yield
            return
        t0 = time.monotonic()

        def fire():
            elapsed = time.monotonic() - t0
            _runlog.emit("collective_timeout", name=name, seconds=elapsed,
                         deadline=tmo)
            if on_timeout is not None:
                on_timeout(name, elapsed)
            else:
                print(f"[resilience][watchdog] {name!r} still pending after "
                      f"{elapsed:.1f}s (deadline {tmo:g}s) — a peer is likely "
                      "dead or partitioned", file=sys.stderr)

        timer = threading.Timer(tmo, fire)
        timer.daemon = True
        timer.start()
        try:
            yield
        finally:
            timer.cancel()

    return cm()


# --------------------------------------------------------------------------
# Elastic supervisor
# --------------------------------------------------------------------------


class _MembershipChanged(Exception):
    """Internal: the alive set no longer matches the working membership."""


def run_resilient(train_step_fn: Callable[[Any, int, List[int]], Any], *,
                  node, manager: CheckpointManager, init_state: Any,
                  num_steps: int, min_nodes: int = 1,
                  max_nodes: Optional[int] = None, checkpoint_every: int = 1,
                  max_restarts: int = 3, backoff: float = 0.2,
                  settle: float = 0.5, deadline: float = 60.0,
                  membership_check_every: int = 1,
                  on_event: Optional[Callable[[str, dict], None]] = None,
                  shardings: Optional[Any] = None,
                  on_rescale: Optional[Callable[[List[int], Any], Any]] = None,
                  ) -> Tuple[Any, int]:
    """Supervised elastic training loop: detect, checkpoint, rescale, resume.

    ``train_step_fn(state, step, members) -> state`` runs one step;
    ``members`` is the settled alive set (ascending node ids — a node's
    index is its rescaled rank, reference manager semantics). The state is
    a tree or a ``TrainStep`` (checkpointed whole, restored into itself).
    Recovery protocol on a membership change or a worker-raised
    ``WorkerFault``/injected crash:

      HOLD      stop stepping; checkpoint in-progress state at once
      SETTLE    ``node.wait_for(min_nodes, max_nodes, settle)`` until the
                alive set is stable inside the allowed range
      RESCALE   when the settled membership differs and ``on_rescale`` is
                given: ``on_rescale(members, state)`` re-plans for the new
                topology (e.g. builds the new mesh's ``TrainStep``) and
                returns the new restore target, or a ``(restore_target,
                restore_shardings)`` pair
      RESUME    restore the newest valid checkpoint — converted onto the
                (possibly new) target — and continue from its step with
                the rescaled membership

    ``shardings`` places the initial restore (same semantics as
    :meth:`CheckpointManager.restore_latest`). A topology change without
    ``on_rescale`` keeps the old target.

    A :class:`paddle_tpu_torch.stability.DivergenceFault` (raised by a
    ``HealthMonitor`` inside ``train_step_fn``) follows the same protocol
    EXCEPT the HOLD save: numerically poisoned state is never persisted —
    the restore rewinds past the divergence instead.

    Restart attempts are bounded by ``max_restarts`` with exponential
    backoff; the fault that exhausts the budget propagates. Returns
    ``(final_state, restarts_used)``.
    """
    from ..observability import exporter as _exporter
    from ..observability import flightrec as _flightrec
    from ..observability import trace as _trace
    from ..stability import DivergenceFault

    members = node.wait_for(min_nodes, max_nodes, settle=settle,
                            deadline=deadline)
    state, step = init_state, 0
    restore_target, restore_shardings = init_state, shardings
    restored = manager.restore_latest(target=restore_target,
                                      shardings=restore_shardings)
    if restored is not None:
        state, step = restored
    restarts = 0
    # one trace id for the whole supervised run: every step event and every
    # incident span (hold / rollback / rescale / resume) correlates to it
    run_trace = _trace.new_trace_id("resilient")
    # live export for the long-lived worker (no-op at FLAGS_metrics_port=0)
    _exporter.ensure_started(store=getattr(node, "store", None),
                             rank=getattr(node, "node_id", 0))

    def _emit(kind, **info):
        if on_event is not None:
            on_event(kind, info)

    def _membership_events(old, new, step_):
        for node_id in sorted(set(new) - set(old)):
            _runlog.emit("worker_join", step=step_, node=node_id,
                         members=list(new))
        for node_id in sorted(set(old) - set(new)):
            _runlog.emit("worker_leave", step=step_, node=node_id,
                         members=list(new))

    _membership_events([], members, step)
    _emit("start", step=step, members=members)
    with _trace.attach(run_trace):  # step events inherit the run's trace id
        while step < num_steps:
            try:
                if membership_check_every and step % membership_check_every == 0:
                    alive = node.alive_nodes()
                    if alive != members:
                        raise _MembershipChanged(f"{members} -> {alive}")
                chaos.crash_if_due("train_step", step)
                state = train_step_fn(state, step, members)
            except (WorkerFault, chaos.ChaosCrash, _MembershipChanged) as fault:
                if restarts >= max_restarts:
                    _emit("giveup", step=step, fault=repr(fault))
                    raise
                restarts += 1
                _emit("hold", step=step, fault=repr(fault), restart=restarts)
                _trace.span_event("resilient.hold", trace_id=run_trace,
                                  step=step, restart=restarts,
                                  fault=type(fault).__name__)
                if isinstance(fault, DivergenceFault):
                    # divergence rewind: the in-flight state is numerically
                    # poisoned — restore WITHOUT persisting it first
                    _counter_inc("stability.rollbacks")
                    _runlog.emit("rollback", step=step, reason=str(fault),
                                 rollbacks=restarts, trace=run_trace)
                    _flightrec.dump("divergence", fault, step=step,
                                    restart=restarts)
                else:
                    manager.save(state, step)  # HOLD: make current progress durable
                time.sleep(backoff * (2 ** (restarts - 1)))
                prev_members = members
                members = node.wait_for(min_nodes, max_nodes, settle=settle,
                                        deadline=deadline)
                _membership_events(prev_members, members, step)
                if on_rescale is not None and members != prev_members:
                    # elastic re-plan during the HOLD window: the hook builds
                    # for the new topology and hands back the target the
                    # checkpoint is converted onto
                    with _trace.trace_span("resilient.rescale",
                                           trace_id=run_trace, step=step,
                                           members=list(members)):
                        rescaled = on_rescale(members, state)
                    if rescaled is not None:
                        if isinstance(rescaled, tuple):
                            restore_target, restore_shardings = rescaled
                        else:
                            restore_target = rescaled
                        state = restore_target
                restored = manager.restore_latest(target=restore_target,
                                                  shardings=restore_shardings)
                if restored is not None:
                    state, step = restored
                _emit("resume", step=step, members=members, restart=restarts)
                _trace.span_event("resilient.resume", trace_id=run_trace,
                                  step=step, restart=restarts,
                                  members=list(members))
                continue
            step += 1
            if checkpoint_every and step % checkpoint_every == 0:
                manager.save(state, step)
    manager.save(state, num_steps)
    _emit("done", step=num_steps, restarts=restarts)
    return state, restarts

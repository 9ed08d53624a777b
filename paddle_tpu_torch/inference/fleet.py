"""Fault-tolerant serving fleet of the port (``paddle_tpu/inference/fleet.py``):
N engine replicas behind a routing front.

One :class:`~.engine.DecodeEngine` serves one process's worth of traffic; a
fleet runs N of them and treats a replica's death as a steady state, keeping
every accepted request's answer, bitwise, through mid-stream replica kills:

- **placement** — the front :class:`~.router.Router` places each request by
  prefix-cache affinity (the PrefixCache exact-token-chain byte keys as
  hints: a request sharing a system prompt lands on the replica already
  holding those KV chunks) with load-aware tie-breaking;
- **health** — every replica tick refreshes a heartbeat (published through
  a :class:`~..distributed.resilience.RetryingStore`-wrapped TCPStore when
  ``store=`` is given, so N replicas surviving a flaky store back off with
  full jitter instead of thundering-herding); a tick that overruns
  ``heartbeat_timeout`` (straggler, ``FLAGS_chaos_replica_slow_ms``) or
  raises (``FLAGS_chaos_replica_kill_at``, a real fault) marks the replica
  **dead**;
- **drain + requeue** — a dead replica's in-flight requests requeue onto
  survivors from the fleet's own records (original prompt, seed, remaining
  deadline). Completions are **exactly-once**: a request's tokens are
  delivered only when some replica finishes it, and the replay re-prefills
  from the original prompt, so — sampling generators seeded on the request
  seed and absolute position, never on slot or replica — the replayed
  tokens are bitwise-identical to an unkilled run. Nothing is emitted
  twice, nothing is lost;
- **graceful degradation** — per-request deadlines (expired requests free
  their slot mid-decode, see the scheduler's cancel path) and queue-depth
  admission control: past ``max_queue_depth`` queued requests the fleet
  sheds with a structured :class:`FleetOverloadError` instead of queueing
  without bound;
- **elastic scale-out** — :meth:`ServingFleet.scale_out` adds replicas live.

In-process replicas share one model and tick one after another on the
calling thread, so the whole fleet's host work runs on one thread; the
cross-process fleet (:mod:`.procfleet`) runs each replica's host work in a
process of its own.

The heartbeat exempts a tick in which an engine built a new program
signature (``infer.compiles`` moved: the engine counts its first dispatch of
each ``(program, shapes, dtypes)`` signature, where the port pays its cold
build: allocator growth, cuBLAS handles, the kernel library's load) or loaded
one from the AOT disk cache (``infer.aot_cache_hits``): a warm-up pause is
readiness, not liveness. So a cold replica's first tick, and a tick on a new
prefill bucket or fuse depth, never counts against ``heartbeat_timeout``.
The AOT cache (``FLAGS_compile_cache_dir``) is not ported (ROADMAP.md,
Queue 1 item 4), so a scale-out replica's first request is a cold build.

The fleet registers its ``/healthz`` probe and starts the live exporter
(``FLAGS_metrics_port``); each tick ends with the runtime sanitizer's
ledger check (``FLAGS_sanitize``) and the SLO tick (``FLAGS_slo``).

Telemetry: ``fleet.*`` counters/gauges (pre-declared in
``observability.metrics.FLEET_COUNTERS``) and ``fleet`` run-log events
(membership / replica_dead / requeue / shed / deadline / scale_out /
finished).
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..analysis import sanitizer as _sanitizer
from ..observability import exporter as _exporter
from ..observability import flightrec as _flightrec
from ..observability import runlog as _runlog
from ..observability import slo as _slo
from ..observability import trace as _trace
from ..observability.metrics import counter_inc, counters, gauge_set, observe
from ..testing import chaos
from .router import Router
from .scheduler import ContinuousBatchingScheduler

__all__ = ["ServingFleet", "EngineReplica", "FleetRequest",
           "FleetOverloadError", "FleetDrainedError", "retry_after_estimate"]


def warm_builds() -> int:
    """Program signatures built or loaded from the AOT disk cache so far:
    what the heartbeat's warm-up exemption watches."""
    c = counters("infer.")
    return int(c.get("infer.compiles", 0) + c.get("infer.aot_cache_hits", 0))


def retry_after_estimate(depth: int, rate: Optional[float],
                         lo: float = 0.5, hi: float = 30.0) -> float:
    """How long a shed client should wait before retrying: queue depth ÷
    recent finish rate (seconds until the backlog plausibly drains),
    clamped to ``[lo, hi]``. With no finish history yet (``rate`` None or
    0) an overloaded fleet answers the pessimistic ``hi`` — better to
    overshoot the wait than to invite an immediate re-shed."""
    if rate is None or rate <= 0:
        est = hi if depth > 0 else lo
    else:
        est = depth / rate
    return float(min(hi, max(lo, est)))


class FleetOverloadError(RuntimeError):
    """Structured load-shed: the fleet's queues are at capacity and this
    request was REJECTED at admission (nothing was enqueued). Callers
    retry with backoff or surface a 429-style answer; ``queued``/``limit``/
    ``replicas_alive`` say how overloaded the fleet was and
    ``retry_after_s`` (queue depth ÷ recent finish rate, clamped — see
    :func:`retry_after_estimate`) is the backoff hint the ingress forwards
    as the ``Retry-After`` header."""

    def __init__(self, queued: int, limit: int, replicas_alive: int,
                 retry_after_s: Optional[float] = None):
        self.queued = int(queued)
        self.limit = int(limit)
        self.replicas_alive = int(replicas_alive)
        self.retry_after_s = (None if retry_after_s is None
                              else float(retry_after_s))
        hint = ("" if self.retry_after_s is None
                else f"; retry after {self.retry_after_s:.1f}s")
        super().__init__(
            f"fleet overloaded: {queued} requests queued >= limit {limit} "
            f"across {replicas_alive} alive replica(s); request shed{hint}")


class FleetDrainedError(RuntimeError):
    """Every replica is dead: the fleet cannot serve or requeue. In-flight
    requests at the time of the last death are listed by fleet id."""

    def __init__(self, lost: List[int]):
        self.lost = list(lost)
        super().__init__(f"fleet: all replicas dead; {len(lost)} in-flight "
                         f"request(s) cannot be requeued: {lost}")


class FleetRequest:
    """The fleet's own record of one accepted request — the source of truth
    for requeueing (the dead replica's bookkeeping is treated as lost) and
    the exactly-once completion ledger (``tokens`` is written once, by the
    replica that finishes the request)."""

    __slots__ = ("fid", "prompt", "max_new_tokens", "eos_token_id", "seed",
                 "deadline_s", "trace_id", "status", "tokens", "replica",
                 "attempts", "submitted_ts", "first_token_ts", "finished_ts")

    def __init__(self, fid: int, prompt, max_new_tokens: int,
                 eos_token_id: Optional[int], seed: int,
                 deadline_s: Optional[float],
                 trace_id: Optional[str] = None):
        self.fid = fid
        self.prompt = np.asarray(prompt, np.int64).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.seed = int(seed)
        self.deadline_s = deadline_s
        self.trace_id = trace_id      # one id, submit through delivery
        self.status = "queued"
        self.tokens: List[int] = []
        self.replica: Optional[int] = None    # current/last placement
        self.attempts = 1                     # 1 + requeues
        self.submitted_ts = time.perf_counter()
        self.first_token_ts: Optional[float] = None
        self.finished_ts: Optional[float] = None

    @property
    def total_seconds(self):
        return None if self.finished_ts is None else self.finished_ts - self.submitted_ts

    @property
    def ttft_seconds(self):
        return None if self.first_token_ts is None else self.first_token_ts - self.submitted_ts

    def output_ids(self) -> np.ndarray:
        """prompt + generated tokens, the served completion."""
        return np.concatenate([self.prompt, np.asarray(self.tokens, np.int64)])


class EngineReplica:
    """One serving replica: a DecodeEngine + its continuous-batching
    scheduler, plus the liveness bookkeeping the fleet's health tracking
    reads (tick count, last tick duration, heartbeat timestamp)."""

    def __init__(self, rid: int, model, engine_kwargs: Dict[str, Any],
                 on_beat=None, keep_finished: int = 256):
        from .engine import DecodeEngine

        self.rid = int(rid)
        self.engine = DecodeEngine(model, **engine_kwargs)
        self.scheduler = ContinuousBatchingScheduler(self.engine,
                                                     keep_finished=keep_finished)
        self.alive = True
        self.death_reason: Optional[str] = None
        self.ticks = 0                # scheduler ticks served
        self.completed = 0            # requests finished on this replica
        self.last_tick_seconds = 0.0
        self.last_beat = time.monotonic()
        self._on_beat = on_beat       # e.g. publish to a TCPStore

    def load(self) -> int:
        """In-flight requests: queued + prefilling + decoding."""
        s = self.scheduler
        return len(s.queue) + len(s.prefilling) + len(s.running)

    def tick(self):
        """One scheduler tick, with the chaos seams the fleet tests drive:
        injected per-tick latency first (a straggler the heartbeat tracker
        must notice), then the armed kill (raises ``ChaosCrash`` — replica
        death, exactly the shape of a real mid-dispatch fault). Returns the
        requests finished this tick."""
        t0 = time.monotonic()
        slow = chaos.replica_slow_ms(self.rid)
        if slow > 0:
            time.sleep(slow / 1e3)
        if chaos.replica_kill_due(self.rid, self.ticks):
            raise chaos.ChaosCrash(
                f"chaos: replica {self.rid} killed after tick {self.ticks}")
        finished = self.scheduler.step()
        self.ticks += 1
        self.last_tick_seconds = time.monotonic() - t0
        self.last_beat = time.monotonic()
        if self._on_beat is not None:
            self._on_beat(self.rid)
        return finished


class ServingFleet:
    """N engine replicas behind a prefix-affinity router, with kill-safe
    drain/requeue, deadlines, and load shedding.

    ``model`` and every ``engine_kwargs`` knob are shared by all replicas
    (each replica holds its own engine, with its own static KV cache, over
    the one model). That pass-through covers the speed knobs too:
    ``draft=``/``spec_k=`` (each replica builds the same draft weights from
    ``draft_seed``, so a request requeued off a killed replica re-accepts the
    same speculative runs bitwise) and ``kv_dtype="int8"``. The replicas
    serve on the model's device. ``max_queue_depth`` bounds the TOTAL queued
    (not-yet-admitted) requests across alive replicas; past it
    :meth:`submit` sheds with :class:`FleetOverloadError`.

    ``heartbeat_timeout`` (seconds; 0 disables) declares a replica dead
    when a tick overruns it — the straggler/zombie detector
    (``FLAGS_chaos_replica_slow_ms`` proves it). Ticks that built a new
    program signature — or loaded one from the AOT disk cache — are exempt
    (a warm-up pause is readiness, not liveness; see the module's
    docstring). A tick that *raises*
    (``FLAGS_chaos_replica_kill_at``, or any real fault) is death
    regardless. ``store=`` additionally publishes per-replica heartbeats to
    a TCPStore through ``RetryingStore`` (full-jitter backoff — see
    ``FLAGS_store_retry_jitter``) so an external supervisor can watch
    membership the elastic way.

    Driving: :meth:`submit` then :meth:`step` per tick (or :meth:`run` to
    drain). All replicas tick in-process; the fleet survives any of them
    dying mid-stream, requeueing their in-flight requests onto survivors
    with exactly-once, bitwise-identical completions.
    """

    _HB_PREFIX = "fleet_serve/hb"

    def __init__(self, model, replicas: int = 2, *,
                 max_queue_depth: int = 64, heartbeat_timeout: float = 0.0,
                 store=None, affinity_load_slack: int = 2,
                 keep_finished: int = 256, **engine_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got {max_queue_depth}")
        if keep_finished < 1:
            raise ValueError(f"keep_finished must be >= 1, got {keep_finished}")
        self.model = model
        self.engine_kwargs = dict(engine_kwargs)
        self.max_queue_depth = int(max_queue_depth)
        self.keep_finished = int(keep_finished)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.router = Router(chunk=engine_kwargs.get("prefill_chunk"),
                             affinity_load_slack=affinity_load_slack)
        self._store = None
        if store is not None:
            from ..distributed.resilience import RetryingStore

            self._store = store if isinstance(store, RetryingStore) else RetryingStore(store)
        self.replicas: Dict[int, EngineReplica] = {}
        # the fleet ledger: delivered (terminal) requests are GC'd past
        # keep-last-k each tick — in-flight entries are never evicted, so
        # exactly-once + kill/requeue accounting is untouched
        self.requests: Dict[int, FleetRequest] = {}
        self.finished_total = 0       # completions ever, across ledger GC
        self._inflight: Dict[int, Dict[int, int]] = {}  # rid -> {local rid: fid}
        self._next_fid = 0
        self._next_rid = 0
        self.requeues = 0
        # recent completion timestamps (monotonic) — the finish-rate window
        # behind FleetOverloadError.retry_after_s and the ingress backoff
        self._finish_times: collections.deque = collections.deque(maxlen=64)
        # cascade-death bookkeeping: _on_replica_death is re-entrant (a
        # survivor can die while absorbing requeued work — _place runs a
        # synchronous submit); the outermost call owns the drain loop
        self._requeue_backlog: List[int] = []
        self._draining = False
        for _ in range(int(replicas)):
            self._add_replica()
        self._emit_membership()
        # live export (FLAGS_metrics_port; no-op at the default 0): the
        # fleet driver is the long-lived process /metrics exists for
        _exporter.register_health("fleet", self._health)
        _exporter.ensure_started(store=self._store)

    def _health(self) -> dict:
        """The /healthz probe: fleet liveness is replica liveness."""
        alive = sorted(self._alive())
        dead = sorted(set(self.replicas) - set(alive))
        return {"ok": bool(alive), "replicas_alive": alive,
                "replicas_dead": dead, "queue_depth": self.queue_depth()}

    # ------------------------------------------------------------ replicas
    def _beat(self, rid: int) -> None:
        self._store.set(f"{self._HB_PREFIX}/{rid}", repr(time.time()))

    def _add_replica(self) -> EngineReplica:
        rid = self._next_rid
        self._next_rid += 1
        rep = EngineReplica(rid, self.model, self.engine_kwargs,
                            on_beat=self._beat if self._store is not None else None,
                            keep_finished=self.keep_finished)
        self.replicas[rid] = rep
        self._inflight[rid] = {}
        if self._store is not None:
            self._beat(rid)
        return rep

    def _alive(self) -> Dict[int, EngineReplica]:
        return {rid: rep for rid, rep in self.replicas.items() if rep.alive}

    def _emit_membership(self) -> None:
        alive = sorted(self._alive())
        dead = sorted(set(self.replicas) - set(alive))
        gauge_set("fleet.replicas_alive", len(alive))
        gauge_set("fleet.replicas_dead", len(dead))
        _runlog.emit("fleet", kind="membership", component="fleet",
                     alive=alive, dead=dead)

    def membership(self) -> Dict[int, float]:
        """Store-published heartbeat ages (seconds) per replica — what an
        EXTERNAL supervisor sees. Requires ``store=``."""
        if self._store is None:
            raise RuntimeError("fleet: no store configured for membership")
        now = time.time()
        out = {}
        for rid in self.replicas:
            try:
                ts = float(self._store.get(f"{self._HB_PREFIX}/{rid}", timeout=0.25))
                out[rid] = now - ts
            except (TimeoutError, ValueError, OSError):
                out[rid] = float("inf")
        return out

    def scale_out(self, n: int = 1) -> List[int]:
        """Add ``n`` replicas live. Each builds its engine and cache; its
        first request is a cold build (no AOT cache in the port)."""
        new = [self._add_replica().rid for _ in range(int(n))]
        counter_inc("fleet.scale_outs", len(new))
        _runlog.emit("fleet", kind="scale_out", component="fleet", replicas=new)
        self._emit_membership()
        return new

    def kill_replica(self, rid: int, reason: str = "killed") -> None:
        """Administratively kill a replica (tests/bench: the direct form of
        the chaos kill). Its in-flight requests drain onto the survivors."""
        rep = self.replicas[rid]
        if rep.alive:
            self._on_replica_death(rep, RuntimeError(reason))

    # ----------------------------------------------------------- admission
    def queue_depth(self) -> int:
        """Queued (not yet admitted) requests across alive replicas — the
        number admission control compares against ``max_queue_depth``."""
        return sum(len(rep.scheduler.queue) for rep in self._alive().values())

    def finish_rate(self) -> Optional[float]:
        """Recent completions per second over the sliding finish window
        (None until two completions exist) — the denominator of
        :func:`retry_after_estimate`."""
        t = self._finish_times
        if len(t) < 2 or t[-1] <= t[0]:
            return None
        return (len(t) - 1) / (t[-1] - t[0])

    def transport_lag(self) -> Dict[str, float]:
        """Transport-health watermarks the ingress reads for backpressure.
        The in-process fleet has no wire: backlog is always 0 and the beat
        age is the slowest alive replica's last tick duration (a straggler
        shows up here exactly like a laggy socket would)."""
        alive = [rep for rep in self.replicas.values() if rep.alive]
        beat = max((rep.last_tick_seconds for rep in alive), default=0.0)
        return {"out_backlog": 0.0, "beat_age_s": float(beat)}

    def submit(self, prompt, max_new_tokens: int = 16,
               eos_token_id: Optional[int] = None, seed: int = 0,
               deadline_s: Optional[float] = None,
               replica: Optional[int] = None) -> int:
        """Route one prompt into the fleet; returns the fleet request id.

        Admission control runs FIRST: at ``max_queue_depth`` queued requests
        the fleet sheds with :class:`FleetOverloadError` (structured — the
        caller can back off) instead of queueing without bound. Placement is
        prefix-affinity with load tie-breaking; ``replica=`` pins it (tests,
        targeted warm-up). ``deadline_s`` bounds total time from THIS
        submission — it survives requeues (the remaining budget rides
        along), and an expired request frees its slot mid-decode."""
        alive = self._alive()
        if not alive:
            raise FleetDrainedError(sorted(
                fid for fid, r in self.requests.items()
                if r.status in ("queued", "prefilling", "running")))
        depth = self.queue_depth()
        if depth >= self.max_queue_depth:
            counter_inc("fleet.sheds")
            _runlog.emit("fleet", kind="shed", component="fleet",
                         queued=depth, limit=self.max_queue_depth)
            raise FleetOverloadError(
                depth, self.max_queue_depth, len(alive),
                retry_after_s=retry_after_estimate(depth, self.finish_rate()))
        if replica is not None:
            if replica not in alive:
                raise ValueError(f"replica {replica} is not alive")
            rid, reason = int(replica), "pinned"
        else:
            rid, reason = self.router.place(
                prompt, {r: rep.load() for r, rep in alive.items()})
            counter_inc("fleet.routed_affinity" if reason == "affinity"
                        else "fleet.routed_load")
        fid = self._next_fid
        self._next_fid += 1
        freq = FleetRequest(fid, prompt, max_new_tokens, eos_token_id, seed,
                            deadline_s, trace_id=_trace.new_trace_id("fleet"))
        self.requests[fid] = freq
        _runlog.emit("fleet", kind="submitted", component="fleet", id=fid,
                     trace=freq.trace_id, prompt_tokens=len(freq.prompt),
                     max_new_tokens=freq.max_new_tokens)
        self._place(freq, rid, reason)
        counter_inc("fleet.requests_submitted")
        gauge_set("fleet.queue_depth", self.queue_depth())
        return fid

    def _place(self, freq: FleetRequest, rid: int, reason: str,
               deadline_s: Optional[float] = "unset") -> None:
        """Submit ``freq`` to replica ``rid``'s scheduler and index the
        local rid so completions map back to the fleet ledger."""
        rep = self.replicas[rid]
        if deadline_s == "unset":
            deadline_s = freq.deadline_s
        local = rep.scheduler.submit(
            freq.prompt, max_new_tokens=freq.max_new_tokens,
            eos_token_id=freq.eos_token_id, seed=freq.seed,
            deadline_s=deadline_s, trace_id=freq.trace_id)
        self.router.register(freq.prompt, rid)
        freq.replica = rid
        freq.status = "running"
        self._inflight[rid][local] = freq.fid
        _runlog.emit("fleet", kind="placed", component="fleet", id=freq.fid,
                     replica=rid, reason=reason, attempt=freq.attempts,
                     trace=freq.trace_id)

    def _local_rid(self, fid: int) -> Optional[int]:
        """The scheduler-local rid currently running fleet request ``fid``
        (None when it is not in flight on any replica)."""
        freq = self.requests.get(fid)
        if freq is None or freq.replica is None:
            return None
        for local, f in self._inflight.get(freq.replica, {}).items():
            if f == fid:
                return local
        return None

    def tokens_so_far(self, fid: int) -> List[int]:
        """Live view of ``fid``'s generated tokens — the ledger's copy once
        terminal, the owning scheduler's in-progress run while decoding.
        The ingress streams from this without waiting for completion."""
        freq = self.requests[fid]
        if freq.status not in self._TERMINAL:
            local = self._local_rid(fid)
            if local is not None:
                r = self.replicas[freq.replica].scheduler.find(local)
                if r is not None:
                    return list(r.tokens)
        return list(freq.tokens)

    def cancel(self, fid: int, status: str = "cancelled") -> bool:
        """Cancel one in-flight request (client went away, deadline raced):
        frees its scheduler slot mid-decode and marks the ledger terminal.
        False when the request is unknown or already terminal."""
        freq = self.requests.get(fid)
        if freq is None or freq.status in self._TERMINAL:
            return False
        local = self._local_rid(fid)
        if local is None:
            return False
        rep = self.replicas[freq.replica]
        if not (rep.alive and rep.scheduler.cancel(local, status=status)):
            return False
        self._inflight[freq.replica].pop(local, None)
        freq.status = status
        freq.finished_ts = time.perf_counter()
        counter_inc("fleet.cancels")
        _runlog.emit("fleet", kind="cancelled", component="fleet", id=fid,
                     replica=freq.replica, status=status, trace=freq.trace_id)
        return True

    # ----------------------------------------------------------- the loop
    def step(self) -> List[FleetRequest]:
        """One fleet tick: advance every alive replica one scheduler tick,
        harvest completions/cancellations into the fleet ledger, and answer
        replica faults (raise or heartbeat overrun) with mark-dead + drain +
        requeue. Returns the fleet requests finished this tick."""
        done: List[FleetRequest] = []
        for rid, rep in list(self.replicas.items()):
            if not rep.alive:
                continue
            builds0 = warm_builds()
            try:
                finished = rep.tick()
            except Exception as exc:  # replica death: chaos kill or real fault
                self._on_replica_death(rep, exc)
                continue
            self._harvest(rep, finished, done)
            compiled = warm_builds() > builds0
            if (self.heartbeat_timeout and not compiled
                    and rep.last_tick_seconds > self.heartbeat_timeout):
                # the tick came back but took longer than the liveness
                # window — to the fleet this replica's heartbeat went dark
                # (straggler/zombie); same protocol as a death. Ticks that
                # compiled or AOT-loaded a program are exempt: a warm-up
                # pause is a readiness matter, not a liveness one.
                self._on_replica_death(rep, TimeoutError(
                    f"heartbeat lost: tick took {rep.last_tick_seconds:.3f}s "
                    f"> timeout {self.heartbeat_timeout:g}s"))
        self._gc_ledger(protect={r.fid for r in done})
        if _sanitizer.enabled():
            # post-GC the ledger is keep-last-k + in-flight; anything past
            # twice that means the GC stopped working
            _sanitizer.note_ledger(
                "fleet", "requests", len(self.requests),
                bound=2 * self.keep_finished + self.max_queue_depth)
        alive = [rep for rep in self.replicas.values() if rep.alive]
        if alive:
            # in the in-process fleet the last tick's duration IS the
            # heartbeat age: a straggling replica shows up as a long tick
            gauge_set("fleet.heartbeat_staleness_seconds",
                      max(rep.last_tick_seconds for rep in alive))
        _slo.on_tick()  # judgment layer: a single flag check until armed
        return done

    _TERMINAL = ("finished", "cancelled", "deadline_exceeded")

    def _gc_ledger(self, protect=()) -> None:
        """Keep-last-k GC of delivered requests: evict the OLDEST terminal
        entries past ``keep_finished`` (fids are monotonic, so dict order is
        submission order). In-flight entries are never touched — requeue and
        exactly-once delivery read the ledger only for live fids — and THIS
        tick's completions are protected so :meth:`step`'s return is always
        harvestable before eviction."""
        protect = set(protect)
        terminal = [fid for fid, r in self.requests.items()
                    if r.status in self._TERMINAL and fid not in protect]
        overflow = len(terminal) - self.keep_finished
        for fid in terminal[:max(0, overflow)]:
            del self.requests[fid]

    def _harvest(self, rep: EngineReplica, finished, done: List[FleetRequest]):
        inflight = self._inflight[rep.rid]
        for r in finished:
            fid = inflight.pop(r.rid, None)
            if fid is None:
                continue
            freq = self.requests[fid]
            # the exactly-once seam: tokens are written here and only here,
            # by the single replica that ran this request to completion
            freq.tokens = list(r.tokens)
            freq.status = "finished"
            freq.finished_ts = time.perf_counter()
            if r.first_token_ts is not None:
                freq.first_token_ts = r.first_token_ts
            rep.completed += 1
            self.finished_total += 1
            self._finish_times.append(time.monotonic())
            counter_inc("fleet.requests_completed")
            observe("fleet.latency_seconds", freq.total_seconds)
            _runlog.emit("fleet", kind="finished", component="fleet",
                         id=fid, replica=rep.rid, new_tokens=len(freq.tokens),
                         seconds=freq.total_seconds, attempts=freq.attempts,
                         trace=freq.trace_id)
            done.append(freq)
        for local in [l for l in list(inflight) if l in rep.scheduler.cancelled]:
            fid = inflight.pop(local)
            freq = self.requests[fid]
            freq.status = rep.scheduler.cancelled[local].status
            freq.finished_ts = time.perf_counter()
            if freq.status == "deadline_exceeded":
                counter_inc("fleet.deadline_hits")
            _runlog.emit("fleet",
                         kind=("deadline" if freq.status == "deadline_exceeded"
                               else "cancelled"),
                         component="fleet", id=fid,
                         replica=rep.rid, status=freq.status,
                         trace=freq.trace_id)

    def _on_replica_death(self, rep: EngineReplica, exc: BaseException) -> None:
        """Mark dead, forget chains, requeue in-flight work. Re-entrant:
        requeue placement can kill the survivor it lands on (its scheduler
        submit runs synchronously), re-entering this method mid-drain. A
        nested call parks the newly dead replica's fids on the shared
        backlog and returns; the OUTERMOST call keeps draining until the
        backlog is empty, so a cascade (every survivor dying in turn)
        still raises one FleetDrainedError accounting for every lost fid
        — the single-pass version dropped the outer pending set."""
        if not rep.alive:
            return
        rep.alive = False
        rep.death_reason = f"{type(exc).__name__}: {exc}"
        counter_inc("fleet.replica_deaths")
        self.router.forget_replica(rep.rid)
        pending = self._inflight.pop(rep.rid, {})
        self._inflight[rep.rid] = {}
        lost_traces = sorted({t for t in (
            self.requests[fid].trace_id for fid in pending.values())
            if t is not None})
        _runlog.emit("fleet", kind="replica_dead", component="fleet",
                     replica=rep.rid, reason=rep.death_reason,
                     inflight=len(pending), traces=lost_traces)
        _flightrec.dump("replica_death", exc, replica=rep.rid,
                        inflight=sorted(pending.values()),
                        traces=lost_traces)
        self._emit_membership()
        self._requeue_backlog.extend(sorted(pending.values()))
        if self._draining:
            return  # nested death: the outermost drain loop absorbs it
        self._draining = True
        try:
            lost: List[int] = []
            while self._requeue_backlog:
                fid = self._requeue_backlog.pop(0)
                survivors = self._alive()  # recomputed: the set shrinks mid-drain
                if not survivors:
                    lost.append(fid)
                    continue
                self._requeue(self.requests[fid], survivors)
            if lost:
                raise FleetDrainedError(sorted(lost))
        finally:
            self._draining = False

    def _requeue(self, freq: FleetRequest, survivors: Dict[int, EngineReplica]):
        """Re-place one request lost to a replica death. The replay runs the
        ORIGINAL prompt with the ORIGINAL seed — sampling keys fold on the
        request seed and absolute position, never on slot or replica, so the
        replayed tokens are bitwise what the dead replica would have
        produced. The remaining deadline budget rides along; a request whose
        deadline already passed is expired here instead of replayed."""
        remaining = freq.deadline_s
        if freq.deadline_s is not None:
            remaining = freq.deadline_s - (time.perf_counter() - freq.submitted_ts)
            if remaining <= 0:
                freq.status = "deadline_exceeded"
                freq.finished_ts = time.perf_counter()
                counter_inc("fleet.deadline_hits")
                _runlog.emit("fleet", kind="deadline", component="fleet",
                             id=freq.fid, replica=freq.replica,
                             status="deadline_exceeded", trace=freq.trace_id)
                return
        freq.attempts += 1
        self.requeues += 1
        counter_inc("fleet.requeues")
        rid, reason = self.router.place(
            freq.prompt, {r: rep.load() for r, rep in survivors.items()})
        _runlog.emit("fleet", kind="requeue", component="fleet", id=freq.fid,
                     replica=rid, from_replica=freq.replica, reason=reason,
                     trace=freq.trace_id)
        self._place(freq, rid, f"requeue/{reason}", deadline_s=remaining)

    def run(self, max_ticks: Optional[int] = None) -> Dict[int, FleetRequest]:
        """Drive :meth:`step` until every alive replica drains (or
        ``max_ticks``); returns ``{fid: FleetRequest}`` for every completion
        of the run — accumulated across ticks, so requests the keep-last-k
        ledger GC has since evicted are still returned."""
        done = {fid: r for fid, r in self.requests.items()
                if r.status == "finished"}
        ticks = 0
        while any(rep.scheduler.queue or rep.scheduler.prefilling
                  or rep.scheduler.running
                  for rep in self._alive().values()):
            for r in self.step():
                done[r.fid] = r
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        done.update({fid: r for fid, r in self.requests.items()
                     if r.status == "finished"})
        return done

    # ------------------------------------------------------------- summary
    def stats(self) -> dict:
        alive = self._alive()
        return {
            "replicas": len(self.replicas),
            "alive": sorted(alive),
            "dead": sorted(set(self.replicas) - set(alive)),
            "requests": len(self.requests),
            "finished": sum(1 for r in self.requests.values()
                            if r.status == "finished"),
            "finished_total": self.finished_total,
            "requeues": self.requeues,
            "queue_depth": self.queue_depth(),
            "router": self.router.stats(),
            "per_replica": {rid: {
                "alive": rep.alive,
                "ticks": rep.ticks,
                "completed": rep.completed,
                "load": rep.load(),
                "death_reason": rep.death_reason,
            } for rid, rep in self.replicas.items()},
        }

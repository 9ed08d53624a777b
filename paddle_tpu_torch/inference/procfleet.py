"""Cross-process serving fleet of the port (``paddle_tpu/inference/procfleet.py``):
subprocess replicas that survive kill -9.

:class:`~.fleet.ServingFleet` runs its replicas in-process, so a "replica
death" is a caught Python exception — a segfault, an OOM-kill, or a wedged
launch in any replica still takes the whole fleet down. Here each replica
is a **subprocess** hosting its own DecodeEngine + continuous-batching
scheduler, speaking the compact store-RPC of ``rpc.py`` (submit / tick /
token-chunk / heartbeat / drain) over the TCPStore. Children rebuild the
model from its config and ``model_seed`` on the fleet's device, and apply
the parent's float32 matmul settings (TF32 and the matmul precision) first,
so they compute bitwise what the parent computes on the same device type.
Children start through ``subprocess.Popen`` of :data:`CHILD_CMD` (a fresh
interpreter, never a fork of a parent that may hold a CUDA context), with
``CUDA_VISIBLE_DEVICES`` passed through unchanged.

The router/ledger/failure semantics carry over from ``fleet.py``
unchanged — only the transport is new:

- **supervision** — the parent detects death two ways: process liveness
  (``Popen.poll`` / ``kill(pid, 0)`` — catches SIGKILL and segfaults the
  child never got to report) and a stale-beat sweep (the child publishes
  a monotonic beat counter from a daemon thread; a child that stops
  beating without exiting — ``FLAGS_chaos_replica_hang_ms`` — is a zombie
  only this sweep can catch). Either way: chains forgotten, in-flight
  requests requeued from the PARENT's ledger (the dead child's
  bookkeeping is treated as lost) with original prompt + seed + remaining
  deadline, so completions stay **bitwise-identical to an unkilled run,
  delivered exactly once** — now proven against a real ``kill -9``.
- **per-token streaming** — ``submit(stream=True)`` returns a
  :class:`TokenStream` that yields in-order token chunks as decode
  progresses. The exactly-once ledger extends to chunk sequence numbers:
  ``FleetRequest.tokens`` is a monotonic, append-only delivery ledger;
  an arriving chunk ``(start, tokens)`` contributes only the suffix past
  what was already delivered, so a post-requeue replay (which re-streams
  from position 0, bitwise-identically) resumes the stream without
  duplicating or reordering a single delivered token.
- **exactly-once across death** — when a replica dies the parent drains
  its out-channel one final time before requeueing: a request the child
  *finished* before dying is delivered from that harvest (never
  replayed); one it didn't is replayed bitwise on a survivor. The ledger
  writes ``tokens`` to completion exactly once either way.
- **observability across the process boundary** — the RPC envelope
  carries the fleet ``trace_id``; the child attaches it to its scheduler
  submission so spans from both processes join one trace; child run logs
  land in the same ``FLAGS_run_log_dir``; a child crash dumps a
  ``flightrec-<pid>.json`` from the PARENT side naming the dead rid and its
  in-flight fids. A child's counters (the ``infer.*`` warm-up counters and
  each kernel's launches) ride its heartbeat: :meth:`child_counters`.

:meth:`ProcServingFleet.attach` adopts replicas that another supervisor
booted with store-registered membership (``spawn=False``). The reference's
launcher mode, ``distributed.launch --serve``, is not ported (ROADMAP.md,
Queue 1 item 13); neither is the AOT cache (``FLAGS_compile_cache_dir``,
item 4), which raises here as in the engine.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Set

import numpy as np

import torch

from ..analysis import sanitizer as _sanitizer
from ..framework.device import resolve_device
from ..framework.flags import flag
from ..observability import flightrec as _flightrec
from ..observability import runlog as _runlog
from ..observability import slo as _slo
from ..observability import trace as _trace
from ..observability.metrics import counter_inc, counters, gauge_set, observe
from ..ops import kernel_launches
from ..testing import chaos
from .fleet import (FleetDrainedError, FleetOverloadError, FleetRequest,
                    retry_after_estimate)
from .router import Router
from .rpc import (Heartbeat, SocketChannel, SocketListener, channel_prefix,
                  connect_socket, sock_key)

__all__ = ["ProcServingFleet", "ProcReplica", "TokenStream", "replica_main"]

SPEC_ENV = "PADDLE_PROCFLEET_SPEC"

# flag VALUES (not just env) forwarded into every replica subprocess: tests
# and drivers set these via set_flags, which a child env would never see
_FLAG_FORWARD = (
    "FLAGS_compile_cache_dir", "FLAGS_run_log_dir", "FLAGS_monitor",
    "FLAGS_trace", "FLAGS_flightrec_events", "FLAGS_chaos",
    "FLAGS_chaos_replica_hang_ms", "FLAGS_chaos_replica_slow_ms",
    "FLAGS_chaos_socket_drop_at", "FLAGS_chaos_net_delay_ms",
    "FLAGS_sanitize", "FLAGS_sanitize_strict", "FLAGS_sanitize_max_recompiles",
)

_TERMINAL = ("finished", "cancelled", "deadline_exceeded")
_ns_counter = [0]

# child entry via -c (not -m): `-m paddle_tpu_torch.inference.procfleet`
# would import the inference package first and re-execute this module as
# __main__ on top of the already-imported copy (runpy warns)
CHILD_CMD = [sys.executable, "-u", "-c",
             "import sys; from paddle_tpu_torch.inference.procfleet import "
             "replica_main; sys.exit(replica_main())"]


def current_torch_config() -> dict:
    """The parent's bitwise-relevant float32 matmul settings, forwarded
    through the spec so a child reproduces the parent's numerics even when
    the parent set them programmatically (``chip_smoke.py`` turns TF32
    off) rather than through inheritable env vars."""
    return {"float32_matmul_precision": torch.get_float32_matmul_precision(),
            "cuda_matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32)}


def apply_torch_config(cfg: dict) -> None:
    """Set the settings :func:`current_torch_config` read. The precision
    goes first: it resets ``allow_tf32``, which is then set as read."""
    if "float32_matmul_precision" in cfg:
        torch.set_float32_matmul_precision(cfg["float32_matmul_precision"])
    if "cuda_matmul_allow_tf32" in cfg:
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg["cuda_matmul_allow_tf32"])
    if "cudnn_allow_tf32" in cfg:
        torch.backends.cudnn.allow_tf32 = bool(cfg["cudnn_allow_tf32"])


def child_env(extra_env: dict) -> dict:
    """The subprocess environment: current env + spec/rank overrides +
    the forwarded flag VALUES (set_flags changes never reach a plain env
    copy) + a sys.path guarantee that the child can import
    paddle_tpu_torch. ``CUDA_VISIBLE_DEVICES`` passes through unchanged."""
    env = dict(os.environ)
    env.update(extra_env)
    for name in _FLAG_FORWARD:
        v = flag(name)
        env[name] = ("1" if v else "0") if isinstance(v, bool) else str(v)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    return env


# =====================================================================
# child side: one replica subprocess
# =====================================================================

class _Beater(threading.Thread):
    """Daemon thread publishing the replica heartbeat. A thread (not the
    serving loop) so a long model build or first step doesn't read as
    death — readiness is not liveness — while a SIGKILL or segfault silences it instantly.
    ``FLAGS_chaos_replica_hang_ms`` wedges it via ``hang_until``."""

    def __init__(self, hb: Heartbeat, interval: float, state: dict):
        super().__init__(daemon=True, name="procfleet-beat")
        self.hb = hb
        self.interval = interval
        self.state = state          # mutated by the serving loop
        self.hang_until = 0.0
        self.stop_ev = threading.Event()

    def beat_once(self) -> None:
        c = counters("infer.")
        try:
            self.hb.beat(pid=os.getpid(), host=socket.gethostname(),
                         ready=self.state.get("ready", False),
                         ticks=self.state.get("ticks", 0),
                         load=self.state.get("load", 0),
                         compiles=int(c.get("infer.compiles", 0)),
                         aot_cache_hits=int(c.get("infer.aot_cache_hits", 0)),
                         kernels=kernel_launches())
        except OSError:
            pass  # store hiccup: the next beat retries; RetryingStore backs off

    def run(self) -> None:
        self.beat_once()
        while not self.stop_ev.wait(self.interval):
            if time.monotonic() < self.hang_until:
                continue  # chaos hang: alive but silent
            self.beat_once()


def replica_main(spec: Optional[dict] = None) -> int:
    """The replica subprocess entry (:data:`CHILD_CMD`): build model +
    engine + scheduler from the ``PADDLE_PROCFLEET_SPEC`` JSON on the
    spec's ``device`` (none given means the CUDA card, and raises without
    one), register membership, then loop — drain submits, tick the
    scheduler, stream token chunks and tick results back, beat from the
    side thread — until a drain message or SIGTERM/SIGKILL ends it."""
    if spec is None:
        spec = json.loads(os.environ[SPEC_ENV])
    rid = int(spec["rid"])
    ns = spec["ns"]
    host, port = spec["endpoint"].rsplit(":", 1)
    apply_torch_config(spec.get("torch_config") or {})
    device = resolve_device(spec.get("device"))

    from ..distributed.resilience import RetryingStore
    from ..distributed.store import TCPStore
    from ..models.gpt import GPTConfig, GPTForPretraining
    from .engine import DecodeEngine
    from .scheduler import ContinuousBatchingScheduler

    store = RetryingStore(TCPStore(
        host, int(port), is_master=False, world_size=1,
        timeout=float(spec.get("store_timeout", 60.0))))
    state = {"ready": False, "ticks": 0, "load": 0}
    beater = _Beater(Heartbeat(store, ns, rid), float(spec.get("beat_interval", 0.05)), state)
    beater.start()

    # deterministic rebuild: the same seed on the same device type gives
    # bitwise the weights of a parent-side model built the same way
    mspec = spec.get("model", {})
    model = GPTForPretraining(GPTConfig(**mspec.get("config", {})), device=device,
                              seed=int(mspec.get("seed", 0))).eval()
    engine = DecodeEngine(model, **spec.get("engine_kwargs", {}))
    sched = ContinuousBatchingScheduler(engine)

    # hot-path transport: both logical channels share one fast-path socket
    # (installed into conn_box when the parent dials in); until then — and
    # after any socket death — the same channels ride the store
    conn_box: List[Any] = [None]
    in_ch = SocketChannel(store, channel_prefix(ns, rid, "in"), "in",
                          conn_box, rid=rid)
    out_ch = SocketChannel(store, channel_prefix(ns, rid, "out"), "out",
                           conn_box, rid=rid)
    listener = None
    if spec.get("socket", True):
        adv = ("127.0.0.1" if host in ("127.0.0.1", "localhost", "0.0.0.0")
               else socket.gethostname())
        listener = SocketListener(advertise_host=adv)
        # the endpoint must be advertised BEFORE the ready beat: the parent
        # dials exactly once, when it first observes ready
        store.set(sock_key(ns, rid), listener.address)
    store.add(f"procfleet/{ns}/members_n", 1)  # launcher-mode membership
    state["ready"] = True
    beater.beat_once()

    # clock alignment for the merged timeline: offset vs the parent (rank 0)
    try:
        raw = store.get(f"{_trace.EPOCH_KEY_PREFIX}/0/epoch", timeout=5.0)
        own = time.time()
        _runlog.emit("clock_sync", rank=rid + 1, epoch=own,
                     offset=own - float(raw if isinstance(raw, str) else raw.decode()),
                     world_size=0)
    except (TimeoutError, OSError, ValueError):
        pass

    local: Dict[int, Any] = {}   # fid -> scheduler Request
    sent: Dict[int, int] = {}    # fid -> tokens already chunk-streamed
    idle_sleep = float(spec.get("idle_sleep", 0.005))
    while True:
        if listener is not None and conn_box[0] is None:
            conn = listener.try_accept()
            if conn is not None:
                conn_box[0] = conn
        for m in in_ch.recv():
            kind = m["kind"]
            if kind == "submit":
                sched.submit(np.asarray(m["prompt"], np.int32),
                             max_new_tokens=m["max_new_tokens"],
                             eos_token_id=m.get("eos_token_id"),
                             seed=m.get("seed", 0),
                             deadline_s=m.get("deadline_s"),
                             trace_id=m.get("trace"))
                req = sched.queue[-1]  # submit validated + appended it
                local[m["fid"]] = req
                sent[m["fid"]] = 0
            elif kind == "cancel":
                req = local.get(m["fid"])
                if req is not None:
                    sched.cancel(req.rid, status=m.get("status", "cancelled"))
            elif kind == "drain":
                # flip NotReady FIRST: an attach() racing this drain sees a
                # non-ready beat and times out with a structured error
                # instead of adopting a corpse
                state["ready"] = False
                out_ch.send("bye", ticks=state["ticks"])
                beater.beat_once()
                beater.stop_ev.set()
                if listener is not None:
                    listener.close()
                if conn_box[0] is not None:
                    conn_box[0].close()
                store.close()
                return 0
        busy = bool(sched.queue or sched.prefilling or sched.running)
        if busy:
            sched.step()
            state["ticks"] += 1
        finished_fids: List[int] = []
        for fid, req in list(local.items()):
            if len(req.tokens) > sent[fid]:
                out_ch.send("chunk", fid=fid, start=sent[fid],
                            tokens=[int(t) for t in req.tokens[sent[fid]:]],
                            trace=req.trace_id)
                sent[fid] = len(req.tokens)
            if req.status in _TERMINAL:
                out_ch.send("finished", fid=fid, status=req.status,
                            tokens=[int(t) for t in req.tokens],
                            ttft_s=req.ttft_seconds, total_s=req.total_seconds,
                            trace=req.trace_id)
                finished_fids.append(fid)
                del local[fid], sent[fid]
        if not busy and not finished_fids:
            # idle — but only after the report sweep: a cancel() that just
            # emptied the scheduler still owes its terminal message
            time.sleep(idle_sleep)
            continue
        state["load"] = len(sched.queue) + len(sched.prefilling) + len(sched.running)
        out_ch.send("tick", tick=state["ticks"], finished=finished_fids,
                    load=state["load"])
        hang_ms = chaos.replica_hang_due_ms(rid)
        if hang_ms > 0:
            # the zombie shape: the process stays alive, the beat goes dark,
            # and the serving loop wedges — only the parent's stale-beat
            # sweep can tell; it SIGKILLs us mid-sleep
            beater.hang_until = time.monotonic() + hang_ms / 1e3
            time.sleep(hang_ms / 1e3)


# =====================================================================
# parent side: supervisor + ledger + streaming front
# =====================================================================

class ProcReplica:
    """Parent-side handle to one replica subprocess: the Popen (None when
    adopted via :meth:`ProcServingFleet.attach`), its RPC channels, and
    the liveness view (beat-counter motion on the PARENT's monotonic
    clock — wall-clock skew cannot fake a death)."""

    def __init__(self, rid: int, proc: Optional[subprocess.Popen],
                 in_ch: SocketChannel, out_ch: SocketChannel, hb: Heartbeat,
                 conn_box: Optional[list] = None):
        self.rid = int(rid)
        self.proc = proc
        self.in_ch = in_ch
        self.out_ch = out_ch
        self.hb = hb
        self.conn_box = conn_box if conn_box is not None else [None]
        self.sock_tried = False  # the parent dials the fast path exactly once
        self.alive = True
        self.draining = False
        self.death_reason: Optional[str] = None
        self.ticks = 0                   # tick messages harvested
        self.completed = 0
        self.assigned: Set[int] = set()  # fids in flight (parent view)
        self.reported_load = 0
        self.ready = False
        self.beat_n = -1
        self.last_beat = time.monotonic()
        self.pid: Optional[int] = proc.pid if proc is not None else None
        self.host: Optional[str] = None
        self.counters: Dict[str, int] = {}

    def load(self) -> int:
        """In-flight requests from the parent ledger's view (the child's
        own queue depth arrives asynchronously via tick/beat messages)."""
        return len(self.assigned)

    def process_alive(self) -> bool:
        """Liveness of the OS process — catches SIGKILL/segfault before
        any beat goes stale. Adopted cross-host replicas fall back to the
        stale-beat sweep (a remote pid can't be probed)."""
        if self.proc is not None:
            return self.proc.poll() is None
        if self.pid is None or self.host != socket.gethostname():
            return True
        try:
            os.kill(self.pid, 0)
            return True
        except ProcessLookupError:
            return False
        except OSError:
            return True

    def sigkill(self) -> None:
        if self.proc is not None:
            self.proc.kill()
        elif self.pid is not None and self.host == socket.gethostname():
            try:
                os.kill(self.pid, signal.SIGKILL)
            except OSError:
                pass


class TokenStream:
    """The ``submit(stream=True)`` handle: iterating yields in-order token
    chunks (lists of ints) as decode progresses, driving the fleet loop
    between arrivals. Exactly-once across a requeue falls out of the
    ledger: chunks are cut from the monotonic ``FleetRequest.tokens``
    append log, so a mid-stream replica death replays upstream but never
    re-yields, drops, or reorders a delivered token."""

    def __init__(self, fleet: "ProcServingFleet", fid: int):
        self.fleet = fleet
        self.fid = fid
        self.delivered = 0  # tokens yielded so far == the chunk cursor
        # hold the FleetRequest OBJECT, not a ledger lookup: the object is
        # stable across requeues, and the keep-last-k ledger GC must never
        # be able to break a live stream
        self._freq = fleet.requests[fid]

    @property
    def request(self) -> FleetRequest:
        return self._freq

    def __iter__(self):
        while True:
            freq = self.request
            if len(freq.tokens) > self.delivered:
                chunk = [int(t) for t in freq.tokens[self.delivered:]]
                self.delivered += len(chunk)
                yield chunk
                continue
            if freq.status in _TERMINAL:
                return
            self.fleet.step()
            time.sleep(self.fleet.poll_s)


class ProcServingFleet:
    """N replica subprocesses behind the prefix-affinity router, with the
    in-process fleet's kill-safe drain/requeue, deadlines, and shedding —
    but real process isolation: a SIGKILLed, segfaulted, or wedged child
    takes only itself down.

    ``model_config`` (a GPTConfig or its kwargs dict) + ``model_seed`` let
    each child rebuild bitwise-identical weights, with
    ``GPTForPretraining(cfg, device, seed=model_seed)``, on ``device``
    (the CUDA card unless the caller passes ``device="cpu"``; without CUDA
    and without it the constructor raises); every ``engine_kwargs`` knob is
    shared. The children's beats report their per-process counters — see
    :meth:`child_counters`.

    ``heartbeat_timeout`` (seconds) is the stale-beat window: a replica
    whose beat counter hasn't moved for that long is declared dead even if
    its process is still up (the hang case). Process exit is always death,
    detected on the next :meth:`step`. ``max_queue_depth`` bounds TOTAL
    in-flight requests across alive replicas (the parent cannot see a
    child's internal queue synchronously, so admission counts its own
    ledger); past it :meth:`submit` sheds with
    :class:`~.fleet.FleetOverloadError`.
    """

    def __init__(self, model_config=None, *, model_seed: int = 0,
                 replicas: int = 2, max_queue_depth: int = 64,
                 heartbeat_timeout: float = 5.0, endpoint: Optional[str] = None,
                 ns: Optional[str] = None, boot_timeout: float = 120.0,
                 beat_interval: float = 0.05, poll_s: float = 0.002,
                 affinity_load_slack: int = 2, spawn: bool = True,
                 keep_finished: int = 256, use_sockets: bool = True,
                 device=None, **engine_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got {max_queue_depth}")
        if keep_finished < 1:
            raise ValueError(f"keep_finished must be >= 1, got {keep_finished}")
        if flag("FLAGS_compile_cache_dir"):
            raise NotImplementedError(
                "the on-disk AOT cache of serving programs (FLAGS_compile_cache_dir) is "
                "not ported to paddle_tpu_torch; it is queued in ROADMAP.md (Queue 1, "
                "item 4: the serving stack)")
        self.device = str(resolve_device(device))
        if model_config is None:
            self.model_config: Dict[str, Any] = {}
        elif isinstance(model_config, dict):
            self.model_config = dict(model_config)
        else:
            self.model_config = model_config.to_dict()
        self.model_seed = int(model_seed)
        self.engine_kwargs = dict(engine_kwargs)
        # the replica spec crosses a process boundary as JSON: a draft model
        # config must travel as its constructor kwargs (each replica rebuilds
        # it bitwise from draft_seed); a live model object cannot
        draft = self.engine_kwargs.get("draft")
        if draft is not None:
            if hasattr(draft, "to_dict"):
                self.engine_kwargs["draft"] = draft.to_dict()
            elif not isinstance(draft, dict):
                raise TypeError(
                    "ProcServingFleet needs draft= as a GPTConfig or a dict of "
                    "GPTConfig kwargs (replica subprocesses rebuild it from "
                    "draft_seed); a model instance does not serialize")
        self.max_queue_depth = int(max_queue_depth)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.boot_timeout = float(boot_timeout)
        self.beat_interval = float(beat_interval)
        self.poll_s = float(poll_s)
        # socket fast path: children advertise a framed-TCP endpoint the
        # parent dials once ready; False pins everything to the store
        # transport (the bench's socket_vs_store_overhead_pct baseline arm)
        self.use_sockets = bool(use_sockets)
        self.router = Router(chunk=engine_kwargs.get("prefill_chunk"),
                             affinity_load_slack=affinity_load_slack)

        from ..distributed.resilience import RetryingStore
        from ..distributed.store import TCPStore

        self._own_store = endpoint is None
        if self._own_store:
            raw_store = TCPStore("127.0.0.1", 0, is_master=True,
                                 world_size=1, timeout=60.0)
            endpoint = f"127.0.0.1:{raw_store.port}"
        else:
            host, port = endpoint.rsplit(":", 1)
            # a dead endpoint must fail within the caller's boot budget,
            # not the store client's own (longer) default connect window
            raw_store = TCPStore(host, int(port), is_master=False,
                                 world_size=1,
                                 timeout=min(60.0, self.boot_timeout))
        self._raw_store = raw_store
        self._store = RetryingStore(raw_store)
        self.endpoint = endpoint
        if ns is None:
            _ns_counter[0] += 1
            ns = f"{os.getpid():x}-{_ns_counter[0]}"
        self.ns = ns

        self.keep_finished = int(keep_finished)
        self.replicas: Dict[int, ProcReplica] = {}
        # terminal entries are GC'd past keep-last-k each tick (in-flight
        # never evicted; live TokenStreams hold the request object)
        self.requests: Dict[int, FleetRequest] = {}
        self._chunks: Dict[int, int] = {}       # fid -> chunk seq applied
        self.finished_total = 0                 # completions ever, across GC
        self._next_fid = 0
        self._next_rid = 0
        self.requeues = 0
        # recent completion timestamps (monotonic) — the finish-rate window
        # behind FleetOverloadError.retry_after_s and the ingress backoff
        import collections as _collections

        self._finish_times = _collections.deque(maxlen=64)
        self._pending_done: List[FleetRequest] = []
        self._requeue_backlog: List[int] = []
        self._draining = False
        self._shut = False

        # rank-0 epoch for the children's clock_sync offsets
        try:
            self._store.set(f"{_trace.EPOCH_KEY_PREFIX}/0/epoch", repr(time.time()))
        except OSError:
            pass
        if spawn:
            for _ in range(int(replicas)):
                self._spawn_replica()
            self._wait_ready(list(self.replicas))
        self._emit_membership()

    # --------------------------------------------------------- attach mode
    @classmethod
    def attach(cls, endpoint: str, replicas: Optional[int] = None, *,
               ns: str = "serve", **kw) -> "ProcServingFleet":
        """Adopt replicas already booted by another supervisor (each a
        ``replica_main`` under this ``ns``; the reference's ``launch
        --serve`` is not ported) instead of spawning: connect to the store at
        ``endpoint``, wait for the store-registered membership, and serve
        through them. ``replicas=None`` reads the member count the children
        registered. Supervision still applies — same-host pids are probed,
        everything else rides the stale-beat sweep."""
        kw = dict(kw, spawn=False)
        fleet = cls(endpoint=endpoint, ns=ns, replicas=1, **kw)
        if replicas is None:
            deadline = time.monotonic() + fleet.boot_timeout
            while True:
                n = int(fleet._store.add(f"procfleet/{ns}/members_n", 0))
                if n > 0:
                    replicas = n
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"procfleet attach: no members registered under ns {ns!r}")
                time.sleep(0.05)
        for rid in range(int(replicas)):
            fleet._adopt_replica(rid)
        fleet._wait_ready(list(fleet.replicas))
        fleet._emit_membership()
        return fleet

    # ------------------------------------------------------------ replicas
    def _make_replica(self, rid: int, proc) -> ProcReplica:
        conn_box: list = [None]
        rep = ProcReplica(
            rid, proc,
            in_ch=SocketChannel(self._store, channel_prefix(self.ns, rid, "in"),
                                "in", conn_box, rid=rid),
            out_ch=SocketChannel(self._store, channel_prefix(self.ns, rid, "out"),
                                 "out", conn_box, rid=rid),
            hb=Heartbeat(self._store, self.ns, rid),
            conn_box=conn_box)
        self.replicas[rid] = rep
        return rep

    def _maybe_connect_socket(self, rep: ProcReplica) -> None:
        """Dial the replica's advertised fast-path socket — exactly once,
        the first time it is seen ready (its sock key is published before
        the ready beat, so one attempt suffices). Failure or a missing
        advertisement just leaves the channels on the store transport."""
        if not self.use_sockets or rep.sock_tried or not rep.ready:
            return
        rep.sock_tried = True
        conn = connect_socket(self._store, self.ns, rep.rid)
        if conn is not None:
            rep.conn_box[0] = conn

    def _spawn_replica(self) -> ProcReplica:
        rid = self._next_rid
        self._next_rid += 1
        spec = {"rid": rid, "ns": self.ns, "endpoint": self.endpoint,
                "model": {"kind": "gpt", "seed": self.model_seed,
                          "config": self.model_config},
                "engine_kwargs": self.engine_kwargs,
                "beat_interval": self.beat_interval,
                "socket": self.use_sockets, "device": self.device,
                "torch_config": current_torch_config()}
        # PADDLE_TRAINER_ID decorrelates the child's trace/span id streams
        # from the parent (rank 0) and its siblings — launcher discipline
        env = child_env({SPEC_ENV: json.dumps(spec),
                         "PADDLE_TRAINER_ID": str(rid + 1)})
        proc = subprocess.Popen(CHILD_CMD, env=env)
        return self._make_replica(rid, proc)

    def _adopt_replica(self, rid: int) -> ProcReplica:
        self._next_rid = max(self._next_rid, rid + 1)
        return self._make_replica(rid, None)

    def _wait_ready(self, rids: List[int]) -> None:
        """Block until every listed replica published a ready beat (its
        model and engine are built). A child that exits while booting fails
        loudly here."""
        deadline = time.monotonic() + self.boot_timeout
        waiting = set(rids)
        while waiting:
            for rid in sorted(waiting):
                rep = self.replicas[rid]
                if rep.proc is not None and rep.proc.poll() is not None:
                    raise RuntimeError(
                        f"procfleet: replica {rid} exited rc={rep.proc.returncode} during boot")
                doc = rep.hb.read(timeout=0.05)
                if doc is not None and doc.get("ready"):
                    self._observe_beat(rep, doc)
                    self._maybe_connect_socket(rep)
                    waiting.discard(rid)
            if waiting and time.monotonic() > deadline:
                raise TimeoutError(
                    f"procfleet: replica(s) {sorted(waiting)} not ready after "
                    f"{self.boot_timeout:g}s")
            if waiting:
                time.sleep(0.05)

    def _alive(self) -> Dict[int, ProcReplica]:
        return {rid: rep for rid, rep in self.replicas.items() if rep.alive}

    def _emit_membership(self) -> None:
        alive = sorted(self._alive())
        dead = sorted(set(self.replicas) - set(alive))
        gauge_set("fleet.replicas_alive", len(alive))
        gauge_set("fleet.replicas_dead", len(dead))
        _runlog.emit("fleet", kind="membership", component="procfleet",
                     alive=alive, dead=dead)

    def scale_out(self, n: int = 1) -> List[int]:
        """Add ``n`` replica subprocesses live; each boots cold (no AOT
        cache in the port)."""
        new = [self._spawn_replica().rid for _ in range(int(n))]
        self._wait_ready(new)
        counter_inc("fleet.scale_outs", len(new))
        _runlog.emit("fleet", kind="scale_out", component="procfleet", replicas=new)
        self._emit_membership()
        return new

    def kill_replica(self, rid: int, reason: str = "killed") -> None:
        """Administrative SIGKILL — the real-process form of the chaos
        kill. In-flight work requeues onto the survivors."""
        rep = self.replicas[rid]
        rep.sigkill()
        if rep.alive:
            self._on_replica_death(rep, RuntimeError(reason))

    def child_counters(self) -> Dict[int, Dict[str, int]]:
        """Per-replica counters as last self-reported through heartbeats:
        ``compiles`` and ``aot_cache_hits`` (the ``infer.*`` warm-up
        counters) and ``kernels.<name>``, each kernel's launches in that
        process — per-PROCESS state the parent's registry never sees."""
        return {rid: dict(rep.counters) for rid, rep in self.replicas.items()}

    # ----------------------------------------------------------- admission
    def queue_depth(self) -> int:
        """Total in-flight requests across alive replicas — the parent's
        synchronous view (a child's internal queue split arrives on its
        next tick message), and what admission compares to
        ``max_queue_depth``."""
        return sum(rep.load() for rep in self._alive().values())

    def finish_rate(self) -> Optional[float]:
        """Recent completions per second over the sliding finish window
        (None until two completions exist) — the denominator of
        :func:`~.fleet.retry_after_estimate`."""
        t = self._finish_times
        if len(t) < 2 or t[-1] <= t[0]:
            return None
        return (len(t) - 1) / (t[-1] - t[0])

    def transport_lag(self) -> Dict[str, float]:
        """Transport-health watermarks for ingress backpressure:
        ``out_backlog`` is the deepest unacknowledged fast-path send window
        across alive replicas (how far the wire is behind the writers) and
        ``beat_age_s`` the stalest alive heartbeat on the parent's clock.
        Either climbing past the ingress watermarks means the fleet is
        falling behind its transport — shed before the queues do it."""
        alive = [rep for rep in self.replicas.values() if rep.alive]
        beat = max(((time.monotonic() - rep.last_beat) for rep in alive),
                   default=0.0)
        backlog = max((float(rep.in_ch.backlog() + rep.out_ch.backlog())
                       for rep in alive), default=0.0)
        return {"out_backlog": backlog, "beat_age_s": float(beat)}

    def tokens_so_far(self, fid: int) -> List[int]:
        """Live view of ``fid``'s generated tokens — the append-only chunk
        ledger, which grows as stream chunks arrive. The ingress streams
        from this (same cursor discipline as :class:`TokenStream`)."""
        return list(self.requests[fid].tokens)

    def submit(self, prompt, max_new_tokens: int = 16,
               eos_token_id: Optional[int] = None, seed: int = 0,
               deadline_s: Optional[float] = None,
               replica: Optional[int] = None, stream: bool = False):
        """Route one prompt into the fleet. Returns the fleet request id,
        or — with ``stream=True`` — a :class:`TokenStream` yielding
        in-order token chunks as they arrive (``.fid`` has the id).
        Semantics otherwise match :meth:`ServingFleet.submit`: admission
        control first, prefix-affinity placement (``replica=`` pins),
        ``deadline_s`` bounding total time across requeues."""
        alive = self._alive()
        if not alive:
            raise FleetDrainedError(sorted(
                fid for fid, r in self.requests.items()
                if r.status in ("queued", "prefilling", "running")))
        depth = self.queue_depth()
        if depth >= self.max_queue_depth:
            counter_inc("fleet.sheds")
            _runlog.emit("fleet", kind="shed", component="procfleet",
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
        self._chunks[fid] = 0
        _runlog.emit("fleet", kind="submitted", component="procfleet", id=fid,
                     trace=freq.trace_id, prompt_tokens=len(freq.prompt),
                     max_new_tokens=freq.max_new_tokens, stream=bool(stream))
        self._place(freq, rid, reason)
        counter_inc("fleet.requests_submitted")
        gauge_set("fleet.queue_depth", self.queue_depth())
        return TokenStream(self, fid) if stream else fid

    def cancel(self, fid: int, status: str = "cancelled") -> bool:
        """Forward a cancellation to the replica holding ``fid``. The
        child's scheduler frees the slot mid-decode; the terminal status
        arrives back on its next tick."""
        freq = self.requests.get(fid)
        if freq is None or freq.status in _TERMINAL or freq.replica is None:
            return False
        rep = self.replicas.get(freq.replica)
        if rep is None or not rep.alive:
            return False
        rep.in_ch.send("cancel", fid=fid, status=status)
        return True

    def _place(self, freq: FleetRequest, rid: int, reason: str,
               deadline_s: Optional[float] = "unset") -> None:
        """Ship ``freq`` to replica ``rid`` over RPC and index it in the
        parent ledger. The envelope carries the trace id so the child's
        request/span events join the same distributed trace."""
        rep = self.replicas[rid]
        if deadline_s == "unset":
            deadline_s = freq.deadline_s
        rep.in_ch.send(
            "submit", fid=freq.fid, prompt=[int(t) for t in freq.prompt],
            max_new_tokens=freq.max_new_tokens, eos_token_id=freq.eos_token_id,
            seed=freq.seed, deadline_s=deadline_s, trace=freq.trace_id)
        self.router.register(freq.prompt, rid)
        freq.replica = rid
        freq.status = "running"
        rep.assigned.add(freq.fid)
        _runlog.emit("fleet", kind="placed", component="procfleet", id=freq.fid,
                     replica=rid, reason=reason, attempt=freq.attempts,
                     trace=freq.trace_id)

    # ----------------------------------------------------------- the loop
    def step(self) -> List[FleetRequest]:
        """One supervision tick: harvest every alive replica's out-channel
        (tick results, token chunks, completions), fire any armed SIGKILL
        chaos, then run the two death detectors — process liveness and the
        stale-beat sweep. Returns fleet requests finished this tick."""
        done: List[FleetRequest] = self._pending_done
        self._pending_done = []
        for rid, rep in list(self.replicas.items()):
            if not rep.alive:
                continue
            self._maybe_connect_socket(rep)
            try:
                msgs = rep.out_ch.recv()
            except (TimeoutError, OSError) as exc:
                self._drain_and_die(rep, exc, done)
                continue
            self._apply(rep, msgs, done)
            if chaos.replica_sigkill_due(rid, rep.ticks):
                rep.sigkill()  # a real kill -9, mid-decode
            if not rep.process_alive():
                rc = rep.proc.returncode if rep.proc is not None else None
                self._drain_and_die(rep, RuntimeError(
                    f"replica process died (rc={rc})"), done)
                continue
            self._sweep_beat(rep, done)
        gauge_set("fleet.queue_depth", self.queue_depth())
        beats = [time.monotonic() - rep.last_beat
                 for rep in self.replicas.values() if rep.alive]
        if beats:
            gauge_set("fleet.heartbeat_staleness_seconds", max(beats))
        _slo.on_tick()  # judgment layer: a single flag check until armed
        self._gc_ledger(protect={r.fid for r in done})
        if _sanitizer.enabled():
            # post-GC the ledger is keep-last-k + in-flight
            _sanitizer.note_ledger(
                "procfleet", "requests", len(self.requests),
                bound=2 * self.keep_finished + self.max_queue_depth)
        return done

    def _gc_ledger(self, protect=()) -> None:
        """Keep-last-k GC of delivered requests (and their chunk cursors):
        evict the OLDEST terminal entries past ``keep_finished``. In-flight
        entries are untouched — requeue/exactly-once accounting reads the
        ledger only for live fids — and this tick's completions are
        protected so :meth:`step`'s return is harvested before eviction."""
        protect = set(protect)
        terminal = [fid for fid, r in self.requests.items()
                    if r.status in _TERMINAL and fid not in protect]
        overflow = len(terminal) - self.keep_finished
        for fid in terminal[:max(0, overflow)]:
            del self.requests[fid]
            self._chunks.pop(fid, None)

    def _sweep_beat(self, rep: ProcReplica, done: List[FleetRequest]) -> None:
        doc = rep.hb.read(timeout=0.02)
        if doc is not None:
            self._observe_beat(rep, doc)
        if (self.heartbeat_timeout and rep.ready
                and time.monotonic() - rep.last_beat > self.heartbeat_timeout):
            # process is up but the beat counter stopped moving: a zombie
            # (FLAGS_chaos_replica_hang_ms, a wedged dispatch). Same
            # protocol as death — and the parent reaps the husk.
            self._drain_and_die(rep, TimeoutError(
                f"heartbeat lost: no beat for > {self.heartbeat_timeout:g}s"),
                done)

    def _observe_beat(self, rep: ProcReplica, doc: dict) -> None:
        if doc.get("n", 0) != rep.beat_n:
            rep.beat_n = doc.get("n", 0)
            rep.last_beat = time.monotonic()
        rep.ready = rep.ready or bool(doc.get("ready"))
        rep.pid = doc.get("pid", rep.pid)
        rep.host = doc.get("host", rep.host)
        rep.counters = {k: int(doc.get(k, 0))
                        for k in ("compiles", "aot_cache_hits")}
        rep.counters.update({f"kernels.{name}": int(n)
                             for name, n in (doc.get("kernels") or {}).items()})
        rep.reported_load = int(doc.get("load", rep.reported_load))

    def _apply(self, rep: ProcReplica, msgs: List[dict],
               done: List[FleetRequest]) -> None:
        for m in msgs:
            kind = m["kind"]
            if kind == "tick":
                rep.ticks += 1
                rep.reported_load = int(m.get("load", rep.reported_load))
            elif kind == "chunk":
                self._apply_chunk(rep, m)
            elif kind == "finished":
                self._apply_finished(rep, m, done)
            elif kind == "bye":
                rep.draining = True

    def _apply_chunk(self, rep: ProcReplica, m: dict) -> None:
        """Extend the delivery ledger with one streamed chunk. The ledger
        is append-only and the channel is ordered, so the only interesting
        case is the post-requeue replay: a survivor re-streams from
        position 0 and only the suffix past what was already delivered is
        appended — no duplicates, no gaps, no reordering, ever."""
        freq = self.requests.get(m["fid"])
        if freq is None or freq.status in _TERMINAL or freq.replica != rep.rid:
            return
        start, toks = int(m["start"]), m["tokens"]
        have = len(freq.tokens)
        if start > have:
            return  # a gap can only mean a lost writer; the replay heals it
        new = toks[have - start:]
        if not new:
            return
        if freq.first_token_ts is None:
            freq.first_token_ts = time.perf_counter()
        freq.tokens.extend(int(t) for t in new)
        self._chunks[freq.fid] = self._chunks.get(freq.fid, 0) + 1
        counter_inc("fleet.stream_chunks")

    def _apply_finished(self, rep: ProcReplica, m: dict,
                        done: List[FleetRequest]) -> None:
        fid = m["fid"]
        freq = self.requests.get(fid)
        if freq is None or fid not in rep.assigned:
            return
        rep.assigned.discard(fid)
        status = m["status"]
        if status != "finished":
            freq.status = status
            freq.finished_ts = time.perf_counter()
            if status == "deadline_exceeded":
                counter_inc("fleet.deadline_hits")
            _runlog.emit("fleet",
                         kind=("deadline" if status == "deadline_exceeded"
                               else "cancelled"),
                         component="procfleet", id=fid, replica=rep.rid,
                         status=status, trace=freq.trace_id)
            return
        if freq.status == "finished":
            return  # exactly-once: the ledger was already written
        final = [int(t) for t in m["tokens"]]
        if final[:len(freq.tokens)] != list(freq.tokens):
            # bitwise contract violated — never silently rewrite what a
            # stream already delivered; surface it for the postmortem
            _runlog.emit("fleet", kind="stream_divergence", component="procfleet",
                         id=fid, replica=rep.rid, delivered=len(freq.tokens),
                         trace=freq.trace_id)
        freq.tokens.extend(final[len(freq.tokens):])
        freq.status = "finished"
        freq.finished_ts = time.perf_counter()
        if freq.first_token_ts is None:
            freq.first_token_ts = freq.finished_ts
        rep.completed += 1
        self.finished_total += 1
        self._finish_times.append(time.monotonic())
        counter_inc("fleet.requests_completed")
        observe("fleet.latency_seconds", freq.total_seconds)
        _runlog.emit("fleet", kind="finished", component="procfleet", id=fid,
                     replica=rep.rid, new_tokens=len(freq.tokens),
                     seconds=freq.total_seconds, attempts=freq.attempts,
                     chunks=self._chunks.get(fid, 0), trace=freq.trace_id)
        done.append(freq)

    # ------------------------------------------------------ death + requeue
    def _drain_and_die(self, rep: ProcReplica, exc: BaseException,
                       done: List[FleetRequest]) -> None:
        """Final harvest, then the death protocol. Anything the child
        published before dying — including a completion — is applied
        first: a request it finished is DELIVERED from that harvest and
        never replayed (the exactly-once seam for real process death)."""
        try:
            self._apply(rep, rep.out_ch.recv(), done)
        except (TimeoutError, OSError):
            pass
        if rep.alive:
            self._on_replica_death(rep, exc)

    def _on_replica_death(self, rep: ProcReplica, exc: BaseException) -> None:
        """Mark dead, reap, forget chains, requeue from the parent ledger.
        Re-entrant: a survivor dying while absorbing requeued work lands
        its pending fids on the shared backlog and returns — the outermost
        drain loop owns placement, so cascade kills keep full
        ``FleetDrainedError`` lost-fid accounting (same protocol as
        ``ServingFleet._on_replica_death``)."""
        rep.alive = False
        rep.death_reason = f"{type(exc).__name__}: {exc}"
        counter_inc("fleet.replica_deaths")
        rep.sigkill()  # reap the husk: hung children must not linger
        if rep.conn_box[0] is not None:
            rep.conn_box[0].kill("replica dead")
        self.router.forget_replica(rep.rid)
        pending = sorted(rep.assigned)
        rep.assigned = set()
        lost_traces = sorted({t for t in (
            self.requests[fid].trace_id for fid in pending) if t is not None})
        _runlog.emit("fleet", kind="replica_dead", component="procfleet",
                     replica=rep.rid, reason=rep.death_reason, pid=rep.pid,
                     inflight=len(pending), traces=lost_traces)
        _flightrec.dump("replica_death", exc, replica=rep.rid, pid=rep.pid,
                        inflight=pending, traces=lost_traces)
        self._emit_membership()
        self._requeue_backlog.extend(pending)
        if self._draining:
            return  # the outermost drain loop absorbs the new backlog
        self._draining = True
        try:
            lost: List[int] = []
            while self._requeue_backlog:
                fid = self._requeue_backlog.pop(0)
                survivors = self._alive()
                if not survivors:
                    lost.append(fid)
                    continue
                self._requeue(self.requests[fid], survivors)
            if lost:
                raise FleetDrainedError(sorted(lost))
        finally:
            self._draining = False

    def _requeue(self, freq: FleetRequest,
                 survivors: Dict[int, ProcReplica]) -> None:
        """Replay one request lost to a replica death on a survivor:
        original prompt + seed (bitwise-identical tokens — sampling folds
        on request seed and absolute position, never slot or process) with
        the REMAINING deadline. Tokens already stream-delivered stay in
        the ledger; the replay's chunks only extend past them."""
        remaining = freq.deadline_s
        if freq.deadline_s is not None:
            remaining = freq.deadline_s - (time.perf_counter() - freq.submitted_ts)
            if remaining <= 0:
                freq.status = "deadline_exceeded"
                freq.finished_ts = time.perf_counter()
                counter_inc("fleet.deadline_hits")
                _runlog.emit("fleet", kind="deadline", component="procfleet",
                             id=freq.fid, replica=freq.replica,
                             status="deadline_exceeded", trace=freq.trace_id)
                return
        freq.attempts += 1
        self.requeues += 1
        counter_inc("fleet.requeues")
        rid, reason = self.router.place(
            freq.prompt, {r: rep.load() for r, rep in survivors.items()})
        _runlog.emit("fleet", kind="requeue", component="procfleet", id=freq.fid,
                     replica=rid, from_replica=freq.replica, reason=reason,
                     trace=freq.trace_id)
        self._place(freq, rid, f"requeue/{reason}", deadline_s=remaining)

    # ------------------------------------------------------------- driving
    def _outstanding(self) -> bool:
        return any(r.status in ("queued", "prefilling", "running")
                   for r in self.requests.values())

    def run(self, max_ticks: Optional[int] = None,
            timeout_s: Optional[float] = None) -> Dict[int, FleetRequest]:
        """Drive :meth:`step` until every accepted request reaches a
        terminal status (or ``max_ticks``/``timeout_s``); returns
        ``{fid: FleetRequest}`` for every completion of the run —
        accumulated across ticks, so requests the keep-last-k ledger GC has
        since evicted are still returned."""
        done = {fid: r for fid, r in self.requests.items()
                if r.status == "finished"}
        ticks = 0
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while self._outstanding() and self._alive():
            for r in self.step():
                done[r.fid] = r
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
            if deadline is not None and time.monotonic() > deadline:
                break
            time.sleep(self.poll_s)
        done.update({fid: r for fid, r in self.requests.items()
                     if r.status == "finished"})
        return done

    # ------------------------------------------------------------ teardown
    def shutdown(self, grace: float = 5.0) -> None:
        """Drain: ask every alive child to exit, wait ``grace``, then
        escalate to SIGTERM/SIGKILL; finally close the store."""
        if self._shut:
            return
        self._shut = True
        for rep in self._alive().values():
            try:
                rep.in_ch.send("drain")
            except OSError:
                pass
        deadline = time.monotonic() + grace
        procs = [rep.proc for rep in self.replicas.values() if rep.proc is not None]
        while time.monotonic() < deadline and any(p.poll() is None for p in procs):
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        try:
            self._raw_store.close()
        except OSError:
            pass

    def __enter__(self) -> "ProcServingFleet":
        return self

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False

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
                "pid": rep.pid,
                "ticks": rep.ticks,
                "completed": rep.completed,
                "load": rep.load(),
                "counters": dict(rep.counters),
                "death_reason": rep.death_reason,
                "transport": {
                    "socket": (rep.conn_box[0] is not None
                               and rep.conn_box[0].alive),
                    "socket_msgs": rep.in_ch.socket_msgs + rep.out_ch.socket_msgs,
                    "store_msgs": rep.in_ch.store_msgs + rep.out_ch.store_msgs,
                    "fallbacks": rep.in_ch.fallbacks + rep.out_ch.fallbacks,
                },
            } for rid, rep in self.replicas.items()},
        }

"""Resilient network ingress of the port (a copy of
``paddle_tpu/inference/ingress.py``): the HTTP front door over the serving
fleet.

It puts a real network boundary in front of
:class:`~.procfleet.ProcServingFleet` / :class:`~.fleet.ServingFleet` using
nothing but the stdlib HTTP server, and carries the fleet's failure
semantics through it intact:

- **POST /v1/generate** — JSON in; either a complete JSON answer or a
  chunked-transfer **per-token stream** (one JSON line per chunk) riding
  the same append-only ``FleetRequest.tokens`` ledger as
  :class:`~.procfleet.TokenStream` — so a replica ``kill -9`` mid-stream
  requeues upstream and the HTTP client still receives every token
  exactly once, bitwise-identical to an unkilled run.
- **idempotency keys** — an ``Idempotency-Key`` header (or
  ``idempotency_key`` body field) maps onto the fleet ledger: an
  at-least-once client retry of the same key returns the SAME request's
  result (held by object reference, so ledger GC cannot break it) and
  never double-generates.
- **deadlines** — ``deadline_s`` propagates into the scheduler's deadline
  sweep; an expired request frees its slot mid-decode and answers with
  its terminal status.
- **client disconnect → cancel** — a dropped socket (detected by peeking
  the connection between chunks, or a failed write) cancels the request
  mid-decode through the fleet, freeing its slot for live traffic.
- **backpressure** — admission rejects with structured statuses instead
  of queueing without bound: fleet overload (429 +
  ``Retry-After`` from :func:`~.fleet.retry_after_estimate`), transport
  lag past the watermarks — unacknowledged fast-path backlog or stale
  heartbeats (503), drain in progress (503).
- **graceful drain** — SIGTERM stops admission, flips ``/healthz`` to 503
  (an external LB stops routing first), lets in-flight requests finish
  within ``drain_grace`` (cancelling stragglers), then exits 0.

Fleet mutations are not thread-safe, so a single **driver thread** owns
the fleet: it runs the ``step()`` loop and executes submit/cancel/read
ops posted by HTTP handler threads (each op a closure + completion
event). With an in-process fleet on the card, every engine call — and so
every CUDA launch — runs on that one thread. Handler threads otherwise only READ the ledger objects they were
handed — the same GC-safe object-reference discipline TokenStream uses.

``FLAGS_chaos_ingress_disconnect_at`` makes the disconnect path
deterministic: the ingress force-drops the client connection after N
streamed chunks, which must turn into a mid-decode cancel.
"""
from __future__ import annotations

import json
import queue
import select
import signal
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ..observability import runlog as _runlog
from ..observability.metrics import counter_inc, gauge_set, observe
from ..testing import chaos
from .fleet import (FleetDrainedError, FleetOverloadError,
                    retry_after_estimate)

__all__ = ["ServingIngress"]

_TERMINAL = ("finished", "cancelled", "deadline_exceeded")


class _FleetDriver(threading.Thread):
    """The one thread allowed to touch the fleet. Runs ``fleet.step()``
    continuously and executes posted ops between steps; HTTP handler
    threads block on :meth:`call` for their result. A ``FleetDrainedError``
    raised by the step loop (every replica dead) is latched in
    :attr:`dead` so waiting handlers fail over to 503 instead of hanging
    on requests that can never finish."""

    def __init__(self, fleet, poll_s: float = 0.002):
        super().__init__(daemon=True, name="ingress-driver")
        self.fleet = fleet
        self.poll_s = float(poll_s)
        self.ops: "queue.Queue" = queue.Queue()
        self.stop_ev = threading.Event()
        self.dead: Optional[BaseException] = None
        self.lost: set = set()   # fids FleetDrainedError reported unrecoverable

    def call(self, fn, timeout: float = 30.0):
        """Run ``fn()`` on the driver thread; return its result or raise
        its exception here."""
        if not self.is_alive():
            raise RuntimeError("ingress: fleet driver is not running")
        ev = threading.Event()
        box: Dict[str, Any] = {}
        self.ops.put((fn, ev, box))
        if not ev.wait(timeout):
            raise TimeoutError("ingress: fleet driver did not answer")
        if "exc" in box:
            raise box["exc"]
        return box.get("ret")

    def _step(self) -> None:
        try:
            self.fleet.step()
        except FleetDrainedError as exc:
            self.dead = exc
            self.lost.update(exc.lost)

    def run(self) -> None:
        while not self.stop_ev.is_set():
            drained_ops = False
            while True:
                try:
                    fn, ev, box = self.ops.get_nowait()
                except queue.Empty:
                    break
                drained_ops = True
                try:
                    box["ret"] = fn()
                except BaseException as exc:  # handed to the calling thread
                    box["exc"] = exc
                ev.set()
            self._step()
            if not drained_ops:
                time.sleep(self.poll_s)


class ServingIngress:
    """Stdlib HTTP/1.1 front door over a serving fleet.

    ::

        fleet = ProcServingFleet(GPTConfig.tiny(), replicas=2, ...)
        with ServingIngress(fleet, port=8080) as ing:
            ing.serve_until_drained()   # SIGTERM => graceful drain, rc 0

    API surface:

    - ``POST /v1/generate`` — body ``{"prompt": [ints],
      "max_new_tokens": n, "eos_token_id": t?, "seed": s?,
      "deadline_s": d?, "stream": bool?, "idempotency_key": k?}``
      (``Idempotency-Key`` header also honored). Non-streaming answers
      one JSON object; ``stream: true`` answers chunked transfer, one
      JSON line per token chunk, then a terminal ``{"done": ...}`` line.
    - ``GET /healthz`` — 200 while accepting, 503 once draining or the
      fleet is dead (flip-first so an external LB stops routing before
      the drain starts cancelling).
    - ``GET /stats`` — fleet + ingress stats as JSON.

    ``backlog_watermark`` / ``beat_watermark_s`` are the transport-lag
    shed thresholds read from ``fleet.transport_lag()``; ``drain_grace``
    bounds how long a SIGTERM drain waits for in-flight requests before
    cancelling them."""

    def __init__(self, fleet, host: str = "127.0.0.1", port: int = 0, *,
                 drain_grace: float = 10.0, backlog_watermark: int = 512,
                 beat_watermark_s: Optional[float] = None,
                 request_timeout: float = 120.0, idem_keep: int = 1024,
                 start: bool = True):
        self.fleet = fleet
        self.host = host
        self.drain_grace = float(drain_grace)
        self.backlog_watermark = int(backlog_watermark)
        self.beat_watermark_s = beat_watermark_s
        self.request_timeout = float(request_timeout)
        self.idem_keep = int(idem_keep)
        self._idem: Dict[str, Any] = {}       # key -> FleetRequest (by ref)
        self._active: set = set()             # fids being served right now
        self._lock = threading.Lock()
        self._draining = False
        self._drain_ev = threading.Event()
        self._stopped = False
        self.exit_code: Optional[int] = None
        self.driver = _FleetDriver(fleet, poll_s=getattr(fleet, "poll_s", 0.002))
        self._server = ThreadingHTTPServer((host, int(port)),
                                           _make_handler(self))
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name="ingress-http")
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServingIngress":
        if not self.driver.is_alive():
            self.driver.start()
        if not self._server_thread.is_alive():
            self._server_thread.start()
        _runlog.emit("ingress", kind="started", host=self.host, port=self.port)
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT begin a graceful drain (main thread only)."""
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: self.begin_drain())

    def begin_drain(self) -> None:
        """Flip to NotReady and stop admitting; the actual drain runs in
        :meth:`drain` / :meth:`serve_until_drained`. Safe from a signal
        handler and idempotent."""
        if not self._draining:
            self._draining = True
            counter_inc("ingress.drains")
            _runlog.emit("ingress", kind="drain_begin",
                         inflight=len(self._active))
        self._drain_ev.set()

    def drain(self, grace: Optional[float] = None) -> int:
        """Graceful drain: stop accepting (healthz already 503), wait for
        in-flight requests to finish within ``grace``, cancel stragglers,
        stop the server + driver. Returns the process exit code (0)."""
        self.begin_drain()
        grace = self.drain_grace if grace is None else float(grace)
        t0 = time.monotonic()
        deadline = t0 + grace
        while self._active and time.monotonic() < deadline:
            time.sleep(0.02)
        leftovers = sorted(self._active)
        for fid in leftovers:
            try:
                self.driver.call(lambda f=fid: self.fleet.cancel(f), timeout=5.0)
            except Exception:
                pass  # best-effort: the handler's wait loop still unblocks below
        # give cancelled handlers a moment to flush their terminal response
        deadline = time.monotonic() + 2.0
        while self._active and time.monotonic() < deadline:
            time.sleep(0.02)
        self.stop()
        _runlog.emit("ingress", kind="drain_done",
                     seconds=time.monotonic() - t0,
                     cancelled=len(leftovers))
        self.exit_code = 0
        return 0

    def serve_until_drained(self, install_signals: bool = True) -> int:
        """Block until a drain is requested (SIGTERM/SIGINT or
        :meth:`begin_drain`), run it, return the exit code (0)."""
        if install_signals:
            self.install_signal_handlers()
        while not self._drain_ev.wait(0.2):
            pass
        return self.drain()

    def stop(self) -> None:
        """Immediate teardown (tests; :meth:`drain` calls this last)."""
        if self._stopped:
            return
        self._stopped = True
        self._server.shutdown()
        self._server.server_close()
        self.driver.stop_ev.set()
        self.driver.join(timeout=5.0)

    def __enter__(self) -> "ServingIngress":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # ------------------------------------------------------------ admission
    def _admission_error(self) -> Optional[Dict[str, Any]]:
        """A structured rejection (status/body/retry_after) when the front
        door should not accept right now, else None. Runs in a handler
        thread — only reads."""
        if self._draining:
            return {"status": 503, "error": "draining",
                    "retry_after": self.drain_grace}
        if self.driver.dead is not None:
            return {"status": 503, "error": "fleet_drained",
                    "detail": str(self.driver.dead)}
        try:
            lag = self.fleet.transport_lag()
        except Exception:
            lag = None
        if lag is not None:
            retry = retry_after_estimate(self.fleet.queue_depth(),
                                         self.fleet.finish_rate())
            if lag["out_backlog"] >= self.backlog_watermark:
                counter_inc("ingress.rejected_backpressure")
                return {"status": 503, "error": "transport_backlog",
                        "backlog": lag["out_backlog"], "retry_after": retry}
            if (self.beat_watermark_s is not None
                    and lag["beat_age_s"] >= self.beat_watermark_s):
                counter_inc("ingress.rejected_backpressure")
                return {"status": 503, "error": "transport_stale",
                        "beat_age_s": lag["beat_age_s"], "retry_after": retry}
        return None

    def _submit(self, body: Dict[str, Any], idem_key: Optional[str]):
        """Runs ON the driver thread: idempotency lookup + fleet submit,
        serialized with every other fleet mutation (a concurrent retry of
        the same key cannot double-submit). Returns (freq, replayed)."""
        if idem_key:
            freq = self._idem.get(idem_key)
            if freq is not None:
                counter_inc("ingress.idempotent_hits")
                return freq, True
        fid = self.fleet.submit(
            body["prompt"],
            max_new_tokens=int(body.get("max_new_tokens", 16)),
            eos_token_id=body.get("eos_token_id"),
            seed=int(body.get("seed", 0)),
            deadline_s=body.get("deadline_s"))
        freq = self.fleet.requests[fid]
        if idem_key:
            while len(self._idem) >= self.idem_keep:
                self._idem.pop(next(iter(self._idem)))
            self._idem[idem_key] = freq
        return freq, False

    def _track(self, fid: int, on: bool) -> None:
        with self._lock:
            if on:
                self._active.add(fid)
            else:
                self._active.discard(fid)
        gauge_set("ingress.inflight", len(self._active))

    def _wait_terminal(self, freq, deadline: float) -> None:
        """Poll the ledger object until terminal, the fleet dies, or the
        wall deadline passes (read-only; the driver advances the fleet)."""
        while (freq.status not in _TERMINAL and self.driver.dead is None
                and freq.fid not in self.driver.lost
                and time.monotonic() < deadline):
            time.sleep(0.005)

    def _cancel(self, fid: int) -> None:
        try:
            self.driver.call(lambda: self.fleet.cancel(fid), timeout=5.0)
        except Exception:
            pass

    def stats(self) -> Dict[str, Any]:
        return {"inflight": len(self._active), "draining": self._draining,
                "idempotency_keys": len(self._idem),
                "port": self.port}


# =====================================================================
# the HTTP handler
# =====================================================================

def _make_handler(ingress: ServingIngress):
    """Build the request-handler class bound to ``ingress`` (the stdlib
    server instantiates it per connection; a closure beats globals)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "paddle-tpu-torch-ingress/1.0"

        # silence the default stderr access log; the run log carries it
        def log_message(self, fmt, *args):
            pass

        # ------------------------------------------------------ plumbing
        def _json(self, status: int, doc: Dict[str, Any],
                  retry_after: Optional[float] = None) -> None:
            body = (json.dumps(doc) + "\n").encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", str(max(1, round(retry_after))))
            self.end_headers()
            self.wfile.write(body)

        def _client_gone(self) -> bool:
            """Peek the connection between chunks: a readable socket that
            yields b'' is a closed peer (the request body was already
            consumed, so pending data can only be EOF or pipelining —
            either way the stream should stop)."""
            try:
                r, _, _ = select.select([self.connection], [], [], 0)
                if not r:
                    return False
                return self.connection.recv(1, socket.MSG_PEEK) == b""
            except (OSError, ValueError):
                return True

        # ------------------------------------------------------ endpoints
        def do_GET(self):
            if self.path == "/healthz":
                ok = (not ingress._draining and ingress.driver.dead is None
                      and ingress.driver.is_alive())
                self._json(200 if ok else 503,
                           {"ok": ok, "draining": ingress._draining,
                            "inflight": len(ingress._active)})
            elif self.path == "/stats":
                try:
                    fleet_stats = ingress.driver.call(ingress.fleet.stats)
                except Exception as exc:
                    self._json(503, {"error": str(exc)})
                    return
                self._json(200, {"fleet": fleet_stats,
                                 "ingress": ingress.stats()})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/generate":
                self._json(404, {"error": "not found"})
                return
            t0 = time.monotonic()
            counter_inc("ingress.requests")
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                prompt = body["prompt"]
            except (ValueError, KeyError, TypeError):
                self._json(400, {"error": "bad request: JSON body with "
                                          "'prompt' (list of ints) required"})
                return
            reject = ingress._admission_error()
            if reject is not None:
                if reject["error"] == "draining":
                    counter_inc("ingress.rejected_draining")
                status = reject.pop("status")
                retry = reject.get("retry_after")
                _runlog.emit("ingress", kind="reject", reason=reject["error"],
                             status=status)
                self._json(status, reject, retry_after=retry)
                return
            idem_key = (self.headers.get("Idempotency-Key")
                        or body.get("idempotency_key"))
            try:
                freq, replayed = ingress.driver.call(
                    lambda: ingress._submit(body, idem_key))
            except FleetOverloadError as exc:
                counter_inc("ingress.rejected_overload")
                _runlog.emit("ingress", kind="reject", reason="overload",
                             status=429, queued=exc.queued,
                             retry_after_s=exc.retry_after_s)
                self._json(429, {"error": "overloaded", "queued": exc.queued,
                                 "limit": exc.limit,
                                 "retry_after": exc.retry_after_s},
                           retry_after=exc.retry_after_s)
                return
            except FleetDrainedError as exc:
                _runlog.emit("ingress", kind="reject", reason="fleet_drained",
                             status=503)
                self._json(503, {"error": "fleet_drained", "detail": str(exc)})
                return
            except Exception as exc:
                self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
                return
            _runlog.emit("ingress", kind="request", id=freq.fid,
                         trace=freq.trace_id, stream=bool(body.get("stream")),
                         idempotent=replayed,
                         prompt_tokens=len(freq.prompt))
            ingress._track(freq.fid, True)
            try:
                if body.get("stream"):
                    self._stream(freq, t0)
                else:
                    self._complete(freq, t0)
            finally:
                ingress._track(freq.fid, False)

        # ------------------------------------------------- response modes
        def _deadline(self, freq) -> float:
            wall = ingress.request_timeout
            if freq.deadline_s is not None:
                wall = min(wall, float(freq.deadline_s) + 5.0)
            return time.monotonic() + wall

        def _finish_doc(self, freq) -> Dict[str, Any]:
            if freq.fid in ingress.driver.lost:
                return {"fid": freq.fid, "status": "lost",
                        "error": "fleet_drained"}
            return {"fid": freq.fid, "status": freq.status,
                    "tokens": list(freq.tokens), "attempts": freq.attempts,
                    "trace": freq.trace_id}

        def _complete(self, freq, t0: float) -> None:
            ingress._wait_terminal(freq, self._deadline(freq))
            doc = self._finish_doc(freq)
            if freq.status not in _TERMINAL and doc["status"] != "lost":
                # wall timeout with the request still running: cancel it
                # so the slot frees, answer its terminal state
                ingress._cancel(freq.fid)
                ingress._wait_terminal(freq, time.monotonic() + 5.0)
                doc = self._finish_doc(freq)
            status = 200 if doc["status"] == "finished" else 503
            counter_inc("ingress.responses")
            observe("ingress.request_seconds", time.monotonic() - t0)
            _runlog.emit("ingress", kind="response", id=freq.fid,
                         status=doc["status"], http=status,
                         new_tokens=len(freq.tokens),
                         seconds=time.monotonic() - t0, trace=freq.trace_id)
            self._json(status, doc)

        def _write_chunk(self, payload: bytes) -> None:
            self.wfile.write(b"%x\r\n" % len(payload) + payload + b"\r\n")
            self.wfile.flush()

        def _stream(self, freq, t0: float) -> None:
            """Chunked-transfer stream off the append-only token ledger —
            the HTTP twin of TokenStream's cursor discipline: each poll
            ships the suffix past the cursor, so an upstream requeue
            (which replays bitwise) extends the stream without a single
            duplicated or dropped token."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            delivered = 0
            nchunks = 0
            deadline = self._deadline(freq)
            try:
                while True:
                    toks = list(freq.tokens)
                    if len(toks) > delivered:
                        if delivered == 0:
                            observe("ingress.ttft_seconds",
                                    time.monotonic() - t0)
                        chunk = {"tokens": [int(t) for t in toks[delivered:]],
                                 "start": delivered}
                        delivered = len(toks)
                        nchunks += 1
                        self._write_chunk(
                            (json.dumps(chunk) + "\n").encode())
                        if chaos.ingress_disconnect_due(nchunks):
                            # deterministic client loss: force-drop the
                            # connection (shutdown, not just close — the
                            # wfile handle keeps the fd alive otherwise);
                            # the next write fails and the
                            # disconnect->cancel path takes over
                            try:
                                self.connection.shutdown(socket.SHUT_RDWR)
                            except OSError:
                                pass
                            self.connection.close()
                        continue
                    if freq.status in _TERMINAL or freq.fid in ingress.driver.lost:
                        break
                    if time.monotonic() > deadline:
                        ingress._cancel(freq.fid)
                        break
                    if self._client_gone():
                        raise OSError("client disconnected")
                    time.sleep(0.005)
                doc = self._finish_doc(freq)
                doc["done"] = True
                doc.pop("tokens", None)
                doc["new_tokens"] = delivered
                self._write_chunk((json.dumps(doc) + "\n").encode())
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
                counter_inc("ingress.responses")
                observe("ingress.request_seconds", time.monotonic() - t0)
                _runlog.emit("ingress", kind="response", id=freq.fid,
                             status=freq.status, http=200, stream=True,
                             new_tokens=delivered, chunks=nchunks,
                             seconds=time.monotonic() - t0,
                             trace=freq.trace_id)
            except (OSError, ValueError):
                # the client went away mid-stream: free the decode slot
                counter_inc("ingress.disconnect_cancels")
                _runlog.emit("ingress", kind="disconnect", id=freq.fid,
                             delivered=delivered, trace=freq.trace_id)
                if freq.status not in _TERMINAL:
                    ingress._cancel(freq.fid)
                self.close_connection = True

    return Handler

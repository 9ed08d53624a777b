"""Compact store-backed RPC of the port's cross-process serving fleet (a
copy of ``paddle_tpu/inference/rpc.py``).

The parent supervisor and each replica subprocess already share exactly one
piece of infrastructure: the :class:`~..distributed.store.TCPStore` (the
rendezvous substrate the fleet heartbeats ride). This module turns it into
a pair of ordered, single-writer message channels per replica::

    procfleet/<ns>/<rid>/in    parent -> child   submit / cancel / drain
    procfleet/<ns>/<rid>/out   child -> parent   tick / chunk / finished

A :class:`Channel` is an append-only log: the (single) writer serializes
each message as JSON under ``<prefix>/m/<seq>`` and THEN bumps the
``<prefix>/n`` counter — so a reader that observes ``n == k`` can fetch
messages ``1..k`` without racing a half-published entry, and a writer that
dies mid-send (SIGKILL, segfault) leaves at worst an orphaned key the
counter never acknowledged. Reads are destructive (``delete_key`` after
fetch) so a long-lived serving store doesn't accumulate the whole token
history. Ordering is total per channel: sequence numbers are assigned by
the writer, drained in order by the reader — the property the per-token
streaming ledger's chunk sequence numbers build on. A drain interrupted by
a store failure returns the messages it already consumed (a **partial
drain**) instead of discarding them with the exception: those bodies are
deleted and the cursor has moved, so dropping them would lose acknowledged
messages; the failing sequence number stays unconsumed and the next call
retries it.

:class:`SocketChannel` is the **hot-path fast lane** over the same
contract: one full-duplex length-prefixed-frame TCP socket per replica
carries submit/chunk/tick traffic directly between parent and child (the
store's ~3x polling overhead drops to a socket write), while the TCPStore
stays authoritative for membership, heartbeats, and boot. Sequence numbers
are still writer-assigned and delivery is still in-order and exactly-once:
the writer retains every socket-sent message until the reader acknowledges
it (acks ride the same socket), and ANY socket error — connect failure,
reset, a chaos ``FLAGS_chaos_socket_drop_at`` kill — degrades the channel
back to the store transport mid-stream by republishing the unacknowledged
window under the same sequence numbers (set-then-bump, as ever). The
reader dedups by cursor, so the fallback can replay generously without
ever delivering a message twice, dropping one, or reordering.

Heartbeats deliberately do NOT ride the message log (a beat per tick would
dominate the store traffic): each replica overwrites one well-known key,
``procfleet/<ns>/<rid>/hb``, with a monotonic beat counter plus its local
counters (the ``infer.*`` warm-up counters and every kernel's launch count —
per-process state the parent cannot see any other way) and the parent's
stale-beat sweep watches the counter for motion, not the wall clock, so
cross-host clock skew cannot fake a death.

Every envelope carries the fleet ``trace_id``: the child attaches
it to its scheduler submission, so one trace spans parent placement, child
prefill/decode spans, requeue, and delivery across process boundaries.
"""
from __future__ import annotations

import json
import select
import socket
import time
from typing import Any, Dict, List, Optional

from ..observability.metrics import counter_inc
from ..testing import chaos

__all__ = ["Channel", "SocketChannel", "SocketConn", "SocketListener",
           "Heartbeat", "channel_prefix", "hb_key", "sock_key",
           "connect_socket"]


def channel_prefix(ns: str, rid: int, direction: str) -> str:
    """The store key prefix for one replica-channel direction ('in' is
    parent->child, 'out' is child->parent)."""
    return f"procfleet/{ns}/{rid}/{direction}"


def hb_key(ns: str, rid: int) -> str:
    return f"procfleet/{ns}/{rid}/hb"


def sock_key(ns: str, rid: int) -> str:
    """Where a replica advertises its fast-path socket endpoint."""
    return f"procfleet/{ns}/{rid}/sock"


class Channel:
    """One direction of ordered message flow over a TCPStore.

    Exactly one process may :meth:`send` and exactly one may :meth:`recv`
    on a given prefix — sequence numbers are writer-local, which is what
    makes the set-then-bump publication protocol race-free without a
    store-side transaction."""

    def __init__(self, store, prefix: str):
        self.store = store
        self.prefix = prefix
        self._sent = 0   # writer: last sequence number published
        self._read = 0   # reader: last sequence number consumed

    # ------------------------------------------------------------- writer
    def send(self, kind: str, **payload: Any) -> int:
        """Publish one message; returns its sequence number. The message
        body lands under ``m/<seq>`` BEFORE the ``n`` counter acknowledges
        it, so readers never observe a torn write."""
        self._sent += 1
        msg = {"kind": kind, "seq": self._sent}
        msg.update(payload)
        self.store.set(f"{self.prefix}/m/{self._sent}", json.dumps(msg))
        self.store.add(f"{self.prefix}/n", 1)
        return self._sent

    # ------------------------------------------------------------- reader
    def recv(self, timeout: float = 2.0) -> List[Dict[str, Any]]:
        """Drain every message published since the last call, in order.
        Non-blocking when nothing is pending (one counter read); the
        ``timeout`` only bounds the body fetch of an acknowledged message
        (which the writer has already set — it arrives immediately).

        A store failure partway through the drain returns the messages
        already consumed (their bodies are deleted and the cursor moved —
        discarding them would silently lose acknowledged messages); the
        failing sequence number is NOT consumed, so the next call retries
        it, and a drain that fails before consuming anything raises."""
        n = int(self.store.add(f"{self.prefix}/n", 0))
        out: List[Dict[str, Any]] = []
        while self._read < n:
            seq = self._read + 1
            try:
                raw = self.store.get(f"{self.prefix}/m/{seq}", timeout=timeout)
                msg = json.loads(raw if isinstance(raw, str) else raw.decode())
            except (TimeoutError, OSError, ValueError):
                if out:
                    counter_inc("rpc.partial_drains")
                    return out  # partial drain: consumed messages survive
                raise
            out.append(msg)
            try:
                self.store.delete_key(f"{self.prefix}/m/{seq}")
            except OSError:
                pass  # GC is best-effort; the counter already moved on
            self._read = seq
        return out


# =====================================================================
# socket fast path
# =====================================================================

class SocketConn:
    """One full-duplex framed TCP connection between the parent and one
    replica child, multiplexing both hot channels ('in': parent->child,
    'out': child->parent) plus piggybacked acknowledgements.

    Frames are 4-byte big-endian length + JSON:
    ``{"ch": name, "msg": {...}}`` carries one channel message,
    ``{"ackch": name, "ack": N}`` acknowledges in-order delivery through
    sequence N on channel ``name``. Any socket error (send failure, EOF,
    torn frame) marks the connection dead — callers degrade to the store
    transport; there is no reconnect (the store path is always correct,
    just slower)."""

    def __init__(self, sock: socket.socket, timeout: float = 5.0):
        sock.settimeout(timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.sock = sock
        self.alive = True
        self.death_reason: Optional[str] = None
        self._rbuf = b""
        self.inbox: Dict[str, List[dict]] = {}   # channel -> received msgs
        self.acks: Dict[str, int] = {}           # channel -> peer's ack

    def send_frame(self, doc: dict) -> bool:
        """Write one frame; False (and the conn is dead) on any error."""
        if not self.alive:
            return False
        delay = chaos.net_delay_ms()
        if delay > 0:
            time.sleep(delay / 1e3)
        data = json.dumps(doc).encode()
        try:
            self.sock.sendall(len(data).to_bytes(4, "big") + data)
            return True
        except (OSError, ValueError):
            self.kill("send error")
            return False

    def poll(self) -> None:
        """Drain every readable byte (never blocks) and parse complete
        frames into :attr:`inbox` / :attr:`acks`."""
        if not self.alive:
            return
        try:
            while True:
                r, _, _ = select.select([self.sock], [], [], 0)
                if not r:
                    break
                data = self.sock.recv(1 << 16)
                if not data:
                    self.kill("peer closed")
                    break
                self._rbuf += data
        except (OSError, ValueError):
            self.kill("recv error")
        while len(self._rbuf) >= 4:
            ln = int.from_bytes(self._rbuf[:4], "big")
            if len(self._rbuf) < 4 + ln:
                break
            body, self._rbuf = self._rbuf[4:4 + ln], self._rbuf[4 + ln:]
            try:
                doc = json.loads(body)
            except ValueError:
                self.kill("torn frame")
                return
            if "msg" in doc:
                self.inbox.setdefault(doc.get("ch"), []).append(doc["msg"])
            if doc.get("ack") is not None:
                ch = doc.get("ackch", doc.get("ch"))
                self.acks[ch] = max(self.acks.get(ch, 0), int(doc["ack"]))

    def take(self, channel: str) -> List[dict]:
        msgs = self.inbox.get(channel) or []
        self.inbox[channel] = []
        return msgs

    def kill(self, reason: str = "") -> None:
        if self.alive:
            self.alive = False
            self.death_reason = reason or "killed"
        try:
            self.sock.close()
        except OSError:
            pass

    close = kill


class SocketListener:
    """The child side's accept socket: bind an ephemeral port, advertise
    ``host:port`` (via the store's :func:`sock_key`), accept the parent's
    one connection non-blockingly from the serving loop."""

    def __init__(self, advertise_host: str = "127.0.0.1"):
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("", 0))
        self.sock.listen(1)
        self.sock.setblocking(False)
        self.port = self.sock.getsockname()[1]
        self.address = f"{advertise_host}:{self.port}"

    def try_accept(self) -> Optional[SocketConn]:
        try:
            s, _addr = self.sock.accept()
        except (BlockingIOError, InterruptedError):
            return None
        except OSError:
            return None
        counter_inc("rpc.socket_connects")
        return SocketConn(s)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def connect_socket(store, ns: str, rid: int,
                   timeout: float = 0.25) -> Optional[SocketConn]:
    """Parent-side dial of replica ``rid``'s advertised fast-path socket.
    None when the replica never advertised one (socket fast path disabled,
    or an old child) or the dial fails — callers simply stay on the store
    transport."""
    try:
        raw = store.get(sock_key(ns, rid), timeout=timeout)
    except (TimeoutError, OSError):
        return None
    addr = raw if isinstance(raw, str) else raw.decode()
    host, _, port = addr.rpartition(":")
    try:
        s = socket.create_connection((host, int(port)), timeout=2.0)
    except (OSError, ValueError):
        return None
    counter_inc("rpc.socket_connects")
    return SocketConn(s)


class SocketChannel(Channel):
    """A :class:`Channel` with a direct-socket fast lane and automatic,
    loss-free degradation back to the store transport.

    Both ends share one :class:`SocketConn` per replica (held in a mutable
    one-slot ``conn_box`` so the serving loop can install it after boot);
    the channel ``name`` ('in'/'out') tags frames on the shared wire.

    **Writer protocol**: every message gets the next writer-local seq and
    is retained in an unacked window; while the socket is alive it travels
    as one frame (no store ops at all). On any socket failure — or when no
    socket ever connected — :meth:`_flush_to_store` republishes every
    retained message the peer has not acknowledged under its ORIGINAL
    ``m/<seq>`` key and advances the ``n`` counter to the latest seq
    (set-then-bump, the same ordering contract). Acked messages are
    dropped from the window (the reader's cursor passed them; the counter
    may skip their bodies safely).

    **Reader protocol**: socket frames land in a pending map and are
    delivered strictly in cursor order; the store counter is consulted
    when the socket is dead, when a gap suggests store-published messages,
    and periodically (every :data:`STORE_CHECK_EVERY` drains) as a
    half-open-socket safety net — so the steady-state hot path costs zero
    store round-trips. Delivery acks ride back on the socket, bounding the
    writer's window. Cursor dedup makes fallback replays harmless: a
    message can arrive on both transports and is delivered exactly once,
    in order."""

    STORE_CHECK_EVERY = 32

    def __init__(self, store, prefix: str, name: str, conn_box: list,
                 rid: int = 0):
        super().__init__(store, prefix)
        self.name = name
        self.rid = int(rid)
        self._conn_box = conn_box
        self._unacked: Dict[int, dict] = {}  # writer: replay window
        self._pending: Dict[int, dict] = {}  # reader: out-of-order arrivals
        self._store_n = 0      # counter value this writer has driven
        self._calls = 0
        self.socket_msgs = 0   # sent via socket
        self.store_msgs = 0    # published to the store
        self.fallbacks = 0     # socket->store degradations observed

    def _conn(self) -> Optional[SocketConn]:
        return self._conn_box[0] if self._conn_box else None

    def backlog(self) -> int:
        """Writer-side transport lag: messages sent but not yet
        acknowledged by the peer (0 in pure store mode — the store IS the
        ack). The ingress reads this as a backpressure watermark."""
        return len(self._unacked)

    # ------------------------------------------------------------- writer
    def send(self, kind: str, **payload: Any) -> int:
        self._sent += 1
        msg = {"kind": kind, "seq": self._sent}
        msg.update(payload)
        self._unacked[self._sent] = msg
        conn = self._conn()
        if conn is not None and conn.alive:
            if chaos.socket_drop_due(self.rid, self.socket_msgs + 1):
                conn.kill("chaos: socket drop")
                self.fallbacks += 1
                counter_inc("rpc.socket_fallbacks")
            else:
                ack = conn.acks.get(self.name, 0)
                for seq in [s for s in self._unacked if s <= ack]:
                    del self._unacked[seq]
                if conn.send_frame({"ch": self.name, "msg": msg}):
                    self.socket_msgs += 1
                    counter_inc("rpc.socket_msgs")
                    return self._sent
                self.fallbacks += 1
                counter_inc("rpc.socket_fallbacks")
        self._flush_to_store()
        return self._sent

    def _flush_to_store(self) -> None:
        """Republish the unacknowledged window under the original seqs and
        bump the counter to the latest — the loss-free fallback seam. Safe
        to call repeatedly; already-published seqs are skipped and the
        counter only ever moves forward."""
        conn = self._conn()
        acked = conn.acks.get(self.name, 0) if conn is not None else 0
        for seq in sorted(self._unacked):
            if seq <= acked:
                continue  # delivered: the reader's cursor already passed it
            msg = self._unacked[seq]
            self.store.set(f"{self.prefix}/m/{seq}", json.dumps(msg))
            self.store_msgs += 1
            counter_inc("rpc.store_msgs")
        if self._sent > self._store_n:
            self.store.add(f"{self.prefix}/n", self._sent - self._store_n)
            self._store_n = self._sent
        self._unacked.clear()  # everything <= _sent is published or acked

    # ------------------------------------------------------------- reader
    def recv(self, timeout: float = 2.0) -> List[Dict[str, Any]]:
        self._calls += 1
        conn = self._conn()
        if conn is not None and conn.alive:
            conn.poll()
            for m in conn.take(self.name):
                seq = int(m.get("seq", 0))
                if seq > self._read:
                    self._pending[seq] = m
        out: List[Dict[str, Any]] = []
        self._deliver(out)
        conn = self._conn()  # poll may have killed it
        socket_ok = conn is not None and conn.alive
        if (not socket_ok or self._pending
                or self._calls % self.STORE_CHECK_EVERY == 0):
            self._drain_store(out, timeout)
        if out and socket_ok:
            conn.send_frame({"ackch": self.name, "ack": self._read})
        return out

    def _deliver(self, out: List[dict]) -> None:
        while self._read + 1 in self._pending:
            self._read += 1
            out.append(self._pending.pop(self._read))

    def _drain_store(self, out: List[dict], timeout: float) -> None:
        """Fetch store-published messages past the cursor, interleaving
        socket arrivals (pending entries win: their body fetch is free and
        the store copy of a socket-delivered seq is just the fallback
        replay). Same partial-drain discipline as :class:`Channel`."""
        n = int(self.store.add(f"{self.prefix}/n", 0))
        while self._read < n:
            seq = self._read + 1
            m = self._pending.pop(seq, None)
            if m is None:
                try:
                    raw = self.store.get(f"{self.prefix}/m/{seq}", timeout=timeout)
                    m = json.loads(raw if isinstance(raw, str) else raw.decode())
                except (TimeoutError, OSError, ValueError):
                    if out:
                        counter_inc("rpc.partial_drains")
                        return  # partial drain: keep what was consumed
                    raise
            out.append(m)
            try:
                self.store.delete_key(f"{self.prefix}/m/{seq}")
            except OSError:
                pass
            self._read = seq
            self._deliver(out)  # socket arrivals past the store counter
        self._deliver(out)


class Heartbeat:
    """The one-key beat a replica subprocess publishes and the parent
    sweeps. ``beat()`` overwrites; ``read()`` parses; staleness is judged
    by the PARENT's monotonic clock against the last time the beat counter
    moved (see ProcReplica), never by comparing wall clocks."""

    def __init__(self, store, ns: str, rid: int):
        self.store = store
        self.key = hb_key(ns, rid)
        self._n = 0

    def beat(self, **extra: Any) -> None:
        self._n += 1
        doc = {"n": self._n, "ts": time.time()}
        doc.update(extra)
        self.store.set(self.key, json.dumps(doc))

    def read(self, timeout: float = 0.05) -> Optional[Dict[str, Any]]:
        """The latest published beat, or None when the replica has not
        beaten yet (still importing/booting)."""
        try:
            raw = self.store.get(self.key, timeout=timeout)
        except (TimeoutError, OSError):
            return None
        try:
            return json.loads(raw if isinstance(raw, str) else raw.decode())
        except (ValueError, UnicodeDecodeError):
            return None

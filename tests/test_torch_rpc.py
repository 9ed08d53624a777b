"""The port's store and RPC transport (``paddle_tpu_torch.distributed.store``,
``.resilience``, ``paddle_tpu_torch.inference.rpc``), on the CPU.

``TCPStore`` keeps the reference's API over ``torch.distributed.TCPStore``
(per-call ``get`` timeouts, ``add`` returning the new value, a free port
read back, errors as ``TimeoutError``/``ConnectionError``); ``Channel``
keeps its order, destructive reads and partial drains; ``SocketChannel``
carries messages on the socket and, when the socket dies mid-stream,
republishes its unacknowledged window through the store with no message
lost, duplicated or reordered.
"""
import socket
import time

import pytest

from paddle_tpu.distributed.store import TCPStore as JTCPStore

from paddle_tpu_torch.distributed.resilience import RetryingStore
from paddle_tpu_torch.distributed.store import BarrierTimeoutError, TCPStore
from paddle_tpu_torch.inference.rpc import (
    Channel,
    Heartbeat,
    SocketChannel,
    SocketListener,
    channel_prefix,
    connect_socket,
    sock_key,
)
from paddle_tpu_torch.observability.metrics import counters
from paddle_tpu_torch.testing import chaos


@pytest.fixture
def store():
    s = TCPStore("127.0.0.1", 0, is_master=True, world_size=1, timeout=60.0)
    yield s
    s.close()


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    yield
    chaos.reset()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -------------------------------------------------------------- the store
def test_store_api_matches_the_reference(store):
    """The same ops on the port's store and on the reference's native one
    give the same answers."""
    ref = JTCPStore("127.0.0.1", 0, is_master=True, world_size=1, timeout=60.0)
    try:
        for s in (store, ref):
            assert s.port > 0
        for s in (store, ref):
            s.set("k", "v1")
            s.set("b", b"\x00\x01")
        assert store.get("k") == ref.get("k") == b"v1"
        assert store.get("b") == ref.get("b") == b"\x00\x01"
        assert [store.add("n", 1), store.add("n", 0), store.add("n", 5)] == \
            [ref.add("n", 1), ref.add("n", 0), ref.add("n", 5)] == [1, 1, 6]
        assert store.delete_key("k") is ref.delete_key("k") is True
        assert store.delete_key("k") is ref.delete_key("k") is False
        for s in (store, ref):
            with pytest.raises(TimeoutError):
                s.get("absent", timeout=0.1)
            with pytest.raises(TimeoutError):
                s.wait(["absent"], timeout=0.1)
        store.barrier("b0")
        ref.barrier("b0")
    finally:
        ref.close()


def test_store_clients_see_each_other_and_num_keys(store):
    client = TCPStore("127.0.0.1", store.port, is_master=False, timeout=60.0)
    n0 = store.num_keys()
    client.set("x", "1")
    assert store.get("x", timeout=60) == b"1"
    assert store.num_keys() == n0 + 1
    assert client.add("c", 2) == 2 and store.add("c", 3) == 5
    client.wait(["x"], timeout=60)
    client.close()
    with pytest.raises(OSError, match="closed"):
        client.get("x")


def test_closing_the_master_stops_the_server():
    master = TCPStore("127.0.0.1", 0, is_master=True, timeout=60.0)
    client = TCPStore("127.0.0.1", master.port, is_master=False, timeout=60.0)
    client.set("a", "1")
    master.close()
    with pytest.raises(OSError):  # ConnectionError: the server is gone
        for _ in range(100):
            client.set("a", "2")
            time.sleep(0.01)


def test_dead_endpoint_raises_connection_error():
    with pytest.raises(ConnectionError, match="cannot connect"):
        TCPStore("127.0.0.1", _free_port(), is_master=False, timeout=1.0)


def test_diagnostic_barrier_names_missing_ranks():
    s = TCPStore("127.0.0.1", 0, is_master=True, world_size=3, timeout=60.0)
    try:
        with pytest.raises(BarrierTimeoutError) as ei:
            s.diagnostic_barrier(rank=1, name="x", timeout=0.3)
        assert ei.value.missing_ranks == [0, 2] and ei.value.arrived == [1]
    finally:
        s.close()


def test_chaos_store_drop_heals_through_retrying_store(store):
    rs = RetryingStore(store, max_attempts=3, base_delay=0.001, jitter=False)
    with chaos.inject(FLAGS_chaos_store_drop_ops="set:fleet/", FLAGS_chaos_store_drop_count=2):
        rs.set("fleet/hb/0", "1")  # two injected drops, then the third attempt lands
        assert store.get("fleet/hb/0") == b"1"
    with chaos.inject(FLAGS_chaos_store_drop_ops="add", FLAGS_chaos_store_drop_count=-1):
        with pytest.raises(chaos.ChaosError):
            rs.add("n", 1)
    assert RetryingStore(store).port == store.port  # other attributes pass through


# ---------------------------------------------------------------- channels
def test_channel_ordering_destructive_reads_and_heartbeat(store):
    w = Channel(store, "t/0/out")
    r = Channel(store, "t/0/out")
    for i in range(5):
        w.send("tick", i=i)
    msgs = r.recv()
    assert [m["i"] for m in msgs] == list(range(5))
    assert [m["seq"] for m in msgs] == [1, 2, 3, 4, 5]
    assert r.recv() == []
    with pytest.raises(TimeoutError):
        store.get("t/0/out/m/1", timeout=0.05)  # the body was deleted
    w.send("tick", i=99)
    assert [m["i"] for m in r.recv()] == [99]

    hb = Heartbeat(store, "t", 0)
    hbr = Heartbeat(store, "t", 0)
    assert hbr.read(timeout=0.05) is None
    hb.beat(ready=True, compiles=0)
    doc = hbr.read()
    assert doc["n"] == 1 and doc["ready"] and doc["compiles"] == 0
    hb.beat(ready=True)
    assert hbr.read()["n"] == 2


class _FaultStore:
    """A store whose get() fails once on an armed key."""

    def __init__(self, store, fail_key):
        self._store = store
        self._fail_key = fail_key
        self.fired = False

    def get(self, key, timeout=None):
        if not self.fired and key == self._fail_key:
            self.fired = True
            raise TimeoutError(f"injected store fault on {key}")
        return self._store.get(key, timeout=timeout)

    def __getattr__(self, name):
        return getattr(self._store, name)


def test_channel_recv_partial_drain_survives_flaky_store(store):
    w = Channel(store, "t/0/out")
    r = Channel(_FaultStore(store, "t/0/out/m/2"), "t/0/out")
    for i in range(4):
        w.send("tick", i=i)
    before = counters("rpc.")["rpc.partial_drains"]
    assert [m["i"] for m in r.recv()] == [0]
    assert counters("rpc.")["rpc.partial_drains"] == before + 1
    msgs = r.recv()
    assert [m["i"] for m in msgs] == [1, 2, 3] and [m["seq"] for m in msgs] == [2, 3, 4]
    assert r.recv() == []


def test_channel_recv_empty_drain_still_raises(store):
    w = Channel(store, "t/1/out")
    r = Channel(_FaultStore(store, "t/1/out/m/1"), "t/1/out")
    w.send("tick", i=0)
    with pytest.raises(TimeoutError, match="injected"):
        r.recv()
    assert [m["i"] for m in r.recv()] == [0]


def _socket_pair(store, ns="s", rid=1):
    """A child-side listener advertised in the store and the parent's dial
    of it: (parent SocketConn box, child SocketConn box)."""
    listener = SocketListener()
    store.set(sock_key(ns, rid), listener.address)
    parent = connect_socket(store, ns, rid, timeout=60.0)
    assert parent is not None
    child = None
    t0 = time.monotonic()
    while child is None and time.monotonic() - t0 < 60:
        child = listener.try_accept()
    listener.close()
    assert child is not None
    return [parent], [child]


def _drain(reader, want, limit=60.0):
    """Read until ``want`` messages arrived (the socket is asynchronous)."""
    out, t0 = [], time.monotonic()
    while len(out) < want and time.monotonic() - t0 < limit:
        out += reader.recv()
        time.sleep(0.001)
    return out


def test_socket_channel_rides_the_socket_and_acks_bound_the_window(store):
    pbox, cbox = _socket_pair(store)
    w = SocketChannel(store, channel_prefix("s", 1, "in"), "in", pbox, rid=1)
    r = SocketChannel(store, channel_prefix("s", 1, "in"), "in", cbox, rid=1)
    for i in range(10):
        w.send("submit", fid=i)
    got = _drain(r, 10)
    assert [m["fid"] for m in got] == list(range(10))
    assert w.socket_msgs == 10 and w.store_msgs == 0
    assert store.add(channel_prefix("s", 1, "in") + "/n", 0) == 0  # no store op at all
    t0 = time.monotonic()
    while pbox[0].acks.get("in", 0) < 10 and time.monotonic() - t0 < 60:
        pbox[0].poll()
    w.send("submit", fid=10)  # the ack trims the replay window
    assert w.backlog() == 1
    assert [m["fid"] for m in _drain(r, 1)] == [10]
    pbox[0].close()
    cbox[0].close()


def test_socket_drop_falls_back_to_the_store_without_losing_a_message(store):
    """FLAGS_chaos_socket_drop_at kills the socket before the writer's 4th
    socket send: the unacknowledged window goes to the store under its
    sequence numbers, and the reader gets every message once, in order."""
    pbox, cbox = _socket_pair(store)
    w = SocketChannel(store, channel_prefix("s", 1, "out"), "out", cbox, rid=1)
    r = SocketChannel(store, channel_prefix("s", 1, "out"), "out", pbox, rid=1)
    with chaos.inject(FLAGS_chaos_socket_drop_at="1:4"):
        for i in range(3):
            w.send("chunk", i=i)
        for i in range(3, 8):
            w.send("chunk", i=i)
    got = _drain(r, 8)
    assert [m["i"] for m in got] == list(range(8))
    assert [m["seq"] for m in got] == list(range(1, 9))
    assert w.fallbacks == 1 and w.socket_msgs == 3 and w.store_msgs >= 5
    assert r.recv() == []
    assert counters("rpc.")["rpc.socket_fallbacks"] >= 1
    pbox[0].close()


def test_socket_channel_without_a_socket_is_the_store_channel(store):
    w = SocketChannel(store, "p/out", "out", [None])
    r = Channel(store, "p/out")  # the plain reader sees the same log
    for i in range(4):
        w.send("tick", i=i)
    assert [m["i"] for m in r.recv()] == [0, 1, 2, 3]
    assert w.backlog() == 0
    assert connect_socket(store, "none", 0, timeout=0.05) is None  # never advertised


# ------------------------------------------------------ the tracing plane
def test_trace_spans_nest_and_clocks_sync_through_the_store(store):
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.observability import runlog, trace

    prev = get_flags(["FLAGS_trace"])
    try:
        set_flags({"FLAGS_trace": True})
        prandom.seed(5)
        trace._GENS.clear()
        first = [trace.new_trace_id("t") for _ in range(3)]
        trace._GENS.clear()
        assert [trace.new_trace_id("t") for _ in range(3)] == first  # replays from the seed
        runlog.monitor().clear()
        with trace.attach(first[0]):
            assert trace.current_trace() == first[0]
            with trace.trace_span("outer") as outer:
                with trace.trace_span("inner") as inner:
                    assert trace.current_span() == inner.span_id
        assert trace.current_trace() is None
        spans = {e["name"]: e for e in runlog.monitor().events("span")}
        assert spans["inner"]["parent"] == outer.span_id and spans["inner"]["trace"] == first[0]
        assert spans["outer"]["seconds"] >= spans["inner"]["seconds"]
        with pytest.raises(ValueError):
            with trace.trace_span("boom", trace_id=first[1]):
                raise ValueError("x")
        assert runlog.monitor().events("span")[-1]["error"] is True
        assert trace.sync_clocks(store, rank=0, world_size=1, epoch=100.0) == 0.0
        assert trace.sync_clocks(store, rank=1, world_size=2, epoch=103.5) == 3.5
        assert store.get(f"{trace.EPOCH_KEY_PREFIX}/1/epoch") == b"103.5"
        set_flags({"FLAGS_trace": False})
        assert trace.new_trace_id("t") is None and trace.trace_span("x").span_id is None
    finally:
        set_flags(prev)
        prandom.seed(0)

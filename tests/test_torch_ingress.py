"""The port's HTTP ingress (``paddle_tpu_torch.inference.ingress``) on the
CPU: the semantics and backpressure cases of ``tests/test_ingress.py`` over
the port's in-process fleet, and a SIGKILL and a forced client drop over its
process fleet.

A cancel mid-decode or an impossible deadline is made certain by injected
latency (slow ticks, ``FLAGS_chaos_replica_slow_ms``; slow socket frames,
``FLAGS_chaos_net_delay_ms``), never by a race with the wall clock; waits
have limits of a minute or more.
"""
import http.client
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.framework.flags import get_flags, set_flags
from paddle_tpu_torch.inference import (
    FleetOverloadError,
    ProcServingFleet,
    ServingFleet,
    ServingIngress,
    retry_after_estimate,
)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.observability import runlog
from paddle_tpu_torch.observability.metrics import counters
from paddle_tpu_torch.testing import chaos

KW = dict(max_batch_slots=2, max_seq_len=64, prefill_chunk=8, fuse=2)
TERMINAL = ("finished", "cancelled", "deadline_exceeded")


@pytest.fixture(scope="module")
def model():
    return GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=0).eval()


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    prev = get_flags(["FLAGS_run_log_dir"])
    yield
    set_flags(prev)
    chaos.reset()


@pytest.fixture
def served(model):
    fleet = ServingFleet(model, replicas=1, **KW)
    ing = ServingIngress(fleet, port=0)
    yield fleet, ing
    ing.stop()


def _prompts(n, lens=(5, 9, 3, 12, 7, 11)):
    rng = np.random.default_rng(42)
    return [rng.integers(0, 512, (lens[i % len(lens)],)) for i in range(n)]


def _post(port, body, stream=False, key=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    headers = {"Content-Type": "application/json"}
    if key:
        headers["Idempotency-Key"] = key
    conn.request("POST", "/v1/generate", body=json.dumps(body).encode(), headers=headers)
    r = conn.getresponse()
    if not stream:
        doc = json.loads(r.read())
        hdrs = dict(r.getheaders())
        conn.close()
        return r.status, doc, hdrs
    toks, lines = [], []
    while True:
        line = r.readline()
        if not line:
            break
        doc = json.loads(line)
        lines.append(doc)
        toks.extend(doc.get("tokens") or [])
    conn.close()
    return r.status, {"tokens": toks, "lines": lines}, dict(r.getheaders())


def _body(prompt, max_new=6, seed=0, **kw):
    return {"prompt": [int(t) for t in prompt], "max_new_tokens": max_new, "seed": seed, **kw}


def _wait_terminal(freq, limit=60.0):
    t0 = time.monotonic()
    while freq.status not in TERMINAL and time.monotonic() - t0 < limit:
        time.sleep(0.005)
    return freq.status


def _direct(model, prompts, max_new=6, **kw):
    fleet = ServingFleet(model, replicas=2, **dict(KW, **kw))
    fids = [fleet.submit(p, max_new_tokens=max_new, seed=i) for i, p in enumerate(prompts)]
    done = fleet.run()
    return [list(done[f].tokens) for f in fids]


# ------------------------------------------------------------- semantics
def test_healthz_ready_stats_and_404(served):
    _, ing = served
    conn = http.client.HTTPConnection("127.0.0.1", ing.port, timeout=60)
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    doc = json.loads(r.read())
    assert r.status == 200 and doc["ok"] and not doc["draining"]
    conn.request("GET", "/stats")
    r = conn.getresponse()
    doc = json.loads(r.read())
    assert r.status == 200 and doc["fleet"]["replicas"] == 1 and doc["ingress"]["port"] == ing.port
    conn.request("GET", "/nope")
    r = conn.getresponse()
    r.read()
    assert r.status == 404
    conn.close()
    assert ing.url == f"http://127.0.0.1:{ing.port}"


def test_http_answers_equal_the_fleet_driven_directly(served, model):
    _, ing = served
    prompts = _prompts(4)
    want = _direct(model, prompts)
    for i, p in enumerate(prompts):
        st, doc, _ = _post(ing.port, _body(p, seed=i))
        assert st == 200 and doc["status"] == "finished" and doc["tokens"] == want[i]
        st, doc, hdrs = _post(ing.port, _body(p, seed=i, stream=True), stream=True)
        assert st == 200 and hdrs["Transfer-Encoding"] == "chunked"
        assert doc["tokens"] == want[i]
        assert doc["lines"][-1]["done"] is True and doc["lines"][-1]["new_tokens"] == 6


def test_idempotent_retry_never_double_generates(served):
    fleet, ing = served
    p = _prompts(1)[0]
    before = len(fleet.requests)
    hits = counters("ingress.")["ingress.idempotent_hits"]
    st1, d1, _ = _post(ing.port, _body(p, seed=3), key="retry-me")
    st2, d2, _ = _post(ing.port, _body(p, seed=3), key="retry-me")
    assert st1 == st2 == 200 and d1["status"] == d2["status"] == "finished"
    assert d2["fid"] == d1["fid"] and d2["tokens"] == d1["tokens"]
    assert len(fleet.requests) == before + 1
    st3, d3, _ = _post(ing.port, _body(p, seed=3, stream=True, idempotency_key="retry-me"),
                       stream=True)
    assert st3 == 200 and d3["tokens"] == d1["tokens"]
    assert counters("ingress.")["ingress.idempotent_hits"] == hits + 2


def test_client_disconnect_cancels_mid_decode(model):
    """A client that drops its connection while its request decodes gets it
    cancelled: the in-process fleet's ledger fills at completion, so the
    stream has sent nothing yet, and the handler finds the closed socket
    between its polls. 100 ms ticks give the 40 tokens 20 ticks, so the
    cancel lands mid-decode."""
    with chaos.inject(FLAGS_chaos_replica_slow_ms="100"):
        fleet = ServingFleet(model, replicas=1, **KW)
        ing = ServingIngress(fleet, port=0)
        try:
            before = counters("ingress.")["ingress.disconnect_cancels"]
            conn = http.client.HTTPConnection("127.0.0.1", ing.port, timeout=120)
            conn.request("POST", "/v1/generate",
                         body=json.dumps(_body(_prompts(1)[0], max_new=40, seed=5,
                                               stream=True)).encode(),
                         headers={"Idempotency-Key": "disc-real"})
            t0 = time.monotonic()
            while ("disc-real" not in ing._idem
                   or not fleet.tokens_so_far(ing._idem["disc-real"].fid)):
                assert time.monotonic() - t0 < 60, "the request never started decoding"
                time.sleep(0.005)
            conn.close()  # the client vanishes mid-decode
            freq = ing._idem["disc-real"]
            assert _wait_terminal(freq) == "cancelled"
            sched = fleet.replicas[0].scheduler
            assert 0 < len(next(iter(sched.cancelled.values())).tokens) < 40
            assert fleet.replicas[0].engine.free_slots() == [0, 1]
            t0 = time.monotonic()
            while (counters("ingress.")["ingress.disconnect_cancels"] == before
                   and time.monotonic() - t0 < 60):
                time.sleep(0.005)
            assert counters("ingress.")["ingress.disconnect_cancels"] == before + 1
        finally:
            ing.stop()


def test_chaos_ingress_disconnect_forces_cancel_over_the_process_fleet(monkeypatch):
    """FLAGS_chaos_ingress_disconnect_at=1 drops the client after the first
    streamed chunk; the process fleet streams chunk by chunk, and a 20 ms
    delay on every socket frame (``FLAGS_chaos_net_delay_ms``, in the
    children too) keeps the rest of the 40 tokens coming for many times the
    cancel's way back: the request ends cancelled mid-decode."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with chaos.inject(FLAGS_chaos_ingress_disconnect_at=1, FLAGS_chaos_net_delay_ms=20.0):
        fleet = ProcServingFleet(GPTConfig.tiny(), model_seed=0, replicas=1,
                                 heartbeat_timeout=60.0, device="cpu", **KW)
        ing = ServingIngress(fleet, port=0)
        try:
            before = counters("ingress.")["ingress.disconnect_cancels"]
            try:
                _post(ing.port, _body(_prompts(1)[0], max_new=40, seed=0, stream=True,
                                      idempotency_key="chaos-disc"), stream=True)
            except (OSError, http.client.HTTPException, ValueError):
                pass  # the connection dies under the reader, or ends early
            freq = ing._idem["chaos-disc"]
            assert _wait_terminal(freq) == "cancelled"
            assert 0 < len(freq.tokens) < 40
            assert counters("ingress.")["ingress.disconnect_cancels"] == before + 1
        finally:
            ing.stop()
            fleet.shutdown()


def test_deadline_propagates_to_the_scheduler(model):
    """A 20 ms deadline against 60 ms ticks: certain to expire before the
    first scheduler step; the answer is 503 deadline_exceeded."""
    with chaos.inject(FLAGS_chaos_replica_slow_ms="60"):
        fleet = ServingFleet(model, replicas=1, **KW)
        ing = ServingIngress(fleet, port=0)
        try:
            st, doc, _ = _post(ing.port, _body(_prompts(1)[0], max_new=40, deadline_s=0.02))
            assert st == 503 and doc["status"] == "deadline_exceeded"
        finally:
            ing.stop()


def test_bad_request_is_400(served):
    _, ing = served
    st, doc, _ = _post(ing.port, {"max_new_tokens": 4})
    assert st == 400 and "prompt" in doc["error"]


def test_sigterm_drain_under_load_exits_zero(model):
    """SIGTERM with 3 requests in flight (60 ms ticks keep them there):
    /healthz flips first, every accepted request finishes, and the drain
    returns 0; afterwards the port is closed."""
    with chaos.inject(FLAGS_chaos_replica_slow_ms="60"):
        fleet = ServingFleet(model, replicas=2, **KW)
        ing = ServingIngress(fleet, port=0, drain_grace=120.0)
        prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
        docs = []
        try:
            def worker(i):
                docs.append(_post(ing.port, _body(_prompts(3)[i], seed=i), timeout=300)[:2])

            ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
            for t in ts:
                t.start()
            t0 = time.monotonic()
            while len(ing._active) < 3 and time.monotonic() - t0 < 60:
                time.sleep(0.002)
            assert len(ing._active) == 3

            def fire():
                time.sleep(0.05)
                os.kill(os.getpid(), signal.SIGTERM)

            threading.Thread(target=fire, daemon=True).start()
            rc = ing.serve_until_drained()
            assert rc == 0 and ing.exit_code == 0
            for t in ts:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in ts)
            assert len(docs) == 3 and all(st == 200 and d["status"] == "finished"
                                          for st, d in docs)
            conn = http.client.HTTPConnection("127.0.0.1", ing.port, timeout=5)
            with pytest.raises(OSError):
                conn.request("GET", "/healthz")
                conn.getresponse()
        finally:
            for s, h in prev.items():
                signal.signal(s, h)
            ing.stop()


def test_ingress_run_log_events(model, tmp_path):
    set_flags({"FLAGS_run_log_dir": str(tmp_path)})
    runlog.monitor().clear()
    fleet = ServingFleet(model, replicas=1, **KW)
    ing = ServingIngress(fleet, port=0)
    st, _, _ = _post(ing.port, _body(_prompts(1)[0], seed=2))
    assert st == 200 and ing.drain(grace=60.0) == 0
    kinds = [e["kind"] for e in runlog.monitor().events("ingress")]
    assert kinds[0] == "started" and {"request", "response", "drain_begin", "drain_done"} <= set(kinds)
    assert any(f.startswith("run-") for f in os.listdir(tmp_path))


# ----------------------------------------------------------- backpressure
def test_retry_after_estimate():
    assert retry_after_estimate(10, 2.0) == 5.0
    assert retry_after_estimate(1, 10.0) == 0.5
    assert retry_after_estimate(1000, 1.0) == 30.0
    assert retry_after_estimate(5, None) == 30.0
    assert retry_after_estimate(0, None) == 0.5
    assert retry_after_estimate(4, 0.0) == 30.0


def test_overload_error_carries_retry_after():
    e = FleetOverloadError(8, 8, 2, retry_after_s=4.0)
    assert e.retry_after_s == 4.0 and "4.0s" in str(e)
    assert FleetOverloadError(8, 8, 2).retry_after_s is None


def test_fleet_populates_retry_after_on_shed(model):
    fleet = ServingFleet(model, replicas=1, max_queue_depth=1, **KW)
    fleet.submit(_prompts(1)[0], max_new_tokens=4)
    with pytest.raises(FleetOverloadError) as ei:
        fleet.submit(_prompts(2)[1], max_new_tokens=4)
    assert ei.value.retry_after_s == 30.0


def test_http_429_with_retry_after_header(model):
    fleet = ServingFleet(model, replicas=1, **KW)

    def shed(*a, **kw):
        raise FleetOverloadError(8, 8, 1, retry_after_s=7.0)

    fleet.submit = shed
    ing = ServingIngress(fleet, port=0)
    try:
        st, doc, hdrs = _post(ing.port, _body(_prompts(1)[0]))
        assert st == 429 and doc["error"] == "overloaded" and doc["retry_after"] == 7.0
        assert hdrs["Retry-After"] == "7"
    finally:
        ing.stop()


def test_draining_rejects_503_with_retry_after(served):
    _, ing = served
    ing.begin_drain()
    st, doc, hdrs = _post(ing.port, _body(_prompts(1)[0]))
    assert st == 503 and doc["error"] == "draining" and "Retry-After" in hdrs
    conn = http.client.HTTPConnection("127.0.0.1", ing.port, timeout=60)
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    assert r.status == 503 and not json.loads(r.read())["ok"]
    conn.close()


@pytest.mark.parametrize("lag, watermarks, error", [
    ({"out_backlog": 10_000.0, "beat_age_s": 0.0}, dict(backlog_watermark=512), "transport_backlog"),
    ({"out_backlog": 0.0, "beat_age_s": 9.0}, dict(beat_watermark_s=2.0), "transport_stale")])
def test_transport_lag_watermarks_reject_503(model, lag, watermarks, error):
    fleet = ServingFleet(model, replicas=1, **KW)
    fleet.transport_lag = lambda: lag
    ing = ServingIngress(fleet, port=0, **watermarks)
    try:
        st, doc, hdrs = _post(ing.port, _body(_prompts(1)[0]))
        assert st == 503 and doc["error"] == error and "Retry-After" in hdrs
    finally:
        ing.stop()


# --------------------------------------------------- over the process fleet
def test_sigkill_mid_decode_over_http_bitwise_exactly_once(model, monkeypatch):
    """HTTP streams with a real kill -9 of replica 1 after its first tick
    message finish bitwise equal to the in-process fleet, each token once,
    and the hot path rode the socket transport."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    prompts = _prompts(4)
    want = _direct(model, prompts)
    with chaos.inject(FLAGS_chaos_replica_sigkill_at="1:1"):
        fleet = ProcServingFleet(GPTConfig.tiny(), model_seed=0, replicas=2,
                                 heartbeat_timeout=60.0, device="cpu", **KW)
        ing = ServingIngress(fleet, port=0)
        try:
            got = [None] * len(prompts)

            def worker(i):
                got[i] = _post(ing.port, _body(prompts[i], seed=i, stream=True), stream=True,
                               timeout=300)[:2]

            ts = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in ts)
            for i, (st, doc) in enumerate(got):
                assert st == 200 and doc["lines"][-1]["status"] == "finished"
                assert doc["tokens"] == want[i], f"stream {i} diverged"
            st_f = fleet.stats()
            assert st_f["dead"] == [1] and "rc=-9" in st_f["per_replica"][1]["death_reason"]
            assert st_f["requeues"] >= 1
            tr = st_f["per_replica"][0]["transport"]
            assert tr["socket"] and tr["socket_msgs"] > 0
        finally:
            ing.stop()
            fleet.shutdown()

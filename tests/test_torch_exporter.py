"""The port's ``/metrics`` exposition and live exporter
(``paddle_tpu_torch.observability.metrics`` and ``exporter``) against the
reference's, on the CPU.

For the same series set in each package's registry, ``prometheus_text`` is
byte-equal (and equals the reference's golden file); each endpoint of the
port's exporter answers; ``ensure_started`` follows ``FLAGS_metrics_port``,
publishes its address through a store and counts a failed bind.
"""
import json
import os
import re
import socket
import urllib.error
import urllib.request

import pytest

from paddle_tpu.observability import metrics as jmetrics

from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.framework.flags import get_flags, set_flags
from paddle_tpu_torch.inference import ServingFleet
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.observability import exporter, metrics

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "prometheus.golden.txt")
# one exposition line: a HELP/TYPE comment or a sample with optional labels
_LINE = re.compile(r'^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .*'
                   r'|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]+="([^"\\]|\\.)*"\})? \S+)$')


@pytest.fixture(autouse=True)
def _clean():
    prev = get_flags(["FLAGS_metrics_port"])
    _fresh()
    yield
    _fresh()
    exporter.stop()
    set_flags(prev)


def _fresh():
    for m in (jmetrics, metrics):
        for reg in (m._COUNTERS, m._GAUGES, m._HISTOGRAMS, m._HELP):
            for k in [k for k in reg if k.startswith("golden.")]:
                del reg[k]
        m._DECLARED_COUNTERS.difference_update(
            {k for k in m._DECLARED_COUNTERS if k.startswith("golden.")})


def _series(m):
    """The series set of the reference's golden file."""
    m.declare_counter("golden.requests", 'requests served, incl. "bad" ones\nsecond line \\ backslash')
    m.counter_inc("golden.requests", 3)
    m.gauge_set("golden.temp", 1.5)
    m.declare_help("golden.temp", "current temperature")
    h = m.histogram("golden.latency", bounds=[0.01, 0.1, 1.0])
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    m.declare_help("golden.latency", "request latency")


def test_prometheus_text_is_byte_equal_and_matches_the_golden_file():
    for m in (jmetrics, metrics):
        _series(m)
    text = metrics.prometheus_text(prefix="golden.")
    assert text == jmetrics.prometheus_text(prefix="golden.")
    with open(GOLDEN) as f:
        assert text == f.read()
    for m in (jmetrics, metrics):
        m.counter_inc("golden.a-b.c", 1)
        m.declare_histogram("golden.cum", bounds=[0.1, 1.0, 10.0])
        for v in (0.05, 0.5, 0.6, 5.0, 50.0):
            m.observe("golden.cum", v)
        m.gauge_set("golden.9lives", -2e-7)
    text = metrics.prometheus_text(prefix="golden.")
    assert text == jmetrics.prometheus_text(prefix="golden.")
    assert "paddle_tpu_golden_a_b_c_total 1" in text and "_total_total" not in text
    assert 'paddle_tpu_golden_cum_seconds_bucket{le="10"} 4' in text
    assert all(_LINE.match(line) for line in text.splitlines()), text


@pytest.mark.parametrize("raw", ['a\\b\nc', 'quotes " stay raw', 'v"1\\2\n3', "plain"])
def test_escapes_equal_the_reference(raw):
    assert metrics.escape_help(raw) == jmetrics.escape_help(raw)
    assert metrics.escape_label_value(raw) == jmetrics.escape_label_value(raw)


def test_snapshot_and_percentiles_equal_the_reference():
    for m in (jmetrics, metrics):
        for v in (0.003, 0.02, 0.02, 0.4, 7.0, 250.0):
            m.observe("golden.snap", v)
    assert (metrics.histogram("golden.snap").summary()
            == jmetrics.histogram("golden.snap").summary())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def test_every_endpoint_answers():
    model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=0).eval()
    fleet = ServingFleet(model, replicas=1, max_batch_slots=2, max_seq_len=64)
    metrics.counter_inc("golden.requests", 2)
    exp = exporter.MetricsExporter(port=0).start()
    try:
        code, ctype, body = _get(exp.port, "/metrics")
        assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert all(_LINE.match(line) for line in body.splitlines())
        assert "paddle_tpu_golden_requests_total 2" in body
        assert "# TYPE paddle_tpu_fleet_requests_submitted_total counter" in body  # declared
        code, ctype, body = _get(exp.port, "/healthz")
        doc = json.loads(body)
        assert code == 200 and ctype == "application/json" and doc["status"] == "ok"
        assert doc["components"]["fleet"]["replicas_alive"] == [0]
        code, _, body = _get(exp.port, "/alerts")
        assert code == 200 and set(json.loads(body)) == {"ts", "pid", "firing", "page", "alerts"}
        code, _, body = _get(exp.port, "/snapshot")
        assert code == 200 and json.loads(body)["counters"]["golden.requests"] == 2
        assert _get(exp.port, "/nope")[0] == 404
        fleet.kill_replica(0)
        code, _, body = _get(exp.port, "/healthz")
        assert code == 503 and json.loads(body)["components"]["fleet"]["ok"] is False
    finally:
        exp.stop()
        exporter.unregister_health("fleet")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ensure_started_follows_the_flag_publishes_and_counts_bind_failures():
    assert exporter.ensure_started() is None  # FLAGS_metrics_port 0: no server
    port = _free_port()
    set_flags({"FLAGS_metrics_port": port})
    with socket.socket() as taken:  # another local process holds the port
        taken.bind(("127.0.0.1", port))
        taken.listen()
        fails = metrics.counter_value("exporter.bind_failures")
        assert exporter.ensure_started() is None and exporter.current() is None
        assert metrics.counter_value("exporter.bind_failures") == fails + 1
    store = TCPStore(is_master=True, timeout=30.0)
    try:
        exp = exporter.ensure_started(store=store, rank=3)
        assert exp is exporter.current() and exp.port == port
        assert exporter.ensure_started() is exp  # idempotent
        assert store.get(f"{exporter.ADDR_KEY_PREFIX}/3/metrics_addr").decode() == exp.address
        assert _get(port, "/metrics")[0] == 200
    finally:
        store.close()

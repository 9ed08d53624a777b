"""The judgment layer of the port (``paddle_tpu_torch.observability.slo`` and
``regress``) against the reference's, on the CPU.

Both packages' ``SLOMonitor``s take the same counter, gauge, histogram and
run-log event streams and are evaluated at the same ``now=`` timestamps:
their states, alerts, health probes and ``alert`` transitions are equal,
for ratio, percentile, gauge and event SLOs, ``min_count`` and cadence
gating included. ``check_history`` and ``mad_z`` agree on the same numpy
histories, and both sentinels judge the port's measured docs alike. The
tick hooks stay a flag check until ``FLAGS_slo``, in the scheduler, both
fleets and ``run_steps``. Last, the reference's chaos acceptance pin on the
port: a tiny ``ServingFleet`` under ``FLAGS_chaos_replica_slow_ms`` pages,
shows in ``/alerts``, turns ``/healthz`` to 503, and clears.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.observability import flightrec as jflightrec
from paddle_tpu.observability import measured as jmeasured
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import regress as jregress
from paddle_tpu.observability import runlog as jrunlog
from paddle_tpu.observability import slo as jslo

from paddle_tpu_torch.framework.flags import get_flags, set_flags
from paddle_tpu_torch.inference import (
    ContinuousBatchingScheduler,
    DecodeEngine,
    ProcServingFleet,
    ServingFleet,
)
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
from paddle_tpu_torch.observability import (exporter, flightrec, measured, metrics, regress,
                                            runlog, slo)
from paddle_tpu_torch.observability.__main__ import main as obs_main
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.testing import chaos

KW = dict(max_batch_slots=2, max_seq_len=64, prefill_chunk=8, fuse=2)
# the two packages' (slo, metrics, runlog) modules: reference first
SIDES = ((jslo, jmetrics, jrunlog), (slo, metrics, runlog))


@pytest.fixture(scope="module")
def model():
    return GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=0).eval()


@pytest.fixture(autouse=True)
def _clean():
    names = ["FLAGS_slo", "FLAGS_run_log_dir", "FLAGS_compile_cache_dir"]
    prev, jprev = get_flags(names), paddle.get_flags(names)
    chaos.reset()
    yield
    slo.uninstall()
    jslo.uninstall()
    set_flags(prev)
    paddle.set_flags(jprev)
    chaos.reset()


def _prompts(n):
    rng = np.random.default_rng(42)
    return [rng.integers(0, 512, (k,)).astype("int32") for k in (5, 9, 3, 12, 7, 11)[:n]]


def _specs(mod):
    """One spec of every kind over the ``tslo.*`` series."""
    return [
        mod.SLO("t.err_rate", "ratio", threshold=0.01,
                counter_bad="tslo.bad", counter_total="tslo.total"),
        mod.SLO("t.cold", "ratio", threshold=0.01, counter_bad="tslo.cbad",
                counter_total="tslo.ctotal", min_count=20),
        mod.SLO("t.lat_p50_ms", "percentile", threshold=50.0, histogram="tslo.lat",
                q=50, scale=1e3),
        mod.SLO("t.g", "gauge", threshold=0.5, op=">=", gauge="tslo.g"),
        mod.SLO("t.ev_p50_ms", "events", threshold=50.0, event="t_slo_req",
                field="seconds", q=50, scale=1e3),
    ]


def _fresh_series():
    """Drop every ``tslo.*`` series and the ring's events from both
    packages' registries."""
    for _, m, rl in SIDES:
        m.reset_counters("tslo.")
        for reg in (m._GAUGES, m._HISTOGRAMS):
            for k in [k for k in reg if k.startswith("tslo.")]:
                del reg[k]
        rl.monitor().clear()


def _apply(ops):
    for _, m, rl in SIDES:
        for op, name, *vals in ops:
            if op == "c":
                m.counter_inc(name, vals[0])
            elif op == "h":
                for v in vals[0]:
                    m.observe(name, v)
            elif op == "g":
                m.gauge_set(name, vals[0])
            else:
                for v in vals[0]:
                    rl.emit(name, seconds=v)


def _transitions(rl):
    keys = ("slo", "state", "severity", "previous", "objective", "sli", "burn_fast",
            "burn_slow", "budget_remaining", "since")
    return [{k: e.get(k) for k in keys} for e in rl.monitor().events("alert")
            if str(e.get("slo", "")).startswith("t.")]


def test_monitors_agree_on_every_kind_of_slo():
    _fresh_series()
    mons = [mod.SLOMonitor(_specs(mod), eval_every_s=0.0, fast_window_s=30.0,
                           slow_window_s=120.0) for mod, _, _ in SIDES]
    c0 = [m.counters("alerts.") for _, m, _ in SIDES]
    base = time.time()
    script = [
        (0, []),
        (10, [("c", "tslo.total", 100), ("h", "tslo.lat", [0.005] * 10), ("g", "tslo.g", 0.9)]),
        (20, [("c", "tslo.bad", 50), ("c", "tslo.total", 50), ("c", "tslo.cbad", 5),
              ("c", "tslo.ctotal", 5), ("h", "tslo.lat", [0.150] * 30), ("g", "tslo.g", 0.2),
              ("e", "t_slo_req", [0.2, 0.3, 0.25])]),
        (60, [("c", "tslo.total", 100)]),
        (200, []),
        (400, [("c", "tslo.total", 100), ("g", "tslo.g", 0.9)]),
    ]
    seen = set()
    for dt, ops in script:
        _apply(ops)
        outs = [mon.evaluate(base + dt) for mon in mons]
        assert outs[0] == outs[1], dt
        assert mons[0].alerts() == mons[1].alerts()
        assert mons[0].health_probe() == mons[1].health_probe()
        assert mons[0].states() == mons[1].states()
        seen |= {(name, d["severity"]) for name, d in outs[1].items()}
    # every kind fired, the cold-start ratio never did, and all cleared
    assert {("t.err_rate", "page"), ("t.lat_p50_ms", "page"), ("t.g", "page"),
            ("t.ev_p50_ms", "page")} <= seen
    assert {sev for name, sev in seen if name == "t.cold"} == {None}
    assert all(d["severity"] is None for d in outs[1].values())
    assert _transitions(jrunlog) == _transitions(runlog) != []
    moved = [{k: m.counters("alerts.")[k] - c[k] for k in c} for (_, m, _), c in zip(SIDES, c0)]
    assert moved[0] == moved[1] and moved[1]["alerts.page"] >= 4


def test_cadence_gates_evaluation_alike():
    _fresh_series()
    got = []
    for mod, _, _ in SIDES:
        mon = mod.SLOMonitor(_specs(mod)[:1], eval_every_s=5.0, fast_window_s=30.0,
                             slow_window_s=120.0)
        got.append([mon.maybe_evaluate(t) is not None for t in (100.0, 102.0, 105.0, 109.0)])
    assert got[0] == got[1] == [True, False, True, False]


def test_ratio_two_window_rule_and_min_count_alike():
    """A blip that moves the fast window but not a long slow one warns and
    never pages; a 100% bad rate on fewer than min_count events stays
    quiet."""
    _fresh_series()
    mons = []
    for mod, _, _ in SIDES:
        mons.append(mod.SLOMonitor(
            [mod.SLO("t.blip", "ratio", threshold=0.01, counter_bad="tslo.bad",
                     counter_total="tslo.total"),
             mod.SLO("t.cold", "ratio", threshold=0.01, counter_bad="tslo.cbad",
                     counter_total="tslo.ctotal", min_count=20)],
            eval_every_s=0.0, fast_window_s=10.0, slow_window_s=1000.0))
    t0 = 2000.0
    for mon in mons:
        mon.evaluate(t0)
    for i in range(1, 60):
        _apply([("c", "tslo.total", 2000)])
        assert mons[0].evaluate(t0 + 20 * i) == mons[1].evaluate(t0 + 20 * i)
    _apply([("c", "tslo.bad", 30), ("c", "tslo.total", 30), ("c", "tslo.cbad", 5),
            ("c", "tslo.ctotal", 5)])
    outs = [mon.evaluate(t0 + 1200) for mon in mons]
    assert outs[0] == outs[1]
    assert outs[1]["t.blip"]["burn_fast"] >= 14.4 and outs[1]["t.blip"]["severity"] == "warn"
    assert outs[1]["t.cold"]["sli"] == 1.0 and outs[1]["t.cold"]["severity"] is None


def test_default_specs_equal_the_reference():
    def doc(s):
        return {k: v for k, v in vars(s).items()}

    assert [doc(s) for s in slo.default_specs()] == [doc(s) for s in jslo.default_specs()]
    for s in slo.default_specs():  # every series a spec reads is one the reference names
        for c in s.counter_bad + s.counter_total:
            assert c in jmetrics._DECLARED_COUNTERS, (s.name, c)
        assert s.histogram in (None,) + jmetrics.KNOWN_HISTOGRAMS, s.name
        assert s.gauge in (None,) + jmetrics.KNOWN_GAUGES, s.name


# ------------------------------------------------- perf-regression sentinel
def test_check_history_and_mad_z_equal_the_reference():
    rng = np.random.default_rng(0)
    cases = []
    for n in (5, 11, 12, 20, 40, 64):
        base = 0.01 * (1 + 0.02 * rng.standard_normal(n))
        for shift in (1.0, 1.05, 1.3, 2.5):
            v = base.copy()
            v[-8:] *= shift
            cases.append(v.tolist())
    cases += [[0.01] * 30, [0.01] * 20 + [0.5] + [0.01] * 7, [100.0] * 20 + [40.0] * 8]
    fired = 0
    for v in cases:
        for worse in ("up", "down"):
            got = regress.check_history(v, worse=worse)
            assert got == jregress.check_history(v, worse=worse)
            fired += got is not None
        assert regress.mad_z(v[:-1], v[-1]) == jregress.mad_z(v[:-1], v[-1])
    assert 0 < fired < 2 * len(cases)  # drifting histories and steady ones


def test_sentinels_judge_the_ports_measured_docs_alike(tmp_path):
    """A measured doc the port writes with a 2x step-time shift trips one
    critical alert in both packages' sentinels (the schema is shared), once
    while the drift persists, and clears after recovery."""
    flightrec.reset()  # the per-process dump budget: earlier fleet deaths may have spent it
    jflightrec.reset()
    set_flags({"FLAGS_compile_cache_dir": str(tmp_path), "FLAGS_run_log_dir": str(tmp_path)})
    paddle.set_flags({"FLAGS_compile_cache_dir": str(tmp_path),
                      "FLAGS_run_log_dir": str(tmp_path)})
    for s in [0.010] * 20 + [0.021] * 8:
        measured.record("fp_doctored", s, k=1)
    assert jmeasured.load("fp_doctored") == measured.load("fp_doctored")
    sentinels = [jregress.RegressionSentinel(every_s=0.0), regress.RegressionSentinel(every_s=0.0)]
    fired = [sen.check(1000.0) for sen in sentinels]
    assert fired[0] == fired[1] and len(fired[1]) == 1
    assert fired[1][0]["severity"] == "critical" and fired[1][0]["fingerprint"] == "fp_doctored"
    assert [sen.check(1010.0) for sen in sentinels] == [[], []]
    assert sentinels[0].alerts() == sentinels[1].alerts()
    for s in [0.010] * 16:
        measured.record("fp_doctored", s, k=1)
    assert [sen.check(1020.0) for sen in sentinels] == [[], []]
    assert sentinels[1].alerts() == []
    dumps = [json.loads(p.read_text()) for p in tmp_path.glob("flightrec-*.json")]
    assert dumps and all(d["reason"] == "perf_regression" for d in dumps)


def test_serving_rates_are_sampled_from_the_counters():
    sen = regress.RegressionSentinel(every_s=0.0)
    tok, dis = metrics.counter_value("infer.tokens"), metrics.counter_value("infer.decode_dispatches")
    sen._sample_rates(100.0)
    metrics.counter_inc("infer.tokens", 500)
    metrics.counter_inc("infer.decode_dispatches", 250)
    sen._sample_rates(110.0)
    assert list(sen._rates["decode_tokens_per_sec"]) == [pytest.approx(50.0)]
    assert list(sen._rates["dispatches_per_token"]) == [pytest.approx(0.5)]
    assert metrics.counter_value("infer.tokens") == tok + 500
    assert metrics.counter_value("infer.decode_dispatches") == dis + 250


# ------------------------------------------------------- the tick hooks
def test_on_tick_is_a_no_op_until_flags_slo(model, monkeypatch):
    """The scheduler, the in-process fleet, the process fleet and
    ``run_steps`` evaluate nothing while ``FLAGS_slo`` is off; each installs
    the default spec set and evaluates once it is on."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    net = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=1)
    step = TrainStep(net, AdamW(parameters=net.parameters()), GPTPretrainingCriterion())
    ids = torch.randint(0, 512, (2, 2, 16), generator=torch.Generator().manual_seed(0))
    pfleet = ProcServingFleet(GPTConfig.tiny(), model_seed=0, replicas=1, device="cpu",
                              heartbeat_timeout=60.0, **KW)
    try:
        drivers = {
            "scheduler": lambda: ContinuousBatchingScheduler(DecodeEngine(model, **KW)).step(),
            "fleet": lambda: ServingFleet(model, replicas=1, **KW).step(),
            "procfleet": pfleet.step,
            "run_steps": lambda: step.run_steps((ids, ids), k=2),
        }
        for name, drive in drivers.items():
            evals = metrics.counter_value("slo.evaluations")
            drive()
            assert slo.installed() is None, name
            assert metrics.counter_value("slo.evaluations") == evals, name
        for name, drive in drivers.items():
            set_flags({"FLAGS_slo": True})
            evals = metrics.counter_value("slo.evaluations")
            drive()
            mon = slo.installed()
            assert mon is not None and set(mon.specs) == {s.name for s in slo.default_specs()}, name
            assert metrics.counter_value("slo.evaluations") > evals, name
            slo.uninstall()
            set_flags({"FLAGS_slo": False})
    finally:
        pfleet.shutdown()


# ------------------------------------------------------ chaos -> page, e2e
def _serve(model, prompts):
    fleet = ServingFleet(model, replicas=2, **KW)
    for i, p in enumerate(prompts):
        fleet.submit(p, max_new_tokens=6, seed=i)
    fleet.run()


def _alert_events(tmp_path):
    runlog.monitor().flush()
    events = []
    for f in sorted(tmp_path.glob("run-*.jsonl")):
        events.extend(json.loads(line) for line in f.read_text().splitlines() if line)
    return [e for e in events if e.get("event") == "alert" and e.get("slo") == "serving.ttft_p50_ms"]


def test_slow_replica_pages_then_clears(model, tmp_path):
    """The reference's ``TestChaosAlertingEndToEnd`` on the port: a fleet
    run under ``FLAGS_chaos_replica_slow_ms`` fires a page-severity TTFT
    alert, visible in ``/alerts``, degrading ``/healthz`` to 503 and written
    as an ``alert`` run-log event with its burn rates; it clears once the
    chaos traffic ages out of both windows; ``watch --once`` renders it."""
    set_flags({"FLAGS_run_log_dir": str(tmp_path)})
    runlog.monitor().clear()
    prompts = _prompts(4)
    _serve(model, prompts)
    metrics._GAUGES.pop("serving.spec_acceptance_rate", None)
    mon = slo.install(eval_every_s=1e9, fast_window_s=30.0, slow_window_s=120.0)
    exp = exporter.MetricsExporter(port=0).start()
    try:
        t0 = time.time()
        mon.evaluate(t0)
        assert mon.health_probe()["ok"] is True
        with chaos.inject(FLAGS_chaos_replica_slow_ms="120"):
            _serve(model, prompts)
        out = mon.evaluate(t0 + 10)
        ttft = out["serving.ttft_p50_ms"]
        assert ttft["severity"] == "page", out
        assert ttft["sli"] > 100.0 and ttft["burn_fast"] >= 2.0
        assert mon.health_probe()["ok"] is False

        with urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/alerts", timeout=5) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "application/json"
            doc = json.loads(r.read().decode())
        assert doc["firing"] >= 1 and doc["page"] >= 1
        mine = [a for a in doc["alerts"] if a.get("slo") == "serving.ttft_p50_ms"]
        assert mine and mine[0]["severity"] == "page" and mine[0]["source"] == "slo"

        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/healthz", timeout=5)
        assert err.value.code == 503
        body = json.loads(err.value.read().decode())
        assert body["status"] == "degraded" and body["components"]["slo"]["ok"] is False
        assert "serving.ttft_p50_ms" in body["components"]["slo"]["page"]

        events = _alert_events(tmp_path)
        assert events and events[0]["state"] == "firing" and events[0]["severity"] == "page"
        assert events[0]["burn_fast"] >= 2.0 and "burn_slow" in events[0]
        assert events[0]["objective"] == "serving.ttft_p50_ms <= 50"
        assert obs_main(["watch", str(tmp_path), "--once", "--no-scrape"]) == 0

        _serve(model, prompts)
        mon.evaluate(t0 + 40)
        mon.evaluate(t0 + 200)
        out = mon.evaluate(t0 + 400)
        assert out["serving.ttft_p50_ms"]["severity"] is None
        assert mon.health_probe()["ok"] is True
        with urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/healthz", timeout=5) as r:
            assert r.status == 200
        assert _alert_events(tmp_path)[-1]["state"] == "cleared"
    finally:
        exp.stop()
        runlog.monitor().close()


def test_install_uninstall_wires_the_exporter():
    mon = slo.install(eval_every_s=1e9)
    assert slo.installed() is mon and mon.regress is not None
    assert "slo" in exporter._HEALTH and {"slo", "regress"} <= set(exporter._ALERTS)
    slo.uninstall()
    assert slo.installed() is None
    assert "slo" not in exporter._HEALTH and "slo" not in exporter._ALERTS

"""The port's run-log reader (``python -m paddle_tpu_torch.observability``)
against the reference's, on the CPU.

A run log that a tiny port fleet writes (a replica killed mid-stream, so
requeues and their trace paths are in it), beside two processes whose
clocks differ by 5 s and that align through ``trace.sync_clocks``, goes
through both packages' ``analyze``, ``analyze_merged`` and
``chrome_trace_doc``: the documents are equal. So are the reference's
synthetic logs and the watch snapshot. Last, the sanitizer's ledger-growth
sentinel in warn and in strict mode.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
import warnings

import numpy as np
import pytest

import paddle_tpu.observability.__main__ as jreport

from paddle_tpu_torch.analysis import sanitizer
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.framework.flags import get_flags, set_flags
from paddle_tpu_torch.inference import ServingFleet
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.observability import metrics, runlog
from paddle_tpu_torch.observability import __main__ as report
from paddle_tpu_torch.testing import chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_batch_slots=2, max_seq_len=64, prefill_chunk=8, fuse=2)
SKEW = 5.0

# one of two processes meeting at a store: rank 1's wall clock runs SKEW s
# ahead; both sync clocks, place and finish a request, and report 3 steps
_CHILD = textwrap.dedent("""
    import os, time as _time
    rank, skew = int(os.environ["OBS_RANK"]), float(os.environ["OBS_SKEW"])
    if skew:
        _real = _time.time
        _time.time = lambda: _real() + skew
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.observability import runlog, trace
    set_flags({"FLAGS_run_log_dir": os.environ["OBS_DIR"]})
    store = TCPStore(port=int(os.environ["OBS_PORT"]), timeout=60.0)
    trace.sync_clocks(store, rank, 2, timeout=60.0)
    tid = trace.new_trace_id("fleet")
    runlog.emit("fleet", kind="placed", component="fleet", id=rank, replica=rank, trace=tid)
    for s in (1, 2, 3):
        store.set("step/%d/%d" % (s, rank), "1")
        store.get("step/%d/%d" % (s, 1 - rank), timeout=60.0)
        runlog.emit("step", step=s, k=1, seconds=0.01)
    runlog.emit("fleet", kind="finished", component="fleet", id=rank, replica=rank,
                trace=tid, seconds=0.05, attempts=1)
    runlog.monitor().close()
""")


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """A directory of run logs: this process's tiny fleet run under a
    replica kill, and the two clock-skewed processes."""
    d = tmp_path_factory.mktemp("runlogs")
    prev = get_flags(["FLAGS_run_log_dir"])
    set_flags({"FLAGS_run_log_dir": str(d)})
    try:
        model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=0).eval()
        rng = np.random.default_rng(0)
        with chaos.inject(FLAGS_chaos_replica_kill_at="1:2"):
            fleet = ServingFleet(model, replicas=2, **KW)
            for i in range(6):
                fleet.submit(rng.integers(0, 512, (int(rng.integers(3, 20)),)),
                             max_new_tokens=6, seed=i)
            fleet.run()
        assert fleet.stats()["dead"] == [1]
        own = runlog.monitor().path
    finally:
        runlog.monitor().close()
        set_flags(prev)
    master = TCPStore(is_master=True, timeout=60.0)
    try:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", OBS_PORT=str(master.port),
                   OBS_DIR=str(d))
        procs = [subprocess.Popen([sys.executable, "-c", _CHILD],
                                  env=dict(env, OBS_RANK=str(r), PADDLE_TRAINER_ID=str(r),
                                           OBS_SKEW=str(SKEW if r else 0.0)))
                 for r in (0, 1)]
        assert [p.wait(timeout=120) for p in procs] == [0, 0]
    finally:
        master.close()
    return str(d), own


def test_single_log_analysis_equals_the_reference(logs):
    d, own = logs
    events = report.load_events(own)
    assert events == jreport.load_events(own)
    a = report.analyze(events)
    assert a == jreport.analyze(events)
    assert a["fleet"]["replica_deaths"] == 1 and a["fleet"]["requeues"] >= 1
    assert a["serving"]["finished"] >= 6


def test_merged_analysis_aligns_clocks_as_the_reference(logs):
    d, _ = logs
    m = report.analyze_merged(d)
    assert json.dumps(m, sort_keys=True) == json.dumps(jreport.analyze_merged(d), sort_keys=True)
    offs = {p["rank"]: p["offset_seconds"] for p in m["processes"].values() if p["rank"] is not None}
    assert abs(offs[0]) < 1.0 and abs(offs[1] - SKEW) < 2.0
    assert m["step_skew"]["steps_compared"] == 3 and m["step_skew"]["max_seconds"] < 2.0
    assert m["requeue_edges"] and all(e["from"] == 1 and e["to"] == 0 for e in m["requeue_edges"])
    assert m["traces"]["count"] >= 6
    doc = report.chrome_trace_doc(d)
    assert doc == jreport.chrome_trace_doc(d)
    tracks = [e for e in doc["traceEvents"] if e.get("name") == "process_name"]
    assert len(tracks) == 3


def test_cli_report_merge_trace_and_watch(logs, tmp_path, capsys):
    d, own = logs
    assert report.main(["report", own]) == 0
    assert "serving fleet" in capsys.readouterr().out
    assert report.main(["report", own, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(jreport.analyze(
        jreport.load_events(own))))
    assert report.main(["report", "--merge", d]) == 0
    assert "per-replica lanes" in capsys.readouterr().out
    out = tmp_path / "trace.json"
    assert report.main(["trace", d, "--out", str(out)]) == 0
    assert json.loads(out.read_text()) == json.loads(json.dumps(jreport.chrome_trace_doc(d)))
    assert report.main(["watch", d, "--once", "--no-scrape"]) == 0
    assert "paddle_tpu_torch watch" in capsys.readouterr().out
    assert report.main(["report", "--merge", str(tmp_path)]) == 1  # no run logs there


def _write(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


def test_synthetic_training_log_equals_the_reference(tmp_path):
    """The reference's ``TestReportCLI`` log: compile, fused steps, a
    checkpoint."""
    p = tmp_path / "run.jsonl"
    _write(p, [
        {"ts": 100.0, "event": "run_start", "pid": 1},
        {"ts": 100.1, "event": "compile", "component": "train_step", "seconds": 2.0, "flops": 1e9},
        {"ts": 102.2, "event": "step", "step": 1, "k": 1, "seconds": 0.010},
        {"ts": 102.3, "event": "step", "step": 2, "k": 1, "seconds": 0.020},
        {"ts": 102.4, "event": "step", "step": 6, "k": 4, "seconds": 0.040},
        {"ts": 102.5, "event": "checkpoint_save", "step": 6, "seconds": 0.5},
    ])
    a = report.analyze(report.load_events(str(p)))
    assert a == jreport.analyze(jreport.load_events(str(p)))
    assert a["steps"] == 6 and a["step_time"]["count"] == 6
    assert a["phase_seconds"]["compile[train_step]"] == 2.0


def test_watch_snapshot_equals_the_reference(tmp_path):
    now = time.time()
    _write(tmp_path / "run-0.jsonl", [
        {"event": "request", "status": "finished", "ttft_seconds": 0.02, "total_seconds": 0.2,
         "ts": now - 10},
        {"event": "request", "status": "finished", "ttft_seconds": 0.04, "total_seconds": 0.4,
         "ts": now - 5},
        {"event": "fleet", "kind": "membership", "alive": [0], "dead": [1], "ts": now - 4},
        {"event": "alert", "component": "slo", "slo": "serving.ttft_p50_ms", "state": "firing",
         "severity": "page", "sli": 160.0, "objective": "serving.ttft_p50_ms <= 50",
         "burn_fast": 3.2, "burn_slow": 1.1, "budget_remaining": 0.4, "ts": now - 3},
        {"event": "alert", "slo": "t.x", "state": "firing", "severity": "page", "ts": now - 20},
        {"event": "alert", "slo": "t.x", "state": "cleared", "severity": "page", "ts": now - 2},
        {"event": "perf_regression", "kind": "measured", "fingerprint": "fp9", "state": "firing",
         "severity": "warn", "before": 0.01, "after": 0.02, "ts": now - 1},
    ])
    snap = report.build_watch_snapshot(str(tmp_path), 60.0, scrape=False)
    assert snap == jreport.build_watch_snapshot(str(tmp_path), 60.0, scrape=False)
    assert {a.get("slo") or a.get("fingerprint") for a in snap["alerts"]} == {
        "serving.ttft_p50_ms", "fp9"}
    text = report.render_watch(snap)
    assert text.split("\n", 1)[1] == jreport.render_watch(snap).split("\n", 1)[1]
    assert "ALERT" in text and "1 dead [1]" in text


# ----------------------------------------------------- the ledger sentinel
@pytest.fixture
def sanitize():
    prev = get_flags(["FLAGS_sanitize", "FLAGS_sanitize_strict"])
    sanitizer.reset()
    yield
    sanitizer.reset()
    set_flags(prev)


def test_note_ledger_is_off_then_warns_once_per_ledger_then_raises(sanitize):
    trips = metrics.counter_value("sanitizer.ledger_growth")
    sanitizer.note_ledger("fleet", "requests", 500, bound=10)  # FLAGS_sanitize off
    assert metrics.counter_value("sanitizer.ledger_growth") == trips
    set_flags({"FLAGS_sanitize": True})
    runlog.monitor().clear()
    sanitizer.note_ledger("fleet", "requests", 10, bound=10)  # at the bound: fine
    with pytest.warns(RuntimeWarning, match="unbounded host-state growth at fleet.requests"):
        sanitizer.note_ledger("fleet", "requests", 11, bound=10)
    with pytest.warns(RuntimeWarning):
        sanitizer.note_ledger("fleet", "requests", 12, bound=10)
    assert metrics.counter_value("sanitizer.ledger_growth") == trips + 2
    events = runlog.monitor().events("sanitizer")
    assert [(e["kind"], e["component"], e["size"]) for e in events] == [
        ("ledger_growth", "fleet", 11)]  # one event per ledger
    assert sanitizer.stats() == {"fleet.requests": 2}
    set_flags({"FLAGS_sanitize_strict": True})
    with pytest.raises(sanitizer.LedgerGrowthError) as err:
        sanitizer.note_ledger("procfleet", "requests", 99, bound=20)
    assert (err.value.component, err.value.size, err.value.bound) == ("procfleet", 99, 20)


def test_the_fleet_tick_checks_its_ledger(sanitize, monkeypatch):
    """The in-process fleet checks its ledger after its keep-last-k GC on
    every tick: with the GC broken, delivered requests pile up past the
    bound (2 * keep_finished + max_queue_depth) and trip the sentinel."""
    set_flags({"FLAGS_sanitize": True})
    model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=0).eval()
    fleet = ServingFleet(model, replicas=1, keep_finished=1, max_queue_depth=1,
                         max_batch_slots=2, max_seq_len=64)
    monkeypatch.setattr(fleet, "_gc_ledger", lambda protect=(): None)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        for i in range(5):
            fleet.submit(np.arange(4) + i, max_new_tokens=2)
            fleet.run()
    assert len(fleet.requests) == 5
    assert any("fleet.requests: 4 entries > bound 3" in str(w.message) for w in got)
    assert sanitizer.stats() == {"fleet.requests": 2}

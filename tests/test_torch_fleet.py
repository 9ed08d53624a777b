"""Serving fleet of the port (``paddle_tpu_torch.inference.fleet``/``router``)
against the reference's, on the CPU at ``GPTConfig.tiny()``.

Weights move across by ``utils/convert.py``; both fleets get the same numpy
prompts. Greedy tokens and the replica each request lands on equal the
reference's; the kill/requeue, admin kill, cascade death, all-dead,
overload, deadline, slow-replica, store-heartbeat and scale-out cases of
``tests/test_fleet.py`` end as the reference's do. Faults are driven by the
chaos seams at tick counts; a deadline or a heartbeat loss is made certain
by an injected slow tick, never by a race with the wall clock.
"""
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import resilience as jresilience
from paddle_tpu.inference import FleetDrainedError as JFleetDrainedError
from paddle_tpu.inference import FleetOverloadError as JFleetOverloadError
from paddle_tpu.inference import Router as JRouter
from paddle_tpu.inference import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.inference import DecodeEngine as JDecodeEngine
from paddle_tpu.inference import ServingFleet as JServingFleet
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.testing import chaos as jchaos

from paddle_tpu_torch.distributed import resilience
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.framework.flags import get_flags, set_flags
from paddle_tpu_torch.inference import (
    ContinuousBatchingScheduler,
    DecodeEngine,
    FleetDrainedError,
    FleetOverloadError,
    Router,
    ServingFleet,
)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.observability import metrics, runlog
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu

# bench_serve.py:_measure_fleet's CPU branch: 2 slots, cache 128, chunk 16,
# fuse 2, 16 MB of prefix cache per replica
BENCH_KW = dict(max_batch_slots=2, max_seq_len=128, prefill_chunk=16, fuse=2, prefix_cache_mb=16.0)
# tests/test_fleet.py's engine spec
KW = dict(max_batch_slots=2, max_seq_len=64, prefill_chunk=8, fuse=2)


@pytest.fixture(scope="module")
def models():
    """The reference's tiny GPT and the port's with its weights."""
    paddle.seed(0)
    jm = JGPT(JGPTConfig.tiny())
    jm.eval()
    pm = GPTForPretraining(GPTConfig.tiny(), device="cpu").eval()
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    return jm, pm


@pytest.fixture(autouse=True)
def _clean():
    """Chaos, the flags the cases set and the fleet counters start clean."""
    chaos.reset()
    jchaos.reset()
    names = ["FLAGS_run_log_dir", "FLAGS_trace", "FLAGS_slo", "FLAGS_sanitize",
             "FLAGS_metrics_port", "FLAGS_compile_cache_dir", "FLAGS_store_retry_jitter"]
    prev = get_flags(names)
    metrics.reset_counters("fleet.")
    yield
    set_flags(prev)
    chaos.reset()
    jchaos.reset()


def _prompts(n, lens=(5, 9, 3, 12, 7, 11)):
    rng = np.random.default_rng(42)
    return [rng.integers(0, 512, (lens[i % len(lens)],)) for i in range(n)]


def _bench_prompts(n=10, chunk=16):
    """bench_serve.py:326-332 at the CPU branch: a 2-chunk shared prefix and
    tails of chunk/4 to chunk - 1 tokens."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 512, (2 * chunk,))
    return [np.concatenate([shared, rng.integers(0, 512, (int(m),))])
            for m in rng.integers(max(1, chunk // 4), chunk, n)]


def _serve(fleet, prompts, max_new=6, **submit_kw):
    fids = [fleet.submit(p.astype(np.int32), max_new_tokens=max_new, seed=i, **submit_kw)
            for i, p in enumerate(prompts)]
    return fids, fleet.run()


def _both(models, prompts, kill=None, max_new=6, replicas=2, **kw):
    """The same run through the reference's fleet and the port's, each
    under its own package's chaos injection when ``kill`` (chaos flags) is
    given; returns ``(jfleet, jfids, jdone), (pfleet, pfids, pdone)``."""
    jm, pm = models
    out = []
    for make, inj in ((lambda: JServingFleet(jm, replicas=replicas, **kw), jchaos.inject),
                      (lambda: ServingFleet(pm, replicas=replicas, **kw), chaos.inject)):
        if kill:
            with inj(**kill):
                fleet = make()
                fids, done = _serve(fleet, prompts, max_new)
        else:
            fleet = make()
            fids, done = _serve(fleet, prompts, max_new)
        out.append((fleet, fids, done))
    return out


# ----------------------------------------------------------- parity pins
def test_fleet_tokens_and_placement_equal_reference(models):
    """bench_serve.py's fleet phase at its CPU sizes: the port's 2-replica
    fleet gives the reference's greedy tokens, places every request on the
    reference's replica, and its router keeps the reference's counts."""
    (jf, jfids, jdone), (pf, pfids, pdone) = _both(models, _bench_prompts(), max_new=8,
                                                    **BENCH_KW)
    assert [pdone[f].tokens for f in pfids] == [list(jdone[f].tokens) for f in jfids]
    assert [pf.requests[f].replica for f in pfids] == [jf.requests[f].replica for f in jfids]
    assert pf.router.stats() == jf.router.stats()
    assert pf.router.stats()["affinity_hits"] > 0  # the shared prefix routed by affinity
    assert len({pf.requests[f].replica for f in pfids}) == 2
    # and the prefix cache of each replica really served the shared chunks
    assert sum(r.engine.prefix_cache.hits for r in pf.replicas.values()) > 0


def test_stats_keys_equal_reference(models):
    jm, pm = models
    jst = JServingFleet(jm, replicas=2, **KW).stats()
    pst = ServingFleet(pm, replicas=2, **KW).stats()
    assert set(pst) == set(jst)
    assert set(pst["per_replica"][0]) == set(jst["per_replica"][0])
    assert set(pst["router"]) == set(jst["router"])


def test_router_place_equals_reference_over_a_seeded_stream():
    """Router.place against the reference's on 400 seeded prompts and load
    maps, with registrations and replica deaths interleaved: the same
    (replica, reason) every time and the same counts after."""
    rng = np.random.default_rng(7)
    heads = [rng.integers(0, 50, (24,)) for _ in range(4)]
    for chunk, slack in ((8, 2), (4, 0), (None, 2)):
        ref = JRouter(chunk=chunk, affinity_load_slack=slack)
        mine = Router(chunk=chunk, affinity_load_slack=slack)
        for _ in range(400):
            head = heads[int(rng.integers(0, len(heads)))][:int(rng.integers(0, 25))]
            prompt = np.concatenate([head, rng.integers(0, 50, (int(rng.integers(1, 12)),))])
            ids = sorted(rng.choice(5, size=int(rng.integers(1, 5)), replace=False).tolist())
            loads = {int(r): int(rng.integers(0, 6)) for r in ids}
            got = mine.place(prompt, loads)
            assert got == ref.place(prompt.astype(np.int32), loads)
            assert mine.register(prompt, got[0]) == ref.register(prompt.astype(np.int32), got[0])
            if rng.random() < 0.05:
                dead = int(rng.integers(0, 5))
                assert mine.forget_replica(dead) == ref.forget_replica(dead)
        assert mine.stats() == ref.stats()
    with pytest.raises(RuntimeError, match="no healthy replicas"):
        Router(chunk=8).place(np.arange(10), {})


def test_router_load_tiebreak_and_slack():
    r = Router(chunk=8, affinity_load_slack=1)
    prompt = np.arange(32, dtype=np.int32)
    r.register(prompt, 1)
    assert r.place(prompt, {0: 0, 1: 1}) == (1, "affinity")
    assert r.place(prompt, {0: 0, 1: 5}) == (0, "load")
    assert r.place(prompt, {0: 2, 1: 7, 2: 2}) == (0, "load")  # id tiebreak
    r.forget_replica(1)
    assert r.place(prompt, {0: 3, 1: 0}) == (1, "load")


# --------------------------------------------------------- kill + requeue
def test_mid_stream_kill_exactly_once_bitwise_as_reference(models):
    """FLAGS_chaos_replica_kill_at="1:2" on both fleets: every request
    finishes once with the unkilled run's tokens, and the deaths, requeues,
    attempts and final placements equal the reference's."""
    prompts = _prompts(6)
    (_, _, _), (_, pfids0, pdone0) = _both(models, prompts, **KW)
    want = [pdone0[f].tokens for f in pfids0]
    (jf, jfids, jdone), (pf, pfids, pdone) = _both(
        models, prompts, kill=dict(FLAGS_chaos_replica_kill_at="1:2"), **KW)
    st, jst = pf.stats(), jf.stats()
    assert st["dead"] == jst["dead"] == [1] and st["alive"] == [0]
    assert st["requeues"] == jst["requeues"] >= 1
    assert sorted(pdone) == sorted(pfids)
    assert [pdone[f].tokens for f in pfids] == want == [list(jdone[f].tokens) for f in jfids]
    assert [pdone[f].attempts for f in pfids] == [jdone[f].attempts for f in jfids]
    assert [pdone[f].replica for f in pfids] == [jdone[f].replica for f in jfids]
    c = metrics.counters("fleet.")
    assert c["fleet.replica_deaths"] == 1
    assert c["fleet.requeues"] == st["requeues"]
    assert c["fleet.requests_completed"] == 2 * len(prompts)
    assert "ChaosCrash" in st["per_replica"][1]["death_reason"]


def test_admin_kill_requeues_queued_and_running_as_reference(models):
    jm, pm = models
    prompts = _prompts(6)
    out = []
    for fleet in (JServingFleet(jm, replicas=2, **KW), ServingFleet(pm, replicas=2, **KW)):
        fids = [fleet.submit(p.astype(np.int32), max_new_tokens=6, seed=i)
                for i, p in enumerate(prompts)]
        fleet.step()
        assert any(fleet.requests[f].replica == 1 for f in fids)
        fleet.kill_replica(1)
        done = fleet.run()
        assert sorted(done) == sorted(fids)
        out.append([(list(done[f].tokens), done[f].attempts, done[f].replica) for f in fids])
    assert out[1] == out[0]
    assert all(rep == 0 for _, attempts, rep in out[1] if attempts > 1)


def test_all_replicas_dead_is_loud_as_reference(models):
    jm, pm = models
    lost = []
    for fleet, err in ((JServingFleet(jm, replicas=1, **KW), JFleetDrainedError),
                       (ServingFleet(pm, replicas=1, **KW), FleetDrainedError)):
        fid = fleet.submit(_prompts(1)[0].astype(np.int32), max_new_tokens=6)
        fleet.step()
        with pytest.raises(err) as ei:
            fleet.kill_replica(0)
        assert fid in ei.value.lost
        lost.append(ei.value.lost)
        with pytest.raises(err):
            fleet.submit(_prompts(1)[0].astype(np.int32), max_new_tokens=2)
    assert lost[0] == lost[1]


def test_cascade_death_during_requeue_keeps_full_lost_accounting(models, monkeypatch):
    """The survivor dies while absorbing requeued work: the re-entrant drain
    reports every in-flight fid lost once, as the reference's does."""
    jm, pm = models
    lost = []
    for fleet, err in ((JServingFleet(jm, replicas=2, **KW), JFleetDrainedError),
                       (ServingFleet(pm, replicas=2, **KW), FleetDrainedError)):
        fids = [fleet.submit(p.astype(np.int32), max_new_tokens=4, seed=i, replica=i % 2)
                for i, p in enumerate(_prompts(4))]
        orig_place = fleet._place
        fired = []

        def cascade_place(freq, rid, reason, deadline_s="unset", fleet=fleet,
                          orig_place=orig_place, fired=fired):
            orig_place(freq, rid, reason, deadline_s=deadline_s)
            if not fired and reason.startswith("requeue"):
                fired.append(rid)
                fleet._on_replica_death(fleet.replicas[rid],
                                        RuntimeError("cascade: survivor died absorbing requeue"))

        monkeypatch.setattr(fleet, "_place", cascade_place)
        with pytest.raises(err) as ei:
            fleet.kill_replica(0)
        assert sorted(ei.value.lost) == sorted(fids)
        assert fleet.stats()["alive"] == []
        assert not fleet._draining and not fleet._requeue_backlog
        lost.append(sorted(ei.value.lost))
    assert lost[0] == lost[1]


# --------------------------------------------------- graceful degradation
def test_overload_sheds_structured_as_reference(models):
    jm, pm = models
    p = _prompts(1)[0].astype(np.int32)
    seen = []
    for fleet, err in ((JServingFleet(jm, replicas=1, max_queue_depth=2, **KW), JFleetOverloadError),
                       (ServingFleet(pm, replicas=1, max_queue_depth=2, **KW), FleetOverloadError)):
        fleet.submit(p, max_new_tokens=4)
        fleet.submit(p, max_new_tokens=4)
        with pytest.raises(err) as ei:
            fleet.submit(p, max_new_tokens=4)
        e = ei.value
        seen.append((e.queued, e.limit, e.replicas_alive, e.retry_after_s))
        fleet.run()
        fleet.submit(p, max_new_tokens=4)  # drained: admission reopens
    assert seen[0] == seen[1] == (2, 2, 1, 30.0)
    assert metrics.counters("fleet.")["fleet.sheds"] == 1


def test_deadline_expires_under_a_slow_tick_as_reference(models):
    """An injected 60 ms tick makes a 20 ms deadline certain to pass before
    the first scheduler step: the request ends deadline_exceeded with no
    token, on both fleets; the slot is free for the next request."""
    jm, pm = models
    p = _prompts(1)[0].astype(np.int32)
    seen = []
    for fleet, inj in ((JServingFleet(jm, replicas=1, **KW), jchaos.inject),
                       (ServingFleet(pm, replicas=1, **KW), chaos.inject)):
        with inj(FLAGS_chaos_replica_slow_ms="60"):
            fid = fleet.submit(p, max_new_tokens=40, deadline_s=0.02)
            fleet.run()
        freq = fleet.requests[fid]
        seen.append((freq.status, list(freq.tokens)))
        fid2 = fleet.submit(p, max_new_tokens=4)
        assert fleet.run()[fid2].status == "finished"
    assert seen[0] == seen[1] == ("deadline_exceeded", [])
    assert metrics.counters("fleet.")["fleet.deadline_hits"] == 1


def test_fleet_cancel_frees_slot_and_marks_ledger(models):
    _, pm = models
    fleet = ServingFleet(pm, replicas=1, **KW)
    p = _prompts(2)
    fid = fleet.submit(p[0], max_new_tokens=30, seed=1)
    while not fleet.replicas[0].scheduler.running:
        fleet.step()
    fleet.step()
    assert 0 < len(fleet.tokens_so_far(fid)) < 30
    assert fleet.cancel(fid) is True
    assert fleet.cancel(fid) is False  # terminal: no-op
    assert fleet.requests[fid].status == "cancelled"
    assert fleet.replicas[0].engine.free_slots() == [0, 1]
    fid2 = fleet.submit(p[1], max_new_tokens=4)
    assert fleet.run()[fid2].status == "finished"
    assert metrics.counters("fleet.")["fleet.cancels"] == 1


# ------------------------------------------------------ health + heartbeat
def test_slow_replica_declared_dead_and_drained_as_reference(models):
    """Replica 1's ticks take 1.5 s against a 1 s heartbeat window: it is
    declared dead after its first tick and its work requeues, on both
    fleets, with the same tokens."""
    prompts = _prompts(4, lens=(5,))
    outs = []
    for side in _both(models, prompts, kill=dict(FLAGS_chaos_replica_slow_ms="1:1500"),
                      max_new=4, heartbeat_timeout=1.0, **KW):
        fleet, fids, done = side
        st = fleet.stats()
        assert st["dead"] == [1]
        assert "heartbeat lost" in st["per_replica"][1]["death_reason"]
        assert sorted(done) == sorted(fids)
        outs.append([list(done[f].tokens) for f in fids])
    assert outs[0] == outs[1]


def test_store_heartbeats_published(models):
    _, pm = models
    store = TCPStore(is_master=True, timeout=60.0)
    try:
        fleet = ServingFleet(pm, replicas=2, store=store, **KW)
        fid = fleet.submit(_prompts(1)[0], max_new_tokens=4)
        fleet.run()
        ages = fleet.membership()
        assert set(ages) == {0, 1}
        assert all(0 <= a < float("inf") for a in ages.values())
        assert fleet.requests[fid].status == "finished"
    finally:
        store.close()
    with pytest.raises(RuntimeError, match="no store"):
        ServingFleet(pm, replicas=1, **KW).membership()


def test_scale_out_serves_a_cold_replica_as_reference(models):
    jm, pm = models
    p = _prompts(1)[0].astype(np.int32)
    seen, built = [], []
    for fleet, reg in ((JServingFleet(jm, replicas=1, **KW), jmetrics),
                       (ServingFleet(pm, replicas=1, **KW), metrics)):
        c0 = reg.counters("infer.")["infer.compiles"]
        f0 = fleet.submit(p, max_new_tokens=4, seed=1)
        fleet.run()
        new = fleet.scale_out(1)
        f1 = fleet.submit(p, max_new_tokens=4, seed=1, replica=new[0])
        done = fleet.run()
        assert list(done[f1].tokens) == list(fleet.requests[f0].tokens)
        seen.append((new, list(done[f1].tokens), fleet.stats()["alive"]))
        built.append(reg.counters("infer.")["infer.compiles"] - c0)
    assert seen[0] == seen[1]
    assert metrics.counters("fleet.")["fleet.scale_outs"] == 1
    # the heartbeat's warm-up exemption reads these: the scale-out replica
    # builds its programs again, as the reference's compiles them (the port
    # has no AOT cache to load them from)
    assert built[0] == built[1] > 0
    assert metrics.counters("infer.")["infer.aot_cache_hits"] == 0


@pytest.mark.parametrize("side", ["reference", "port"])
def test_cold_first_tick_is_exempt_and_a_slow_warm_tick_dies(models, side):
    """Replica 0's ticks take 400 ms against a 200 ms heartbeat window. Its
    first tick builds the prefill and decode programs (``infer.compiles``
    moves), so it survives that tick; its second builds nothing and is
    declared dead, and its request finishes on replica 1: in both packages."""
    jm, pm = models
    make, inj, reg = ((lambda **kw: JServingFleet(jm, **kw), jchaos.inject, jmetrics)
                      if side == "reference" else
                      (lambda **kw: ServingFleet(pm, **kw), chaos.inject, metrics))
    with inj(FLAGS_chaos_replica_slow_ms="0:400"):
        fleet = make(replicas=2, heartbeat_timeout=0.2, **KW)
        fid = fleet.submit(_prompts(1)[0].astype(np.int32), max_new_tokens=6, replica=0)
        c0 = reg.counters("infer.")["infer.compiles"]
        fleet.step()
        assert reg.counters("infer.")["infer.compiles"] > c0
        assert fleet.replicas[0].last_tick_seconds > fleet.heartbeat_timeout
        assert fleet.stats()["dead"] == []
        fleet.step()
        st = fleet.stats()
        assert st["dead"] == [0]
        assert "heartbeat lost" in st["per_replica"][0]["death_reason"]
        done = fleet.run()
    assert done[fid].status == "finished" and fleet.requests[fid].replica == 1


@pytest.mark.parametrize("knobs", [
    dict(prefill_buckets=(8, 16, 32)),
    dict(prefill_chunk=8, fuse=2, prefix_cache_mb=1.0),
    dict(prefill_buckets=(16, 32), spec="self"),
], ids=["bucketed", "chunked-prefix-fused", "spec"])
def test_program_signatures_count_as_the_reference_compiles(models, knobs):
    """The same request stream moves ``infer.compiles`` by the same amount
    in both engines: one per (program, varying shape) signature, each
    prefill bucket, chunk program, prefix insert/extract, fuse depth and
    speculative step once per engine. (No signature differs by design.)"""
    jm, pm = models
    knobs = dict(knobs)
    spec = knobs.pop("spec", None)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 512, (16,))
    prompts = [rng.integers(0, 512, (int(n),)) for n in (5, 12, 3, 20)]
    prompts += [np.concatenate([shared, rng.integers(0, 512, (4,))]) for _ in range(2)]
    moved = []
    for eng_cls, model, sched_cls, reg in (
            (JDecodeEngine, jm, JScheduler, jmetrics),
            (DecodeEngine, pm, ContinuousBatchingScheduler, metrics)):
        kw = dict(knobs, draft=model, spec_k=2) if spec else knobs
        c0 = reg.counters("infer.")["infer.compiles"]
        sched = sched_cls(eng_cls(model, max_batch_slots=2, max_seq_len=64, **kw))
        for i, p in enumerate(prompts):
            sched.submit(p.astype(np.int32), max_new_tokens=5, seed=i)
        sched.run()
        moved.append(reg.counters("infer.")["infer.compiles"] - c0)
    assert moved[0] == moved[1] > 0


def test_ledger_keeps_last_k_and_run_returns_everything(models):
    _, pm = models
    fleet = ServingFleet(pm, replicas=2, keep_finished=2, **KW)
    fids, done = _serve(fleet, _prompts(6), max_new=3)
    assert sorted(done) == sorted(fids)
    assert fleet.stats()["finished_total"] == 6
    assert len(fleet.requests) <= 2 + 2  # keep-last-k plus this tick's
    for bad in (dict(replicas=0), dict(max_queue_depth=0), dict(keep_finished=0)):
        with pytest.raises(ValueError):
            ServingFleet(pm, **dict(KW, **bad))


# ------------------------------------------------- not ported: it raises
def test_unported_layers_raise_citing_roadmap(models):
    """The on-disk AOT cache is the fleet's one reference layer still not
    ported; the exporter, the SLO layer and the sanitizer arm
    (tests/test_torch_imports.py)."""
    _, pm = models
    set_flags({"FLAGS_compile_cache_dir": "/nonexistent"})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServingFleet(pm, replicas=1, **KW)


# ------------------------------------------------------------ chaos seams
@pytest.mark.parametrize("mod", [chaos, jchaos], ids=["port", "reference"])
def test_kill_hook_fires_once_per_replica(mod):
    with mod.inject(FLAGS_chaos_replica_kill_at="2:3"):
        assert not mod.replica_kill_due(2, 2)
        assert not mod.replica_kill_due(1, 5)
        assert mod.replica_kill_due(2, 3)
        assert not mod.replica_kill_due(2, 4)
    assert not mod.replica_kill_due(2, 3)


@pytest.mark.parametrize("mod", [chaos, jchaos], ids=["port", "reference"])
def test_slow_sigkill_hang_and_network_hook_specs(mod):
    assert mod.replica_slow_ms(0) == 0.0
    with mod.inject(FLAGS_chaos_replica_slow_ms="25"):
        assert mod.replica_slow_ms(0) == 25.0 and mod.replica_slow_ms(7) == 25.0
    with mod.inject(FLAGS_chaos_replica_slow_ms="1:40"):
        assert mod.replica_slow_ms(1) == 40.0 and mod.replica_slow_ms(0) == 0.0
    assert not mod.replica_sigkill_due(1, 99)
    with mod.inject(FLAGS_chaos_replica_sigkill_at="1:2"):
        assert not mod.replica_sigkill_due(0, 99)
        assert not mod.replica_sigkill_due(1, 1)
        assert mod.replica_sigkill_due(1, 2)
        assert not mod.replica_sigkill_due(1, 3)
    assert mod.replica_hang_due_ms(0) == 0.0
    with mod.inject(FLAGS_chaos_replica_hang_ms="250"):
        assert mod.replica_hang_due_ms(0) == 250.0
        assert mod.replica_hang_due_ms(0) == 0.0
        assert mod.replica_hang_due_ms(1) == 250.0
    with mod.inject(FLAGS_chaos_socket_drop_at="1:2"):
        assert not mod.socket_drop_due(0, 5) and not mod.socket_drop_due(1, 1)
        assert mod.socket_drop_due(1, 2) and not mod.socket_drop_due(1, 3)
    with mod.inject(FLAGS_chaos_ingress_disconnect_at=2, FLAGS_chaos_net_delay_ms=3.0):
        assert not mod.ingress_disconnect_due(1)
        assert mod.ingress_disconnect_due(2) and not mod.ingress_disconnect_due(3)
        assert mod.net_delay_ms() == 3.0
    assert mod.net_delay_ms() == 0.0


@pytest.mark.parametrize("mod", [chaos, jchaos], ids=["port", "reference"])
def test_store_drop_heals_after_count_and_crash_fires_once(mod):
    with mod.inject(FLAGS_chaos_store_drop_ops="get:a/", FLAGS_chaos_store_drop_count=2):
        mod.store_op("get", "b/x")  # other prefix: untouched
        for _ in range(2):
            with pytest.raises(mod.ChaosError):
                mod.store_op("get", "a/x")
        mod.store_op("get", "a/x")  # healed
    with mod.inject(FLAGS_chaos_crash_point="p", FLAGS_chaos_crash_at_step=3):
        mod.crash_if_due("p", 2)
        with pytest.raises(mod.ChaosCrash):
            mod.crash_if_due("p", 3)
        mod.crash_if_due("p", 3)  # once per (point, step)
        assert not mod.corrupt_due() and mod.nan_grads_due() is None


# ------------------------------------------------------------ retry jitter
def _sleeps(retry, seed_fn, monkeypatch, jitter, seed=42, attempts=4):
    """The backoff sleeps of one failing call, decorated by ``retry``. The
    decorated function's qualified name is the same for both packages, so
    their jitter streams (seeded on seed and name) are too."""
    seed_fn(seed)
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)

    @retry(max_attempts=attempts, base_delay=0.01, max_delay=0.05, jitter=jitter)
    def boom():
        raise OSError("injected")

    with pytest.raises(OSError):
        boom()
    monkeypatch.undo()
    return sleeps


@pytest.mark.parametrize("jitter", [True, False])
def test_retry_backoff_equals_reference(monkeypatch, jitter):
    got = _sleeps(resilience.retry, prandom.seed, monkeypatch, jitter)
    want = _sleeps(jresilience.retry, paddle.seed, monkeypatch, jitter)
    assert got == want
    caps = [0.01, 0.02, 0.04]
    if jitter:
        assert all(0.0 <= s <= c for s, c in zip(got, caps)) and got != caps
        assert got == _sleeps(resilience.retry, prandom.seed, monkeypatch, jitter)  # replays
        assert got != _sleeps(resilience.retry, prandom.seed, monkeypatch, jitter, seed=1)
    else:
        assert got == caps


def test_retry_flag_knob_and_deadline(monkeypatch):
    set_flags({"FLAGS_store_retry_jitter": False})
    assert _sleeps(resilience.retry, prandom.seed, monkeypatch, None) == [0.01, 0.02, 0.04]
    set_flags({"FLAGS_store_retry_jitter": True})
    assert _sleeps(resilience.retry, prandom.seed, monkeypatch, None) != [0.01, 0.02, 0.04]
    with pytest.raises(ValueError):
        resilience.retry(max_attempts=0)
    with pytest.raises(ValueError):
        resilience.retry(deadline_s=0)


# ----------------------------------------------------------- observability
def test_fleet_trace_id_rides_into_the_scheduler_and_spans(models):
    """The fleet's trace id is the scheduler request's, and the per-chunk
    prefill and decode spans name it; the run log holds the fleet's
    lifecycle and the scheduler's request events."""
    _, pm = models
    set_flags({"FLAGS_trace": True})
    runlog.monitor().clear()
    fleet = ServingFleet(pm, replicas=1, **KW)
    fid = fleet.submit(_prompts(1)[0], max_new_tokens=6, seed=2)
    freq = fleet.requests[fid]
    local = fleet._local_rid(fid)
    assert freq.trace_id and fleet.replicas[0].scheduler.find(local).trace_id == freq.trace_id
    fleet.run()
    spans = runlog.monitor().events("span")
    assert any(e["name"] == "serving.prefill_chunk" and e["trace"] == freq.trace_id for e in spans)
    assert any(e["name"] == "serving.decode" and freq.trace_id in e["traces"] for e in spans)
    kinds = [e["kind"] for e in runlog.monitor().events("fleet")]
    assert {"membership", "submitted", "placed", "finished"} <= set(kinds)
    statuses = [e["status"] for e in runlog.monitor().events("request") if e["trace"] == freq.trace_id]
    assert statuses == ["submitted", "admitted", "finished"]
    set_flags({"FLAGS_trace": False})
    assert fleet.requests[fleet.submit(_prompts(1)[0], max_new_tokens=2)].trace_id is None


def test_replica_death_dumps_a_flight_record(models, tmp_path):
    import json
    import os

    from paddle_tpu_torch.observability import flightrec

    _, pm = models
    set_flags({"FLAGS_run_log_dir": str(tmp_path)})
    flightrec.reset()
    fleet = ServingFleet(pm, replicas=2, **KW)
    fids = [fleet.submit(p, max_new_tokens=6, seed=i, replica=1) for i, p in enumerate(_prompts(2))]
    fleet.step()
    fleet.kill_replica(1, reason="test kill")
    recs = [f for f in os.listdir(tmp_path) if f.startswith("flightrec-")]
    assert len(recs) == 1
    doc = json.load(open(os.path.join(tmp_path, recs[0])))
    assert doc["reason"] == "replica_death" and doc["context"]["replica"] == 1
    assert doc["context"]["inflight"] == sorted(fids)
    assert doc["exception"]["message"] == "test kill"
    assert any(e["event"] == "fleet" for e in doc["events"])
    assert all(fleet.run()[f].status == "finished" for f in fids)


def test_scheduler_cancel_and_deadline_emit_request_events(models):
    _, pm = models
    eng = DecodeEngine(pm, **KW)
    s = ContinuousBatchingScheduler(eng)
    p = _prompts(2)
    r1 = s.submit(p[0], max_new_tokens=30)
    while not s.running:
        s.step()
    runlog.monitor().clear()
    assert s.cancel(r1) is True and s.cancel(r1) is False
    assert eng.free_slots() == [0, 1]
    assert any(e["status"] == "cancelled" and e["id"] == r1
               for e in runlog.monitor().events("request"))
    r2 = s.submit(p[1], max_new_tokens=4)
    done = s.run()
    assert r2 in done and r1 not in done

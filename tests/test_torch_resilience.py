"""The fault-tolerant training runtime of the port against ``paddle_tpu``'s,
on the CPU: the cases of ``tests/test_resilience.py`` for the
``CheckpointManager`` (:43-140), the watchdog (:319-343) and the elastic
supervisor (:344-453), proven under the same injected faults
(``testing/chaos.py``).

The checkpoint cases run on both packages' managers with the reference's
toy state and must agree on every restored step and value. The supervisor
runs on both packages over their own TCPStores (torch's store cannot talk
to the reference's native one) with the same fault schedule: the event
sequence ``(kind, step)`` and the final state are held equal.
"""
import json
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from paddle_tpu.distributed import resilience as jres  # noqa: E402
from paddle_tpu.distributed.elastic import ElasticNode as JElasticNode  # noqa: E402
from paddle_tpu.distributed.store import TCPStore as JTCPStore  # noqa: E402
from paddle_tpu.framework.flags import set_flags as jset_flags  # noqa: E402
from paddle_tpu.testing import chaos as jchaos  # noqa: E402
from paddle_tpu_torch.distributed import resilience as res  # noqa: E402
from paddle_tpu_torch.distributed.elastic import ElasticNode, parse_np_range  # noqa: E402
from paddle_tpu_torch.distributed.store import TCPStore  # noqa: E402
from paddle_tpu_torch.framework.flags import set_flags  # noqa: E402
from paddle_tpu_torch.testing import chaos  # noqa: E402

SIDES = {"port": (res, chaos, TCPStore, ElasticNode, set_flags),
         "ref": (jres, jchaos, JTCPStore, JElasticNode, jset_flags)}


def _state(step: float):
    return {"w": np.full((4,), step, np.float32),
            "b": np.array([step * 2.0], np.float32)}


def _values(state):
    return {k: np.asarray(v).tolist() for k, v in state.items()}


def _assert_state(state, step: float):
    np.testing.assert_allclose(np.asarray(state["w"]), np.full((4,), step))
    np.testing.assert_allclose(np.asarray(state["b"]), [step * 2.0])


# --------------------------------------------------------------------------
# CheckpointManager: integrity, fallback, rotation
# --------------------------------------------------------------------------


def _roundtrip(mod, ch, d):
    mgr = mod.CheckpointManager(d, keep_last_k=3)
    mgr.save(_state(1.0), 1)
    mgr.save(_state(2.0), 2)
    state, step = mgr.restore_latest(target=_state(0.0))
    assert isinstance(state["w"], np.ndarray)  # placed as the target holds it
    return step, _values(state)


def _empty(mod, ch, d):
    return mod.CheckpointManager(d).restore_latest(target=_state(0.0))


def _corrupt_latest(mod, ch, d):
    mgr = mod.CheckpointManager(d, keep_last_k=3)
    mgr.save(_state(1.0), 1)
    mgr.save(_state(2.0), 2)
    with ch.inject(FLAGS_chaos_corrupt_ckpt=True):
        mgr.save(_state(3.0), 3)  # published, then bytes flipped on disk
    state, step = mgr.restore_latest(target=_state(0.0))
    with pytest.raises(Exception):
        mgr._load_verified(3, _state(0.0), None)
    return step, _values(state)


def _kill_mid_save(mod, ch, d):
    mgr = mod.CheckpointManager(d, keep_last_k=3)
    mgr.save(_state(5.0), 5)
    with ch.inject(FLAGS_chaos_crash_point="checkpoint_save"):
        with pytest.raises(ch.ChaosCrash):
            mgr.save(_state(6.0), 6)
    steps = mgr.steps()
    state, step = mgr.restore_latest(target=_state(0.0))
    mod.CheckpointManager(d, keep_last_k=3).save(_state(6.0), 6)
    stale = [n for n in os.listdir(d) if n.startswith(".tmp-")]
    return steps, step, _values(state), stale


def _truncated_manifest(mod, ch, d):
    mgr = mod.CheckpointManager(d, keep_last_k=3)
    mgr.save(_state(1.0), 1)
    mgr.save(_state(2.0), 2)
    with open(os.path.join(mgr._step_dir(2), "manifest.json"), "w") as f:
        f.write('{"step": 2, "lea')  # torn write
    state, step = mgr.restore_latest(target=_state(0.0))
    return step, _values(state)


def _keep_last_k(mod, ch, d):
    mgr = mod.CheckpointManager(d, keep_last_k=2)
    for s in range(1, 6):
        mgr.save(_state(float(s)), s)
    return mgr.steps(), mgr.latest_step(), mgr.restore_latest(target=_state(0.0))[1]


def _checksum_names_leaf(mod, ch, d):
    mgr = mod.CheckpointManager(d, keep_last_k=3)
    mgr.save(_state(1.0), 1)
    mgr.save(_state(2.0), 2)
    mpath = os.path.join(mgr._step_dir(2), "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    key = sorted(manifest["leaves"])[0]
    manifest["leaves"][key]["crc32"] ^= 0xDEADBEEF
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(mod.CheckpointCorruption) as ei:
        mgr._load_verified(2, _state(0.0), None)
    assert "checksum mismatch" in str(ei.value) and key in str(ei.value)
    state, step = mgr.restore_latest(target=_state(0.0))
    return key, step, _values(state)


@pytest.mark.parametrize("case", [_roundtrip, _empty, _corrupt_latest, _kill_mid_save,
                                  _truncated_manifest, _keep_last_k, _checksum_names_leaf],
                         ids=lambda f: f.__name__.strip("_"))
def test_checkpoint_manager_matches_paddle_tpu(case, tmp_path):
    got = {side: case(mod, ch, str(tmp_path / side))
           for side, (mod, ch, *_rest) in SIDES.items()}
    assert got["port"] == got["ref"], got


def test_checkpoint_manifest_layout_and_timings(tmp_path):
    mgr = res.CheckpointManager(str(tmp_path), keep_last_k=2)
    mgr.save(_state(1.0), 1)
    d = mgr._step_dir(1)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 1 and set(manifest["leaves"]) == {"['w']", "['b']"}
    assert os.path.exists(os.path.join(d, "state", "state.pt"))
    assert set(mgr.last_save) == {"gather", "write", "crc", "bytes"}
    mgr.restore_latest(target=_state(0.0))
    assert set(mgr.last_restore) == {"read", "crc", "convert"}


# --------------------------------------------------------------------------
# Watchdog
# --------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["port", "ref"])
def test_watchdog_fires_on_hang_and_not_on_fast_block(side):
    mod = SIDES[side][0]
    fired = []
    with mod.watchdog("slow-collective", timeout=0.05,
                      on_timeout=lambda name, el: fired.append((name, el))):
        time.sleep(0.2)
    assert fired and fired[0][0] == "slow-collective"
    fired.clear()
    with mod.watchdog("fast-collective", timeout=5.0,
                      on_timeout=lambda name, el: fired.append(name)):
        pass
    time.sleep(0.1)
    assert fired == []


def test_watchdog_disarmed_by_default_flag(monkeypatch):
    import threading

    def no_timer(*a, **kw):
        raise AssertionError("a disarmed watchdog started a timer")

    monkeypatch.setattr(threading, "Timer", no_timer)
    with res.watchdog("anything"):  # FLAGS_collective_timeout_s defaults to 0: no timer
        pass


# --------------------------------------------------------------------------
# Elastic supervisor: HOLD -> checkpoint -> settle -> resume
# --------------------------------------------------------------------------


def _node_death(side, d):
    mod, ch, Store, Node, setf = SIDES[side]
    master = Store(is_master=True, timeout=10.0)
    # a node is stale after 1 s without a beat (20 missed beats: no flapping
    # on a loaded host); the zombie's wait outlasts that
    n0 = Node(master, heartbeat_interval=0.05, timeout=1.0)
    client = Store(port=master.port, timeout=5.0)
    n1 = Node(client, heartbeat_interval=0.05, timeout=1.0)
    events, worlds = [], []
    try:
        mgr = mod.CheckpointManager(d, keep_last_k=3)

        def train(state, step, members):
            worlds.append((step, len(members)))
            if step == 4 and len(members) == 2:
                setf({"FLAGS_chaos": True, "FLAGS_chaos_freeze_heartbeat": str(n1.node_id)})
                time.sleep(1.5)  # let the 1 s staleness window expire
            return {"w": np.asarray(state["w"]) + 1.0, "b": np.asarray(state["b"]) + 2.0}

        state, restarts = mod.run_resilient(
            train, node=n0, manager=mgr, init_state=_state(0.0), num_steps=8, min_nodes=1,
            max_nodes=2, checkpoint_every=2, max_restarts=3, backoff=0.01, settle=0.2,
            deadline=30.0, on_event=lambda kind, info: events.append((kind, info)))
        resume = [i for k, i in events if k == "resume"][0]
        return dict(events=[(k, i.get("step")) for k, i in events], state=_values(state),
                    restarts=restarts, resumed_members=resume["members"] == [n0.node_id],
                    worlds=sorted({w for _, w in worlds}), latest=mgr.latest_step())
    finally:
        setf({"FLAGS_chaos": False, "FLAGS_chaos_freeze_heartbeat": ""})
        n0.leave()
        n1.leave()
        client.close()
        master.close()


def _restart_bound(side, d):
    mod, ch, Store, Node, setf = SIDES[side]
    master = Store(is_master=True, timeout=10.0)
    node = Node(master, heartbeat_interval=0.05, timeout=1.0)
    attempts, events = [], []
    try:
        def train(state, step, members):
            attempts.append(step)
            raise mod.WorkerFault("persistent hardware fault")

        with pytest.raises(mod.WorkerFault):
            mod.run_resilient(train, node=node, manager=mod.CheckpointManager(d, keep_last_k=2),
                              init_state=_state(0.0), num_steps=4, min_nodes=1,
                              checkpoint_every=0, max_restarts=2, backoff=0.01, settle=0.1,
                              deadline=10.0, on_event=lambda k, i: events.append((k, i.get("step"))))
        return dict(attempts=attempts, events=events)
    finally:
        node.leave()
        master.close()


def _crash_at_step(side, d):
    mod, ch, Store, Node, setf = SIDES[side]
    master = Store(is_master=True, timeout=10.0)
    node = Node(master, heartbeat_interval=0.05, timeout=1.0)
    events = []
    try:
        with ch.inject(FLAGS_chaos_crash_point="train_step", FLAGS_chaos_crash_at_step=3):
            state, restarts = mod.run_resilient(
                lambda s, step, m: {"w": np.asarray(s["w"]) + 1.0, "b": np.asarray(s["b"]) + 2.0},
                node=node, manager=mod.CheckpointManager(d, keep_last_k=3),
                init_state=_state(0.0), num_steps=6, min_nodes=1, checkpoint_every=1,
                max_restarts=2, backoff=0.01, settle=0.1, deadline=10.0,
                on_event=lambda k, i: events.append((k, i.get("step"))))
        return dict(events=events, state=_values(state), restarts=restarts)
    finally:
        node.leave()
        master.close()


@pytest.mark.parametrize("case", [_node_death, _restart_bound, _crash_at_step],
                         ids=lambda f: f.__name__.strip("_"))
def test_supervisor_matches_paddle_tpu(case, tmp_path):
    got = {side: case(side, str(tmp_path / side)) for side in SIDES}
    assert got["port"] == got["ref"], got
    out = got["port"]
    if case is _node_death:
        assert out["restarts"] == 1 and out["resumed_members"]
        assert out["worlds"] == [1, 2] and out["latest"] == 8
        _assert_state({k: np.asarray(v) for k, v in out["state"].items()}, 8.0)
        kinds = [k for k, _ in out["events"]]
        assert kinds[0] == "start" and "hold" in kinds and "resume" in kinds
    elif case is _restart_bound:
        assert out["attempts"] == [0, 0, 0]
    else:
        assert out["restarts"] == 1
        _assert_state({k: np.asarray(v) for k, v in out["state"].items()}, 6.0)


def test_elastic_node_membership_and_parse_np_range():
    assert parse_np_range("2") == (2, 2) and parse_np_range("1:4") == (1, 4)
    master = TCPStore(is_master=True, timeout=10.0)
    n0 = ElasticNode(master, heartbeat_interval=0.1, timeout=1.0)
    client = TCPStore(port=master.port, timeout=10.0)
    n1 = ElasticNode(client, heartbeat_interval=0.1, timeout=1.0)
    try:
        assert n0.node_id != n1.node_id
        assert n0.wait_for(2, settle=0.3, deadline=10.0) == sorted([n0.node_id, n1.node_id])
        n1.leave()  # graceful: its ticket reads dead at once
        assert n0.alive_nodes() == [n0.node_id]
        n2 = ElasticNode(client, heartbeat_interval=0.1, timeout=1.0)
        assert n0.wait_for(2, settle=0.3, deadline=10.0) == sorted([n0.node_id, n2.node_id])
        n2.leave()
    finally:
        n0.leave()
        client.close()
        master.close()

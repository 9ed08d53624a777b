"""The training-health guard and the divergence monitor of the port against
``paddle_tpu``'s, on the CPU: the cases of ``tests/test_stability.py``'s
``TestGuardInGraph`` and ``TestHealthMonitor`` that need neither
``GradScaler``, the Executor, the DataLoader nor hapi.

Both sides train the reference's net (``Linear(8, 16)``, GELU,
``Linear(16, 4)`` from ``paddle.seed``; the port's ``Linear`` keeps the
``[in, out]`` layout, so the weights carry across by name) with Adam at lr
1e-2 on the same numpy batches, with the chaos NaN injector armed at the
same dispatch. Bad-step flags, skip counts, rollback steps and the
monitor's counters are held equal; losses and gradient norms within rtol
1e-5 (f32, sums in another order; measured up to 6.0e-7), NaN where the
reference's are NaN. The
port's own guarantees are bitwise: a skipped step leaves every parameter,
moment and the step count as they were, and a guarded run equals the same
run without the bad batch.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
from paddle_tpu.distributed.resilience import CheckpointManager as JCheckpointManager  # noqa: E402
from paddle_tpu.jit import MultiStepRunner as JMultiStepRunner  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.stability import HealthMonitor as JHealthMonitor  # noqa: E402
from paddle_tpu.testing import chaos as jchaos  # noqa: E402
from paddle_tpu_torch import observability  # noqa: E402
from paddle_tpu_torch.distributed.resilience import CheckpointManager, run_resilient  # noqa: E402
from paddle_tpu_torch.framework.flags import get_flags, set_flags  # noqa: E402
from paddle_tpu_torch.jit import MultiStepRunner, TrainStep  # noqa: E402
from paddle_tpu_torch.nn.layer import Linear  # noqa: E402
from paddle_tpu_torch.nn.layer.loss import CrossEntropyLoss  # noqa: E402
from paddle_tpu_torch.observability import metrics as obs_metrics  # noqa: E402
from paddle_tpu_torch.optimizer import Adam  # noqa: E402
from paddle_tpu_torch.stability import (DivergenceError, DivergenceFault,  # noqa: E402
                                         HealthMonitor)
from paddle_tpu_torch.testing import chaos  # noqa: E402

LOSS_RTOL = 1e-5


def _batches(n, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    return [(rng.normal(size=(4, 8)).astype("float32"),
             rng.integers(0, 4, 4).astype("int64")) for _ in range(n)]


def _reference(seed=1, guard=True, **inject):
    paddle.seed(seed)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.GELU(), jnn.Linear(16, 4))
    weights = {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}
    if inject:
        with jchaos.inject(**inject):
            step = JTrainStep(net, paddle.optimizer.Adam(learning_rate=1e-2),
                              jnn.CrossEntropyLoss(), guard=guard)
    else:
        step = JTrainStep(net, paddle.optimizer.Adam(learning_rate=1e-2),
                          jnn.CrossEntropyLoss(), guard=guard)
    return step, weights


def _port(weights, guard=True, **inject):
    net = torch.nn.Sequential(Linear(8, 16, device="cpu"), torch.nn.GELU(),
                              Linear(16, 4, device="cpu"))
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in weights.items()})

    def build():
        return TrainStep(net, Adam(learning_rate=1e-2, parameters=net.parameters()),
                         CrossEntropyLoss(), guard=guard)

    if inject:
        with chaos.inject(**inject):
            return build()
    return build()


def _pair(seed=1, guard=True, **inject):
    jstep, weights = _reference(seed, guard, **inject)
    return jstep, _port(weights, guard, **inject)


def _jrun(jstep, batches):
    return [jstep(paddle.to_tensor(x), paddle.to_tensor(y)) for x, y in batches]


def _val(x):
    return np.asarray(getattr(x, "_value", x))


def _losses_match(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert (np.isnan(port) == np.isnan(ref)).all(), (port, ref)
    np.testing.assert_allclose(port[~np.isnan(port)], ref[~np.isnan(ref)], rtol=LOSS_RTOL)


def _states_equal(a, b):
    for key in ("params", "buffers"):
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), n
    for k in a["opt"]:
        for n in a["opt"][k]:
            assert torch.equal(a["opt"][k][n], b["opt"][k][n]), (k, n)
    assert a["step"] == b["step"]


class TestGuard:
    def test_health_leaf_and_clean_run(self):
        batches = _batches(4)
        jstep, weights = _reference(guard=True)
        jm = _jrun(jstep, batches)
        plain, guarded = _port(weights, guard=False), _port(weights, guard=True)
        for x, y in batches:
            plain(x, y)
        m = [guarded(x, y) for x, y in batches]
        h = m[-1]["health"]
        assert not bool(h["bad_step"]) and np.isfinite(float(h["grad_norm"]))
        assert int(h["skipped"]) == 0 and guarded.state["skipped"] == 0
        _states_equal(plain.state, guarded.state)  # the guard changes no bit of a clean run
        _losses_match([float(r["loss"]) for r in m], [float(_val(r["loss"]._value)) for r in jm])
        np.testing.assert_allclose(float(h["grad_norm"]), float(_val(jm[-1]["health"]["grad_norm"]._value)),
                                   rtol=LOSS_RTOL)

    def test_bad_step_freezes_state_bitwise(self):
        batches = _batches(6)
        jstep, g = _pair(FLAGS_chaos_nan_at_step=2)
        jm = _jrun(jstep, batches[:3])
        for x, y in batches[:2]:
            g(x, y)
        before = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) and k != "opt"
                  else v for k, v in g.state.items()}
        opt_before = {k: {n: t.clone() for n, t in v.items()} for k, v in g.state["opt"].items()}
        m = g(*batches[2])
        assert bool(m["health"]["bad_step"]) == bool(_val(jm[2]["health"]["bad_step"]._value))
        assert bool(m["health"]["bad_step"])
        st = g.state
        for n, t in before["params"].items():
            assert torch.equal(t, st["params"][n]), n
        for k, tree in opt_before.items():
            for n, t in tree.items():
                assert torch.equal(t, st["opt"][k][n]), (k, n)
        assert st["step"] == 2 == int(np.asarray(jstep.state["step"]))  # frozen
        assert st["skipped"] == 1 == int(np.asarray(jstep.state["skipped"]))

    @pytest.mark.parametrize("dispatch", ["call", "run_steps"])
    def test_guarded_run_bitwise_equals_clean_run_without_bad_batch(self, dispatch):
        batches = _batches(6)
        jstep, g = _pair(FLAGS_chaos_nan_at_step=2)
        c = _port({k: v.numpy() for k, v in g.state["params"].items()})
        if dispatch == "call":
            losses = [float(g(x, y)["loss"]) for x, y in batches]
            jlosses = [float(_val(r["loss"]._value)) for r in _jrun(jstep, batches)]
        else:
            obs_metrics.reset_counters("train_step.")
            m = g.run_steps(batches)
            assert obs_metrics.counters("train_step.") == {"train_step.dispatches": 1,
                                                           "train_step.steps": 6}
            jm = jstep.run_steps([(paddle.to_tensor(x), paddle.to_tensor(y)) for x, y in batches])
            bad = m["health"]["bad_step"].numpy().astype(int)
            assert list(bad) == [0, 0, 1, 0, 0, 0]
            assert list(bad) == list(_val(jm["health"]["bad_step"]._value).astype(int))
            skipped = m["health"]["skipped"].numpy().astype(int)
            assert list(skipped) == [0, 0, 1, 1, 1, 1]
            assert list(skipped) == list(_val(jm["health"]["skipped"]._value).astype(int))
            losses, jlosses = m["loss"].tolist(), list(_val(jm["loss"]._value))
        _losses_match(losses, jlosses)
        for i, (x, y) in enumerate(batches):
            if i != 2:
                c(x, y)
        _states_equal(g.state, c.state)
        assert g.state["skipped"] == 1 and g.chaos_nan_armed == 0  # fired once

    def test_chaos_fires_once_under_call_and_run_steps(self):
        jstep, g = _pair(FLAGS_chaos_nan_at_step=1)
        batches = _batches(4)
        m = g.run_steps(batches)
        bad = list(m["health"]["bad_step"].numpy().astype(int))
        jm = jstep.run_steps([(paddle.to_tensor(x), paddle.to_tensor(y)) for x, y in batches])
        assert bad == [0, 1, 0, 0] == list(_val(jm["health"]["bad_step"]._value).astype(int))
        assert g.chaos_nan_armed == 0
        assert not g.run_steps(batches)["health"]["bad_step"].any()

    def test_flag_enables_guard(self):
        prev = get_flags(["FLAGS_train_guard"])
        set_flags({"FLAGS_train_guard": True})
        try:
            step = _port(_reference()[1], guard=None)
        finally:
            set_flags(prev)
        assert step.guard and "skipped" in step.state
        assert "health" in step(*_batches(1)[0])

    def test_unguarded_chaos_poisons_params(self):
        jstep, u = _pair(guard=False, FLAGS_chaos_nan_at_step=0)
        u(*_batches(1)[0])
        assert any(torch.isnan(p).any() for p in u.state["params"].values())
        assert "skipped" not in u.state and "health" not in u(*_batches(1)[0])


class TestHealthMonitor:
    def _k_bad(self, tmp_path, side):
        """The reference's acceptance pin on either side: unguarded NaN at
        step 4 poisons the params, K = 3 bad steps roll back to the newest
        checkpoint (every 2 steps) and training runs to the end."""
        if side == "ref":
            ts, _ = _reference(seed=3, guard=False, FLAGS_chaos_nan_at_step=4)
            mgr = JCheckpointManager(str(tmp_path / "ref"), keep_last_k=3)
            mon = JHealthMonitor(manager=mgr, train_step=ts, k_bad_steps=3, checkpoint_every=2,
                                 max_rollbacks=2)
            call = lambda x, y: ts(paddle.to_tensor(x), paddle.to_tensor(y))  # noqa: E731
            loss_of = lambda m: float(_val(m["loss"]._value))  # noqa: E731
        else:
            ts = _port(_reference(seed=3)[1], guard=False, FLAGS_chaos_nan_at_step=4)
            mgr = CheckpointManager(str(tmp_path / "port"), keep_last_k=3)
            mon = HealthMonitor(manager=mgr, train_step=ts, k_bad_steps=3, checkpoint_every=2,
                                max_rollbacks=2)
            call, loss_of = ts, lambda m: float(m["loss"])
        rolled, losses = [], []
        for x, y in _batches(12):
            m = call(x, y)
            losses.append(loss_of(m))
            info = mon.observe(m)
            if info:
                rolled.append((info["reason"], info["restored_step"], info["at_step"]))
        return rolled, losses, ts

    def test_k_consecutive_bad_steps_roll_back_and_resume(self, tmp_path):
        obs_metrics.reset_counters("stability.")
        rolled, losses, ts = self._k_bad(tmp_path, "port")
        jrolled, jlosses, _ = self._k_bad(tmp_path, "ref")
        assert rolled == jrolled and len(rolled) == 1
        assert rolled[0][0].endswith("consecutive bad steps") and rolled[0][1] == 4
        _losses_match(losses, jlosses)
        assert np.isfinite(losses[-1])
        assert all(torch.isfinite(p).all() for p in ts.state["params"].values())
        assert obs_metrics.counters("stability.")["stability.rollbacks"] == 1
        assert observability.monitor().events("rollback")

    def test_guarded_bad_steps_counted_from_health_leaf(self):
        jts, ts = _pair(FLAGS_chaos_nan_at_step=1, FLAGS_chaos_nan_steps=2)
        obs_metrics.reset_counters("train_step.skipped")
        HealthMonitor(k_bad_steps=5).observe(ts.run_steps(_batches(6)))
        assert obs_metrics.counters("train_step.skipped")["train_step.skipped"] == 2
        jts.run_steps([(paddle.to_tensor(x), paddle.to_tensor(y)) for x, y in _batches(6)])
        assert ts.state["skipped"] == 2 == int(np.asarray(jts.state["skipped"]))

    def test_spike_detection_with_quarantined_ema(self):
        mon = HealthMonitor(k_bad_steps=100, spike_factor=3.0, spike_patience=3, ema_alpha=0.5,
                            raise_on_divergence=True)
        for _ in range(5):
            mon.observe_loss(1.0)
        mon.observe_loss(10.0)
        mon.observe_loss(10.0)
        assert mon.ema == pytest.approx(1.0)  # quarantined
        with pytest.raises(DivergenceFault):
            mon.observe_loss(10.0)
        assert observability.monitor().events("loss_spike")

    def test_divergence_without_manager_raises(self):
        mon = HealthMonitor(k_bad_steps=2)
        mon.observe_loss(float("nan"))
        with pytest.raises(DivergenceError, match="no CheckpointManager"):
            mon.observe_loss(float("nan"))

    def test_check_every_buffers_without_sync(self):
        mon = HealthMonitor(k_bad_steps=1, check_every=3, raise_on_divergence=True)
        assert mon.observe({"loss": float("nan")}) is None
        assert mon.observe({"loss": torch.tensor(float("nan"))}) is None
        assert mon.step == 0  # nothing materialized yet
        with pytest.raises(DivergenceFault):
            mon.observe({"loss": float("nan")})

    def test_rollback_budget_exhaustion(self, tmp_path):
        ts = _port(_reference(seed=5)[1], guard=False)
        mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_k=2)
        mgr.save(ts, 0)
        mon = HealthMonitor(manager=mgr, train_step=ts, k_bad_steps=1, max_rollbacks=1)
        assert mon.observe_loss(float("nan"))["rollbacks"] == 1
        with pytest.raises(DivergenceError, match="budget"):
            mon.observe_loss(float("nan"))

    def test_lr_backoff_applies_to_the_next_step(self, tmp_path):
        ts = _port(_reference(seed=6)[1])
        mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_k=2)
        mgr.save(ts, 0)
        mon = HealthMonitor(manager=mgr, train_step=ts, k_bad_steps=1, lr_backoff=0.5)
        seeds = []
        mon.reshuffle = seeds.append
        info = mon.observe_loss(float("nan"))
        assert info["restored_step"] == 0
        assert ts.optimizer.get_lr() == pytest.approx(5e-3)  # 1e-2 * 0.5
        assert seeds == [1]
        assert float(ts(*_batches(1)[0])["lr"]) == pytest.approx(5e-3)

    def test_multi_step_runner_monitor_wiring(self, tmp_path):
        results = {}
        for side in ("port", "ref"):
            if side == "ref":
                ts, _ = _reference(seed=3, guard=False, FLAGS_chaos_nan_at_step=4)
                mon = JHealthMonitor(manager=JCheckpointManager(str(tmp_path / side), keep_last_k=3),
                                     k_bad_steps=3, checkpoint_every=2, max_rollbacks=2)
                runner = JMultiStepRunner(ts, 2, monitor=mon)
                outs = list(runner.run(iter([(paddle.to_tensor(x), paddle.to_tensor(y))
                                             for x, y in _batches(12)])))
                losses = np.concatenate([_val(o["loss"]._value) for o in outs])
            else:
                ts = _port(_reference(seed=3)[1], guard=False, FLAGS_chaos_nan_at_step=4)
                mon = HealthMonitor(manager=CheckpointManager(str(tmp_path / side), keep_last_k=3),
                                    k_bad_steps=3, checkpoint_every=2, max_rollbacks=2)
                runner = MultiStepRunner(ts, 2, monitor=mon)
                assert mon.train_step is ts  # attached by the runner
                outs = list(runner.run(iter(_batches(12))))
                losses = np.concatenate([o["loss"].numpy() for o in outs])
                assert all(torch.isfinite(p).all() for p in ts.state["params"].values())
            assert len(outs) == 6 and mon.rollbacks == 1
            results[side] = losses
        _losses_match(results["port"], results["ref"])

    def test_run_resilient_divergence_fault_skips_hold_save(self, tmp_path):
        class _Node:
            def alive_nodes(self):
                return [0]

            def wait_for(self, *a, **kw):
                return [0]

        mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_k=5)
        mon = HealthMonitor(k_bad_steps=1, raise_on_divergence=True)
        saves = []
        orig_save = mgr.save

        def spy_save(state, step):
            saves.append((step, float(np.asarray(state["w"])[0])))
            return orig_save(state, step)

        mgr.save = spy_save
        fired = []

        def step_fn(state, step, members):
            w = np.asarray(state["w"]) + 1.0
            if step == 3 and not fired:
                fired.append(step)
                w = w * np.nan
            mon.observe_loss(float(w[0]))
            return {"w": w}

        state, restarts = run_resilient(
            step_fn, node=_Node(), manager=mgr, init_state={"w": np.zeros((1,), np.float32)},
            num_steps=6, checkpoint_every=1, backoff=0.0, settle=0.0)
        assert restarts == 1
        assert np.isfinite(np.asarray(state["w"])).all() and float(state["w"][0]) == 6.0
        assert all(np.isfinite(v) for _, v in saves)  # never saved NaN

    def test_rollback_preserves_drained_chaos_budget(self, tmp_path):
        ts = _port(_reference(seed=3)[1], guard=False, FLAGS_chaos_nan_at_step=3)
        mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_k=5)
        mgr.save(ts, 0)
        for x, y in _batches(5):
            ts(x, y)  # fires at step 3 and drains
        assert ts.chaos_nan_armed == 0
        HealthMonitor(manager=mgr, train_step=ts, k_bad_steps=1).observe_loss(float("nan"))
        assert ts.chaos_nan_armed == 0  # stays drained
        assert ts.state["step"] == 0  # rewound


def test_guard_over_a_mesh_skips_on_every_rank_together():
    """Two gloo ranks at sdp 2 with ZeRO-2: the NaN at dispatch 1 is
    skipped on both (the flag reduced over the world), both hold the same
    whole state after, and their losses are within rtol 2e-6 of one
    process's guarded run on the whole batch (f32, the two halves'
    gradients averaged; measured up to 1.7e-7)."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing.dist import run_ranks
    import torch_dist_ranks as ranks

    ids = np.random.default_rng(31).integers(0, 512, (8, 16)).astype(np.int64)
    outs = run_ranks(ranks.guarded_mesh_steps, 2, ids, 1, 4)
    for o in outs:
        assert o["bad"] == [False, True, False, False] and o["skipped"] == [0, 1, 1, 1]
        assert o["step"] == 3
    for n, v in outs[0]["params"].items():
        np.testing.assert_array_equal(v, outs[1]["params"][n], err_msg=n)
    model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=3)
    with chaos.inject(FLAGS_chaos_nan_at_step=1):
        one = TrainStep(model, AdamW(learning_rate=1e-3, parameters=model.parameters()),
                        GPTPretrainingCriterion(), guard=True)
    m = one.run_steps([(ids, ids)] * 4)
    assert m["health"]["bad_step"].tolist() == outs[0]["bad"]
    np.testing.assert_allclose(outs[0]["losses"], m["loss"].numpy(), rtol=2e-6)


def test_state_savable_is_a_copy():
    from paddle_tpu_torch.stability import state_from_savable, state_to_savable

    st = {"params": {}, "step": 1}
    assert state_to_savable(st) == st and state_to_savable(st) is not st
    assert state_from_savable(st) == st

"""The LR schedulers of the port (``optimizer/lr.py``) against
``paddle_tpu``'s, on the CPU: 30 eager ``step()``s and ``lr_at(s)`` for
each, ``ReduceOnPlateau`` over a metric sequence, ``state_dict`` round
trips, and a schedule read by ``TrainStep``.

Tolerance: rtol 1e-6 against the reference, which evaluates ``lr_at`` in
f32 (the port in float64), and atol 7.5e-9, one f32 ulp of the 0.1 base
rates: the reference's f32 intermediates round at the base rate's scale,
so a rate far below it carries that absolute error (measured: 1.1e-9 at
0.0006 near the end of ``OneCycleLR``'s cosine, 2.0e-9 at 0.0018 where
``ExponentialDecay`` raises f32 0.9 to the 38th power).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.optimizer import lr as tlr

RTOL = dict(rtol=1e-6, atol=7.5e-9)

# name -> a factory over the module (the same arguments on both sides)
SCHEDULERS = {
    "NoamDecay": lambda L: L.NoamDecay(d_model=64, warmup_steps=10, learning_rate=2.0),
    "PiecewiseDecay": lambda L: L.PiecewiseDecay([5, 12, 20], [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda L: L.NaturalExpDecay(0.1, gamma=0.05),
    "InverseTimeDecay": lambda L: L.InverseTimeDecay(0.1, gamma=0.2),
    "PolynomialDecay": lambda L: L.PolynomialDecay(0.1, decay_steps=20, end_lr=0.001, power=2.0),
    "PolynomialDecayCycle": lambda L: L.PolynomialDecay(0.1, decay_steps=8, end_lr=0.001,
                                                         power=1.5, cycle=True),
    "LinearWarmup": lambda L: L.LinearWarmup(0.1, warmup_steps=5, start_lr=0.0, end_lr=0.1),
    "LinearWarmupCosine": lambda L: L.LinearWarmup(L.CosineAnnealingDecay(0.1, T_max=20),
                                                   warmup_steps=5, start_lr=0.0, end_lr=0.1),
    "ExponentialDecay": lambda L: L.ExponentialDecay(0.1, gamma=0.9),
    "MultiStepDecay": lambda L: L.MultiStepDecay(0.1, milestones=[4, 9, 17], gamma=0.5),
    "StepDecay": lambda L: L.StepDecay(0.1, step_size=7, gamma=0.3),
    "LambdaDecay": lambda L: L.LambdaDecay(0.1, lr_lambda=lambda e: 0.95 ** e),
    "CosineAnnealingDecay": lambda L: L.CosineAnnealingDecay(0.1, T_max=15, eta_min=0.001),
    "OneCycleLR": lambda L: L.OneCycleLR(0.2, total_steps=30, end_learning_rate=0.0005),
    "MultiplicativeDecay": lambda L: L.MultiplicativeDecay(0.1, lr_lambda=lambda e: 0.9 + 0.001 * e),
    "CyclicLR": lambda L: L.CyclicLR(0.01, 0.1, step_size_up=4, step_size_down=6),
    "CyclicLRTriangular2": lambda L: L.CyclicLR(0.01, 0.1, step_size_up=5, mode="triangular2"),
    "CyclicLRExpRange": lambda L: L.CyclicLR(0.01, 0.1, step_size_up=3, mode="exp_range",
                                             exp_gamma=0.97),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_reference(name):
    js, ts = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    np.testing.assert_allclose(ts(), js(), **RTOL)
    for _ in range(30):
        js.step()
        ts.step()
        np.testing.assert_allclose(ts(), js(), **RTOL)
        assert isinstance(ts(), float) and ts.last_epoch == js.last_epoch
    for s in range(40):
        got = ts.lr_at(s)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(js.lr_at(jnp.asarray(s))), **RTOL, err_msg=str(s))


def _plateau_metrics():
    rng = np.random.default_rng(0)
    falling = list(np.linspace(1.0, 0.5, 6))
    return falling + [0.5 + 1e-5 * k for k in range(12)] + list(0.49 - 0.01 * rng.random(8))


@pytest.mark.parametrize("kw", [dict(mode="min", patience=2, cooldown=1),
                                dict(mode="min", patience=0, factor=0.5, min_lr=0.01),
                                dict(mode="max", patience=3, threshold=0.05)])
def test_reduce_on_plateau_matches_reference(kw):
    js = jlr.ReduceOnPlateau(0.1, **kw)
    ts = tlr.ReduceOnPlateau(0.1, **kw)
    ts.step()  # no metric: nothing moves
    lrs = []
    for m in _plateau_metrics():
        js.step(m)
        ts.step(torch.tensor(m) if len(lrs) % 2 else m)
        assert ts() == js() and ts.num_bad == js.num_bad and ts.best == pytest.approx(js.best)
        lrs.append(ts())
        assert ts.lr_at(len(lrs)) == ts()
    assert lrs[-1] < 0.1  # the plateau cut the rate


@pytest.mark.parametrize("name", ["StepDecay", "OneCycleLR", "MultiplicativeDecay", "CyclicLR",
                                  "LinearWarmupCosine"])
def test_state_dict_round_trip(name):
    """A scheduler's state moves to a fresh one, which then goes on as the
    first does; the state is the reference's."""
    js, ts = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    for _ in range(11):
        js.step()
        ts.step()
    state = ts.state_dict()
    assert state.keys() == js.state_dict().keys() and state["last_epoch"] == 11
    fresh = SCHEDULERS[name](tlr)
    fresh.set_state_dict(state)
    assert fresh() == ts()
    for _ in range(5):
        fresh.step()
        ts.step()
        assert fresh() == ts()


def test_train_step_reads_lr_at():
    """``TrainStep`` takes each step's rate from the schedule's
    ``lr_at(step)``, the step count of the optimizer."""
    lin = torch.nn.Linear(3, 2)
    sched = tlr.StepDecay(0.1, step_size=2, gamma=0.5)
    step = TrainStep(lin, SGD(learning_rate=sched, parameters=lin.parameters()),
                     lambda out, y: ((out - y) ** 2).mean())
    x, y = torch.ones(4, 3), torch.zeros(4, 2)
    out = step.run_steps([((x,), (y,))] * 5)
    np.testing.assert_allclose(out["lr"].numpy(), [0.1, 0.1, 0.05, 0.05, 0.025], rtol=1e-6)

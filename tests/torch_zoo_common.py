"""The shared driver of the vision zoo's parity tests
(``tests/test_torch_vision_zoo_*.py``): one model of a family through both
packages from one state, on one batch.

The port draws the weights (its own initialisers; the batch norms' running
means Normal(0, 0.1) and variances U(0.5, 1.5), so the eval forward reads
non-trivial buffers) and the reference takes them by name; the reference
model is built with constant initialisers, which its eager per-shape
dispatch makes far faster than its random ones. Each side then runs its
eval forward (the reference's compiled ``jit.EvalStep``) and one f32
``TrainStep`` over Momentum (lr 0.1) with ``CrossEntropyLoss`` and
``return_outputs`` (the reference's compiled step: its eager tape takes
minutes a model here), dropout at p 0 on both sides. The gradients are
read from the step, ``(before - after) / lr`` (Momentum's first step moves
by ``lr * g``)."""
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.jit import EvalStep
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nn import initializer as jI

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn.layer import CrossEntropyLoss
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.utils.convert import state_dict_by_name

LR = 0.1


def _no_dropout(layers):
    for m in layers:
        if type(m).__name__ == "Dropout":
            m.p = 0.0


def state_of(pm, seed):
    """``pm``'s state as numpy, its running statistics drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    state = {}
    for n, t in pm.state_dict().items():
        v = t.detach().numpy().copy()
        if n.endswith("._mean"):
            v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif n.endswith("._variance"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        state[n] = v
    return state


def run_reference(make, state, x, y):
    """The reference model from ``make()`` with ``state``: eval logits, the
    step's loss, train-mode logits and its parameters and buffers after."""
    jI.set_global_initializer(jI.Constant(0.0), jI.Constant(0.0))
    try:
        jm = make()
    finally:
        jI.set_global_initializer(None, None)
    jm.set_state_dict(state)
    jm.eval()
    logits = np.asarray(EvalStep(jm)(paddle.to_tensor(x)).numpy())
    jm.train()
    _no_dropout(jm.sublayers())
    step = JTrainStep(jm, paddle.optimizer.Momentum(learning_rate=LR, parameters=jm.parameters()),
                      jnn.CrossEntropyLoss(), return_outputs=True)
    out = step(paddle.to_tensor(x), paddle.to_tensor(y))
    params = {n: np.asarray(v) for n, v in step.state["params"].items()}
    buffers = {n: np.asarray(v) for n, v in step.state["buffers"].items()}
    return dict(eval=logits, loss=float(out["loss"].numpy()),
                train=np.asarray(out["outputs"].numpy()), params=params, buffers=buffers)


def run_port(pm, state, x, y):
    """The same of the port's model ``pm``."""
    pm.load_state_dict(state_dict_by_name(state, pm))
    pm.eval()
    with torch.no_grad():
        logits = pm(torch.from_numpy(x)).numpy()
    pm.train()
    _no_dropout(pm.modules())
    step = TrainStep(pm, Momentum(learning_rate=LR, parameters=pm.parameters()),
                     CrossEntropyLoss(), return_outputs=True)
    out = step(x, y)
    params = {n: p.detach().numpy().copy() for n, p in pm.named_parameters()}
    buffers = {n: b.numpy().copy() for n, b in pm.named_buffers()}
    return dict(eval=logits, loss=float(out["loss"]), train=out["outputs"].detach().numpy(),
                params=params, buffers=buffers)


def both(make_ref, make_port, shape, seed):
    """``(port, reference, state)`` for one family's model on a batch of
    ``shape`` with 10-class labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, 10, (shape[0],)).astype(np.int64)
    pm = make_port()
    state = state_of(pm, seed + 1)
    return run_port(pm, state, x, y), run_reference(make_ref, state, x, y), state


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check(port, ref, state, tol):
    """Hold ``port`` to ``ref`` at ``tol``: ``logits`` (relative L2 of the
    eval and the train-mode logits), ``loss`` (relative), ``grad`` (the
    relative L2 of the gradients of every parameter joined), ``buffers``
    (atol of the running statistics after the step)."""
    assert set(port["params"]) == set(ref["params"])
    assert set(port["buffers"]) == set(ref["buffers"])
    assert rel_l2(port["eval"], ref["eval"]) <= tol["logits"]
    assert rel_l2(port["train"], ref["train"]) <= tol["logits"]
    assert abs(port["loss"] - ref["loss"]) <= tol["loss"] * abs(ref["loss"])
    grads = {n: ((state[n] - port["params"][n]) / LR, (state[n] - ref["params"][n]) / LR)
             for n in ref["params"]}
    joined = [np.concatenate([g[i].ravel() for g in grads.values()]) for i in (0, 1)]
    assert rel_l2(*joined) <= tol["grad"], rel_l2(*joined)
    for n, v in ref["buffers"].items():
        np.testing.assert_allclose(port["buffers"][n], v, atol=tol["buffers"], rtol=0, err_msg=n)

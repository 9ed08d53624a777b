"""The optimizer layer of the port (``optimizer/functional.py``,
``optimizer/optimizer.py``, ``nn/clip.py``, ``regularizer.py``,
``framework/selected_rows.py``) against ``paddle_tpu``'s, on the CPU.

The cores take the same numpy trees on both sides for 1 and 3 updates.
The optimizers' two orders are each held to the reference's: the eager
``step()`` (clip, then the L1/L2 penalty) and the ``TrainStep`` update
(penalty, then clip), with a clip set so that the order shows.

Tolerances, f32: the cores rtol 1e-6 (one formula on both sides), Lamb's
1e-5 (its two norms sum in another order); whole steps through a model
atol 1e-6 / rtol 1e-5 (the forward's sums in another order), and through
the reference's compiled step atol 2e-6 / rtol 2e-5 (see ``STEPS``). The
cores' atol 1e-8 is one f32 ulp of their 0.1-sized entries: ``torch``'s
``_foreach_add_(m, g, alpha)`` may fuse a multiply-add that JAX rounds
twice, which shows only where a sum cancels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.framework.selected_rows import SelectedRows as JSelectedRows
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import functional as jFopt
from paddle_tpu.tensor._helpers import ensure_tensor, op

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.framework.selected_rows import SelectedRows
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn.layer import Embedding, Linear
from paddle_tpu_torch.optimizer import functional as Fopt
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.utils.convert import state_dict_by_name

CORE = dict(rtol=1e-6, atol=1e-8)
LAMB = dict(rtol=1e-5, atol=1e-8)
VALUE = dict(atol=1e-6, rtol=1e-5)
# the reference's compiled step rounds its fused sums in its own order, and
# Adam divides each gradient by its own root mean square, so a rounding of a
# small gradient element shows in the update at the rate's scale: the
# reference's own tolerance for one step against another order of its sums
# (dp4 against dp1, tests/test_recsys.py)
STEPS = dict(atol=2e-6, rtol=2e-5)

# name -> (reference core, port core); RowSparseAdam names its table "emb"
_CORES = {
    "SGD": lambda F: F.SGDCore(),
    "Momentum": lambda F: F.MomentumCore(0.9),
    "Nesterov": lambda F: F.MomentumCore(0.9, use_nesterov=True),
    "Adam": lambda F: F.AdamCore(0.9, 0.99, 1e-8),
    "RowSparseAdam": lambda F: F.RowSparseAdamCore(0.9, 0.99, 1e-8, sparse=["emb"]),
    "Lamb": lambda F: F.LambCore(0.9, 0.99, 1e-6, 0.01),
    "Adagrad": lambda F: F.AdagradCore(1e-6, 0.1),
    "RMSProp": lambda F: F.RMSPropCore(0.9, 1e-6, 0.5),
    "RMSPropCentered": lambda F: F.RMSPropCore(0.9, 1e-6, 0.5, centered=True),
    "Adadelta": lambda F: F.AdadeltaCore(0.9, 1e-6),
    "Adamax": lambda F: F.AdamaxCore(0.9, 0.99, 1e-8),
}
_KEYS = ("emb", "w", "b")


def _tree(rng, step):
    """Parameters (a table, a matrix, a bias) or one step's gradients: the
    table's rows 1 and 4 get an all-zero gradient every step."""
    shapes = {"emb": (6, 3), "w": (4, 5), "b": (5,)}
    out = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    if step is not None:
        out["emb"][[1, 4]] = 0.0
    return out


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", sorted(_CORES))
def test_core_matches_reference(name, steps):
    rng = np.random.default_rng(0)
    params = _tree(rng, None)
    grads = [_tree(rng, s) for s in range(steps)]
    jcore, tcore = _CORES[name](jFopt), _CORES[name](Fopt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jcore.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in _KEYS]
    ts = tcore.init(tp)
    kw = {"keys": list(_KEYS)} if name == "RowSparseAdam" else {}
    for s, g in enumerate(grads):
        jp, js = jcore.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, 0.05, s)
        tcore.update([torch.from_numpy(g[k]) for k in _KEYS], ts, tp, 0.05, s, **kw)
    tol = LAMB if name == "Lamb" else CORE
    for i, k in enumerate(_KEYS):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]), **tol, err_msg=k)
        for key in js:
            np.testing.assert_allclose(ts[key][i].numpy(), np.asarray(js[key][k]), **tol,
                                       err_msg=f"{key}.{k}")
    assert all(v.dtype == torch.float32 for vs in ts.values() for v in vs)
    if name == "RowSparseAdam":  # the zero-gradient rows: bitwise untouched
        np.testing.assert_array_equal(tp[0].numpy()[[1, 4]], params["emb"][[1, 4]])
        np.testing.assert_array_equal(ts["m"][0].numpy()[[1, 4]], 0.0)


def test_row_sparse_core_without_keys_is_dense_adam():
    """The eager path passes no names: every parameter takes the dense
    Adam step, as the reference's index-keyed eager state never matches."""
    rng = np.random.default_rng(1)
    params, g0, g1 = _tree(rng, None), _tree(rng, None), _tree(rng, 1)
    outs = []
    for core in (Fopt.RowSparseAdamCore(sparse=["emb"]), Fopt.AdamCore()):
        tp = [torch.from_numpy(params[k].copy()) for k in _KEYS]
        state = core.init(tp)
        core.update([torch.from_numpy(g0[k]) for k in _KEYS], state, tp, 0.05, 0)
        row1 = tp[0][1].clone()
        core.update([torch.from_numpy(g1[k]) for k in _KEYS], state, tp, 0.05, 1)
        outs.append(tp[0].numpy())
        assert not torch.equal(tp[0][1], row1)  # a zero-gradient row moved
    np.testing.assert_array_equal(outs[0], outs[1])


# ------------------------------------------------------ decay and clip orders
class _MSE:
    def __call__(self, out, y):
        return op(lambda o, v: jnp.mean((o - v) ** 2), ensure_tensor(out), ensure_tensor(y),
                  _name="mse")


def _mse(out, y):
    return ((out - y) ** 2).mean()


_DECAYS = {"float": (lambda R: 0.05), "L2": (lambda R: R.L2Decay(0.05)),
           "L1": (lambda R: R.L1Decay(0.05))}
_OPTS = {"SGD": lambda O, **kw: O.SGD(learning_rate=0.1, **kw),
         "Momentum": lambda O, **kw: O.Momentum(learning_rate=0.1, momentum=0.9, **kw),
         "Adam": lambda O, **kw: O.Adam(learning_rate=0.1, **kw)}


def _linear_pair():
    paddle.seed(0)
    jm = jnn.Linear(6, 4)
    pm = Linear(6, 4, device="cpu")
    pm.load_state_dict(state_dict_by_name({k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()},
                                          pm))
    return jm, pm


@pytest.mark.parametrize("path", ["eager", "train_step"])
@pytest.mark.parametrize("decay", sorted(_DECAYS))
@pytest.mark.parametrize("name", sorted(_OPTS))
def test_decay_and_clip_order_match_reference(name, decay, path):
    """Three steps with a weight decay and a global-norm clip tight enough
    to bind: the eager ``step()`` clips the raw gradients and then adds the
    penalty; the ``TrainStep`` adds the penalty and then clips. Each is held
    to the reference's path of the same name, and the two orders differ."""
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(8, 6)).astype(np.float32) for _ in range(3)]
    ys = [rng.normal(size=(8, 4)).astype(np.float32) for _ in range(3)]
    finals = {}
    for order in ("eager", "train_step"):
        if order != path and name != "SGD":
            continue
        jm, pm = _linear_pair()
        jo = _OPTS[name](jopt, parameters=jm.parameters(), weight_decay=_DECAYS[decay](jreg),
                         grad_clip=jclip.ClipGradByGlobalNorm(0.05))
        to = _OPTS[name](topt, parameters=pm.parameters(), weight_decay=_DECAYS[decay](treg),
                         grad_clip=tclip.ClipGradByGlobalNorm(0.05))
        if order == "train_step":
            jstep, tstep = JTrainStep(jm, jo, _MSE(), seed=0), TrainStep(pm, to, _mse)
            for x, y in zip(xs, ys):
                jstep((x,), (y,))
                tstep(torch.from_numpy(x), torch.from_numpy(y))
            jw = {n: np.asarray(v) for n, v in jstep.state["params"].items()}
        else:
            for x, y in zip(xs, ys):
                loss = ((jm(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
                loss.backward()
                jo.step()
                jo.clear_grad()
                _mse(pm(torch.from_numpy(x)), torch.from_numpy(y)).backward()
                to.step()
                to.clear_grad()
            jw = {n: np.asarray(v.numpy()) for n, v in jm.state_dict().items()}
        tol = STEPS if order == "train_step" else VALUE
        for n, p in pm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), jw[n], **tol, err_msg=f"{order} {n}")
        finals[order] = pm.weight.detach().numpy().copy()
    if len(finals) == 2:
        assert np.abs(finals["eager"] - finals["train_step"]).max() > 1e-4


def test_momentum_decay_moves_a_zero_gradient_parameter():
    """L2 decay alone moves a parameter whose gradient is 0 by ``lr coeff
    p``; L1 by ``lr coeff sign(p)``."""
    for reg, want in ((treg.L2Decay(0.5), lambda p: p - 0.1 * 0.5 * p),
                      (treg.L1Decay(0.5), lambda p: p - 0.1 * 0.5 * torch.sign(p))):
        p = torch.tensor([1.5, -2.0, 0.0], requires_grad=True)
        p0 = p.detach().clone()
        opt = topt.Momentum(learning_rate=0.1, parameters=[p], weight_decay=reg)
        (p * 0).sum().backward()
        opt.step()
        torch.testing.assert_close(p.detach(), want(p0))


# ------------------------------------------------------- lazy eager updates
@pytest.mark.parametrize("name", ["SGD", "AdamLazy"])
def test_lazy_eager_sparse_embedding(name):
    """``Embedding(sparse=True)`` records each forward's rows; ``SGD`` and
    ``Adam(lazy_mode=True)`` update only those rows in ``step()``: rows never
    looked up keep their values (and zero moments) bitwise, and the port
    equals the reference over three steps."""
    make = {"SGD": lambda O, ps: O.SGD(learning_rate=0.5, parameters=ps),
            "AdamLazy": lambda O, ps: O.Adam(learning_rate=0.1, parameters=ps, lazy_mode=True)}[name]
    paddle.seed(0)
    jm = jnn.Embedding(20, 4, sparse=True)
    pm = Embedding(20, 4, sparse=True, device="cpu")
    pm.load_state_dict(state_dict_by_name({"weight": np.asarray(jm.weight.numpy())}, pm))
    w0 = pm.weight.detach().numpy().copy()
    jo, to = make(jopt, jm.parameters()), make(topt, pm.parameters())
    rng = np.random.default_rng(4)
    ids = [np.array([1, 5, 5, 7]), np.array([5, 11, 2, 2]), np.array([7, 7, 1, 3])]
    for i in ids:
        y = rng.normal(size=(4, 4)).astype(np.float32)
        (jm(paddle.to_tensor(i)) * paddle.to_tensor(y)).sum().backward()
        jo.step()
        jo.clear_grad()
        (pm(torch.from_numpy(i)) * torch.from_numpy(y)).sum().backward()
        assert pm.weight.__dict__["_sparse_rows_pending"]
        to.step()
        assert not pm.weight.__dict__["_sparse_rows_pending"]
        to.clear_grad()
    np.testing.assert_allclose(pm.weight.detach().numpy(), np.asarray(jm.weight.numpy()), **VALUE)
    never = sorted(set(range(20)) - {1, 2, 3, 5, 7, 11})
    np.testing.assert_array_equal(pm.weight.detach().numpy()[never], w0[never])
    if name == "AdamLazy":
        np.testing.assert_array_equal(to._state["m"][0].numpy()[never], 0.0)
        np.testing.assert_allclose(to._state["v"][0].numpy(), np.asarray(jo._state["v"][0]), **VALUE)


def test_clip_or_decay_turns_laziness_off():
    """Under a clip the lazy optimizer takes the dense step (every row's
    moments decay), and the recorded rows are drained all the same."""
    p = torch.nn.Parameter(torch.ones(6, 2))
    emb = Embedding(6, 2, sparse=True, device="cpu")
    emb.weight = p
    opt = topt.Adam(learning_rate=0.1, parameters=[p], lazy_mode=True,
                    grad_clip=tclip.ClipGradByValue(1.0))
    for ids in ([0, 1], [2]):
        emb(torch.tensor(ids)).sum().backward()
        opt.step()
        assert not p.__dict__["_sparse_rows_pending"]
        opt.clear_grad()
    # row 0, looked up in step 1 only: its moment decayed in step 2
    np.testing.assert_allclose(opt._state["m"][0][0].numpy(), 0.9 * 0.1 * np.ones(2), rtol=1e-6)


def test_clear_grad_drops_recorded_rows():
    emb = Embedding(6, 2, sparse=True, device="cpu")
    opt = topt.SGD(learning_rate=0.1, parameters=emb.parameters())
    emb(torch.tensor([0, 1])).sum().backward()
    opt.clear_grad()
    assert not emb.weight.__dict__["_sparse_rows_pending"]
    with torch.no_grad():
        emb(torch.tensor([3]))
    assert not emb.weight.__dict__["_sparse_rows_pending"]


# -------------------------------------------------------------------- clips
_CLIPS = {"value": (lambda C: C.ClipGradByValue(0.3)),
          "value_min": (lambda C: C.ClipGradByValue(0.4, min=-0.1)),
          "norm": (lambda C: C.ClipGradByNorm(0.5)),
          "global_norm": (lambda C: C.ClipGradByGlobalNorm(0.5))}


@pytest.mark.parametrize("name", sorted(_CLIPS))
def test_clip_matches_reference(name):
    rng = np.random.default_rng(5)
    gs = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (7,), (2, 2))]
    want = _CLIPS[name](jclip).apply_tree({i: jnp.asarray(g) for i, g in enumerate(gs)})
    got = _CLIPS[name](tclip).apply_list([torch.from_numpy(g) for g in gs])
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[i]), **CORE)
    assert all(g.dtype == torch.float32 for g in got)


@pytest.mark.parametrize("norm_type", [2.0, float("inf"), 3.0])
def test_clip_grad_norm_matches_reference(norm_type):
    rng = np.random.default_rng(6)
    gs = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (7,))]
    jps = [paddle.to_tensor(np.zeros_like(g), stop_gradient=False) for g in gs]
    tps = [torch.zeros(g.shape, requires_grad=True) for g in gs]
    for jp, tp, g in zip(jps, tps, gs):
        (jp * paddle.to_tensor(g)).sum().backward()
        tp.grad = torch.from_numpy(g.copy())
    jn = jclip.clip_grad_norm_(jps, 0.7, norm_type)
    tn = tclip.clip_grad_norm_(tps, 0.7, norm_type)
    np.testing.assert_allclose(float(tn), float(jn.numpy()), **CORE)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad.numpy()), **CORE)
    tps[0].grad[0, 0] = float("nan")
    with pytest.raises(RuntimeError, match="non-finite"):
        tclip.clip_grad_norm_(tps, 0.7, norm_type, error_if_nonfinite=True)
    assert tclip.clip_grad_norm_([torch.zeros(2, requires_grad=True)], 1.0) is None


# -------------------------------------------------------- the rest, errors
def test_selected_rows_match_reference():
    rows = np.array([3, 1, 3, 0], np.int32)
    values = np.arange(8, dtype=np.float32).reshape(4, 2)
    jsr, tsr = JSelectedRows(rows, values, 5), SelectedRows(rows, torch.from_numpy(values), 5)
    np.testing.assert_array_equal(tsr.to_dense().numpy(), np.asarray(jsr.to_dense()))
    jm, tm = jsr.merge_add(), tsr.merge_add()
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_array_equal(tm.values.numpy(), np.asarray(jm.values))
    dense = np.arange(10, dtype=np.float32).reshape(5, 2)
    tf = SelectedRows.from_dense(torch.from_numpy(dense), [4, 0])
    assert tf.height == 5 and "nnz_rows=2" in repr(tf)
    np.testing.assert_array_equal(tf.values.numpy(), dense[[4, 0]])
    with pytest.raises(ValueError):
        SelectedRows([1, 2], torch.zeros(3, 2), 5)


def test_optimizers_take_the_reference_arguments():
    p = [torch.zeros(3, requires_grad=True)]
    for make in (lambda: topt.Lamb(parameters=p), lambda: topt.Adagrad(0.1, parameters=p),
                 lambda: topt.RMSProp(0.1, parameters=p, centered=True),
                 lambda: topt.Adadelta(parameters=p), lambda: topt.Adamax(parameters=p),
                 lambda: topt.Adam(parameters=p, weight_decay=treg.L2Decay(0.1)),
                 lambda: topt.SGD(parameters=p, weight_decay=0.1)):
        opt = make()
        p[0].grad = torch.ones(3)
        opt.step()
        opt.clear_grad()
        assert opt.state_dict()["step"] == 1
    with pytest.raises(ValueError, match="weight_decay"):
        topt.RowSparseAdam(weight_decay=0.1)
    with pytest.raises(NotImplementedError, match="lr_ratio"):
        topt.AdamW(parameters=p, lr_ratio=lambda prm: 1.0)
    with pytest.raises(NotImplementedError, match="exclude_from_weight_decay_fn"):
        topt.Lamb(parameters=p, exclude_from_weight_decay_fn=lambda n: True)
    with pytest.raises(NotImplementedError, match="three_phase"):
        tlr.OneCycleLR(0.1, 100, three_phase=True)

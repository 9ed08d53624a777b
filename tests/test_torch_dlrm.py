"""DLRM and its embedding table (``models/dlrm.py``,
``distributed/embedding.py``, ``framework/selected_rows.py``) against
``paddle_tpu``'s, on the CPU.

Inputs are made with numpy from a seed and go through both packages;
weights made by ``paddle_tpu`` are carried across by
``paddle_tpu_torch.utils.convert.state_dict_by_name``.

Tolerances, f32: the forward and the loss atol 1e-6 / rtol 1e-5 (f32
rounding, sums in another order); three ``run_steps`` steps at the
reference's own dp4-against-dp1 tolerance, rtol 2e-5 / atol 2e-6
(``tests/test_recsys.py``); lookups, zero rows and the rows a row-sparse
update leaves alone exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import embedding as jemb
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.dlrm import DLRM as JDLRM
from paddle_tpu.models.dlrm import DLRMConfig as JDLRMConfig
from paddle_tpu.models.dlrm import DLRMCriterion as JDLRMCriterion
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.optimizer import RowSparseAdam as JRowSparseAdam
from paddle_tpu.tensor._helpers import ensure_tensor, op

from paddle_tpu_torch.distributed import embedding as temb
from paddle_tpu_torch.framework.selected_rows import compiled_step
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.dlrm import DLRM, DLRMConfig, DLRMCriterion
from paddle_tpu_torch.nn.functional import embedding
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.optimizer import RowSparseAdam
from paddle_tpu_torch.utils.convert import state_dict_by_name

VALUE = dict(atol=1e-6, rtol=1e-5)
STEPS = dict(atol=2e-6, rtol=2e-5)
V, D = 32, 8


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _dlrm_pair(seed=0):
    """The reference's tiny DLRM from ``paddle.seed(seed)`` and the port's
    with its weights."""
    paddle.seed(seed)
    jm = JDLRM(JDLRMConfig.tiny())
    pm = DLRM(DLRMConfig.tiny(), device="cpu")
    pm.load_state_dict(state_dict_by_name(_state(jm), pm))
    return jm, pm


def _dlrm_batch(rng, batch=8, cfg=None):
    cfg = cfg or DLRMConfig.tiny()
    dense = rng.normal(size=(batch, cfg.num_dense)).astype(np.float32)
    ids = np.stack([rng.integers(0, v, batch) for v in cfg.vocab_sizes], axis=1).astype(np.int32)
    labels = rng.integers(0, 2, (batch, 1)).astype(np.float32)
    return (dense, ids), (labels,)


def _opt_state(opt, model, name, key):
    """The port optimizer's state ``key`` of ``model``'s parameter ``name``."""
    names = [n for n, _ in model.named_parameters()]
    return opt._state[key][names.index(name)].numpy()


# ------------------------------------------------------------- forward, loss
@pytest.mark.parametrize("seed", [0, 1])
def test_dlrm_forward_and_criterion_match(seed):
    jm, pm = _dlrm_pair(seed)
    (dense, ids), (labels,) = _dlrm_batch(np.random.default_rng(seed + 10))
    jout = np.asarray(jm(paddle.to_tensor(dense), paddle.to_tensor(ids)).numpy())
    pout = pm(torch.from_numpy(dense), torch.from_numpy(ids))
    assert pout.shape == (8, 1)
    np.testing.assert_allclose(pout.detach().numpy(), jout, **VALUE)
    jloss = float(JDLRMCriterion()(paddle.to_tensor(jout), paddle.to_tensor(labels)).numpy())
    ploss = DLRMCriterion()(torch.from_numpy(jout), torch.from_numpy(labels))
    assert ploss.dtype == torch.float32 and ploss.ndim == 0
    np.testing.assert_allclose(float(ploss), jloss, **VALUE)


def test_dlrm_state_converts_name_for_name():
    jm, pm = _dlrm_pair()
    assert sorted(pm.state_dict()) == sorted(_state(jm))
    assert pm.embedding.weight.shape == (224, 8) and pm.sparse_param_names() == ["embedding.weight"]
    bad = dict(_state(jm))
    bad.pop("top.2.bias")
    with pytest.raises(KeyError, match="top.2.bias"):
        state_dict_by_name(bad, pm)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("capacity", [None, 3])
def test_exchange_stats_match(shards, capacity):
    want = jemb.exchange_stats(64, 1000, 16, shards, capacity)
    assert temb.exchange_stats(64, 1000, 16, shards, capacity) == want
    table = temb.ShardedEmbedding(1000, 16, capacity=capacity, device="cpu")
    assert table.exchange_stats(64, shards=shards) == want
    if shards == 1:
        assert table.exchange_stats(64) == want


def test_unported_exchange_raises():
    """The exchange runs over the fleet's process groups: a mesh object of
    another kind (the reference's ``jax.sharding.Mesh`` stands for its
    devices, which a process of the port does not hold) raises, and so
    does a rotation period below one step (the exchange itself:
    ``tests/test_torch_recsys.py``)."""
    class Mesh:
        shape = {"dp": 4}

    with pytest.raises(TypeError, match="HybridCommunicateGroup"):
        temb.ShardedEmbedding(V, D, mesh=Mesh(), device="cpu")
    with pytest.raises(TypeError, match="HybridCommunicateGroup"):
        temb.sharded_embedding_lookup(torch.zeros(4, dtype=torch.int32), torch.zeros(V, D), Mesh())
    with pytest.raises(ValueError, match="every"):
        temb.EmbeddingCheckpointRotation(None, every=0)


# ------------------------------------------------------ zero rows, padding
def _table():
    return np.random.default_rng(0).normal(size=(V, D)).astype(np.float32)


def _port_lookup_grad(fn, ids, dy):
    """``fn(ids, weight)``'s output and the weight's gradient under the
    cotangent ``dy``; ``fn`` may swap in a table of its own (a module's
    parameter) and return it beside the output."""
    w = torch.from_numpy(_table()).requires_grad_()
    out = fn(torch.from_numpy(ids), w)
    out, w = out if isinstance(out, tuple) else (out, w)
    (out * torch.from_numpy(dy)).sum().backward()
    return out.detach().numpy(), w.grad.numpy()


def _ref_lookup_grad(fn, ids, dy):
    import jax

    def loss(w):
        return jnp.sum(fn(w, jnp.asarray(ids)) * dy)

    w = jnp.asarray(_table())
    return np.asarray(fn(w, jnp.asarray(ids))), np.asarray(jax.grad(loss)(w))


def _sharded_ref(w, i):
    emb = jemb.ShardedEmbedding(30, D)
    emb.weight._value = w
    with paddle.no_grad():
        return emb(paddle.to_tensor(i))._value


def _sharded_port(i, w):
    emb = temb.ShardedEmbedding(30, D, device="cpu")
    with torch.no_grad():
        emb.weight.copy_(w)
    return emb(i), emb.weight


@pytest.mark.parametrize("case", ["sharded_out_of_range", "f_embedding_in_step", "padding_idx"])
def test_zero_row_output_and_gradient(case):
    """Out-of-range ids (the fused table's 30 valid rows of 32 stored, and
    -2) give the zero row and add exactly zero to the clamped row's
    gradient; ``padding_idx`` rows give zeros and get no gradient."""
    ids = np.array([1, 30, -2, 3, 40, 1, 31, 0], np.int32)
    dy = np.random.default_rng(1).normal(size=(8, D)).astype(np.float32)
    if case == "sharded_out_of_range":
        ref = _ref_lookup_grad(_sharded_ref, ids, dy)
        got = _port_lookup_grad(_sharded_port, ids, dy)
        bad = [1, 2, 4, 6]
    elif case == "f_embedding_in_step":
        import jax

        ids = np.array([1, 32, -2, 3, 40, 1, 35, 0], np.int32)  # past the 32 rows

        def jfn(w, i):
            return jnn.functional.embedding(ensure_tensor(i), ensure_tensor(w))._value

        ref = _ref_lookup_grad(jax.jit(jfn), ids, dy)  # traced: the zero row
        with compiled_step():
            got = _port_lookup_grad(lambda i, w: embedding(i, w), ids, dy)
        bad = [1, 2, 4, 6]
    else:
        ids = np.array([2, 0, 2, 5, 7, 2, 0, 1], np.int32)

        def jfn(w, i):
            return jnn.functional.embedding(ensure_tensor(i), ensure_tensor(w), padding_idx=2)._value

        ref = _ref_lookup_grad(jfn, ids, dy)
        got = _port_lookup_grad(lambda i, w: embedding(i, w, padding_idx=2), ids, dy)
        bad = [0, 2, 5]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[0][bad], 0.0)
    np.testing.assert_allclose(got[1], ref[1], **VALUE)
    grad_rows = {int(i) for k, i in enumerate(ids) if k not in bad}
    for row in set(range(V)) - grad_rows:
        np.testing.assert_array_equal(got[1][row], 0.0)


def test_f_embedding_eager_out_of_range_raises():
    w = torch.from_numpy(_table())
    with pytest.raises(ValueError, match=r"id 32 at flat position 2"):
        embedding(torch.tensor([[1, 3], [32, 0]]), w)
    with pytest.raises(ValueError, match=r"id -1 at flat position 0"):
        embedding(torch.tensor([-1, 3]), w)


# ---------------------------------------------------------- training steps
def _steps_pair(batches, seed=0):
    jm, pm = _dlrm_pair(seed)
    jopt = JRowSparseAdam(learning_rate=1e-2, parameters=jm.parameters(),
                          sparse_params=jm.sparse_param_names())
    jstep = JTrainStep(jm, jopt, JDLRMCriterion(), seed=0)
    popt = RowSparseAdam(learning_rate=1e-2, parameters=pm.parameters(),
                         sparse_params=pm.sparse_param_names())
    pstep = TrainStep(pm, popt, DLRMCriterion())
    return jstep.run_steps(batches), jstep, pstep.run_steps(batches), pm, popt


def test_dlrm_run_steps_match_reference():
    """Three ``run_steps`` steps of ``RowSparseAdam`` from the same weights:
    the losses, the table and its moments, and every MLP parameter; one
    dispatch for the call; rows no step touched keep their values and
    zero moments bitwise."""
    rng = np.random.default_rng(0)
    batches = [_dlrm_batch(rng) for _ in range(3)]
    w0 = _dlrm_pair()[1].embedding.weight.detach().numpy().copy()
    metrics.reset_counters("train_step.")
    jout, jstep, pout, pm, popt = _steps_pair(batches)
    c = metrics.counters("train_step.")
    assert c["train_step.dispatches"] == 1 and c["train_step.steps"] == 3
    assert pout["loss"].shape == (3,) and np.isfinite(pout["loss"].numpy()).all()
    np.testing.assert_allclose(pout["loss"].numpy(), np.asarray(jout["loss"].numpy()), **STEPS)
    jparams, jopt = jstep.state["params"], jstep.state["opt"]
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[name]), **STEPS,
                                   err_msg=name)
    for key in ("m", "v"):
        np.testing.assert_allclose(_opt_state(popt, pm, "embedding.weight", key),
                                   np.asarray(jopt[key]["embedding.weight"]), **STEPS)
    offsets = np.cumsum((0,) + DLRMConfig.tiny().vocab_sizes[:-1])
    seen = set(np.concatenate([b[0][1] + offsets for b in batches]).ravel().tolist())
    never = sorted(set(range(224)) - seen)
    assert len(never) > 100
    np.testing.assert_array_equal(pm.embedding.weight.detach().numpy()[never], w0[never])
    for key in ("m", "v"):
        np.testing.assert_array_equal(_opt_state(popt, pm, "embedding.weight", key)[never], 0.0)


def test_no_pending_rows_after_run_steps():
    """Inside ``TrainStep`` the table records no rows (nothing would drain
    them) and counts no eager row touches; a lookup still counts."""
    rng = np.random.default_rng(3)
    metrics.reset_counters("embedding.")
    _, _, _, pm, _ = _steps_pair([_dlrm_batch(rng) for _ in range(2)])
    assert not pm.embedding.weight.__dict__.get("_sparse_rows_pending")
    c = metrics.counters("embedding.")
    assert c["embedding.lookups"] == 2 and c["embedding.rows_touched"] == 0


class _EmbOnly(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = temb.ShardedEmbedding(V, D, device="cpu")

    def forward(self, ids):
        return self.emb(ids)


class _JEmbOnly(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = jemb.ShardedEmbedding(V, D, axis="dp")

    def forward(self, ids):
        return self.emb(ids)


class _JDotLoss:
    def __call__(self, out, y):
        return op(lambda o, v: jnp.sum(o * v), ensure_tensor(out), ensure_tensor(y), _name="dot_loss")


def _dot_loss(out, y):
    return (out * y).sum()


def _emb_pair():
    paddle.seed(0)
    jm = _JEmbOnly()
    pm = _EmbOnly()
    pm.load_state_dict(state_dict_by_name(_state(jm), pm))
    return jm, pm


# step 1 touches rows {1, 3, 9}; step 2 looks up {1, 9, 12} (row 3 not)
_IDS = [np.array([1, 3, 3, 9], np.int32), np.array([1, 9, 9, 12], np.int32)]


def _ys(zero_row=False):
    """The two steps' cotangents and ids; with ``zero_row``, step 2 looks
    row 3 up with a zero cotangent."""
    rng = np.random.default_rng(0)
    ys = [rng.normal(size=(4, D)).astype(np.float32) for _ in range(2)]
    if not zero_row:
        return ys, _IDS
    ys[1][2] = 0.0
    return ys, [_IDS[0], np.array([1, 9, 3, 12], np.int32)]


def _run_emb(path, ids, ys):
    """Two steps of RowSparseAdam(lr 0.1) over the table in both packages;
    returns ``{pkg: (w0, w1, m1, w2, m2, v2)}``."""
    jm, pm = _emb_pair()
    out = {}
    jopt = JRowSparseAdam(learning_rate=0.1, parameters=jm.parameters(), sparse_params=["emb.weight"])
    popt = RowSparseAdam(learning_rate=0.1, parameters=pm.parameters(), sparse_params=["emb.weight"])
    if path == "train_step":
        jstep = JTrainStep(jm, jopt, _JDotLoss(), seed=0)
        pstep = TrainStep(pm, popt, _dot_loss)
        snaps = {"paddle_tpu": [np.asarray(jstep.state["params"]["emb.weight"])],
                 "port": [pm.emb.weight.detach().numpy().copy()]}
        for i, y in zip(ids, ys):
            jstep((i,), (y,))
            pstep(torch.from_numpy(i), torch.from_numpy(y))
            snaps["paddle_tpu"] += [np.asarray(jstep.state["params"]["emb.weight"]),
                                    np.asarray(jstep.state["opt"]["m"]["emb.weight"]),
                                    np.asarray(jstep.state["opt"]["v"]["emb.weight"])]
            snaps["port"] += [pm.emb.weight.detach().numpy().copy(),
                              popt._state["m"][0].numpy().copy(), popt._state["v"][0].numpy().copy()]
    else:
        snaps = {"paddle_tpu": [np.asarray(jm.emb.weight.numpy())],
                 "port": [pm.emb.weight.detach().numpy().copy()]}
        for i, y in zip(ids, ys):
            loss = (jm(paddle.to_tensor(i)) * paddle.to_tensor(y)).sum()
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            _dot_loss(pm(torch.from_numpy(i)), torch.from_numpy(y)).backward()
            popt.step()
            popt.clear_grad()
            snaps["paddle_tpu"] += [np.asarray(jm.emb.weight.numpy()),
                                    np.asarray(jopt._state["m"][0]), np.asarray(jopt._state["v"][0])]
            snaps["port"] += [pm.emb.weight.detach().numpy().copy(),
                              popt._state["m"][0].numpy().copy(), popt._state["v"][0].numpy().copy()]
    for pkg, s in snaps.items():
        out[pkg] = (s[0], s[1], s[2], s[4], s[5], s[6])
    return out


@pytest.mark.parametrize("path", ["train_step", "eager"])
def test_row_sparse_adam_steps_only_looked_up_rows(path):
    """``tests/test_recsys.py``'s row-3 scenario: rows never looked up keep
    their values and zero moments bitwise; row 3, looked up in step 1 only,
    keeps its step-1 value and moment through step 2; the port equals the
    reference."""
    ys, ids = _ys()
    runs = _run_emb(path, ids, ys)
    never = sorted(set(range(V)) - {1, 3, 9, 12})
    for pkg, (w0, w1, m1, w2, m2, v2) in runs.items():
        np.testing.assert_array_equal(w2[never], w0[never], err_msg=pkg)
        np.testing.assert_array_equal(m2[never], 0.0, err_msg=pkg)
        np.testing.assert_array_equal(v2[never], 0.0, err_msg=pkg)
        np.testing.assert_array_equal(w2[3], w1[3], err_msg=pkg)
        np.testing.assert_array_equal(m2[3], m1[3], err_msg=pkg)
        assert np.abs(m1[3]).sum() > 0
    for a, b in zip(runs["port"], runs["paddle_tpu"]):
        np.testing.assert_allclose(a, b, **VALUE)


@pytest.mark.parametrize("path", ["train_step", "eager"])
def test_zero_gradient_looked_up_row(path):
    """Row 3 is looked up in step 2 with an all-zero gradient. In a
    ``TrainStep`` the core keys on nonzero-gradient rows: row 3 keeps its
    moments. In eager mode the lazy rows are the looked-up ones: row 3's
    moments decay (m by beta1) and its value moves by the decayed moment.
    Both packages agree."""
    ys, ids = _ys(zero_row=True)
    runs = _run_emb(path, ids, ys)
    for pkg, (w0, w1, m1, w2, m2, v2) in runs.items():
        if path == "train_step":
            np.testing.assert_array_equal(m2[3], m1[3], err_msg=pkg)
            np.testing.assert_array_equal(w2[3], w1[3], err_msg=pkg)
        else:
            np.testing.assert_allclose(m2[3], 0.9 * m1[3], rtol=1e-6, err_msg=pkg)
            assert not np.array_equal(w2[3], w1[3])
    for a, b in zip(runs["port"], runs["paddle_tpu"]):
        np.testing.assert_allclose(a, b, **VALUE)


def test_eager_lookup_records_rows_and_counts():
    metrics.reset_counters("embedding.")
    emb = temb.ShardedEmbedding(30, D, device="cpu")
    emb(torch.tensor([[1, 3], [3, 35]]))
    with torch.no_grad():
        emb(torch.tensor([7]))
    pend = emb.weight.__dict__["_sparse_rows_pending"]
    assert len(pend) == 1 and pend[0].tolist() == [1, 3]
    c = metrics.counters("embedding.")
    assert c["embedding.lookups"] == 2 and c["embedding.rows_touched"] == 2


def test_recsys_counters_predeclared():
    assert metrics.RECSYS_COUNTERS == jmetrics.RECSYS_COUNTERS
    have = metrics.counters()
    for name in metrics.RECSYS_COUNTERS:
        assert name in have, name

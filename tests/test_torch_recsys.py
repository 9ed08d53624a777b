"""The row-sharded embedding exchange, DLRM over ``dp`` and the table's
checkpoint rotation (``distributed/embedding.py``, ``models/dlrm.py``,
``utils/convert.py``) against ``paddle_tpu``'s, the cases of
``tests/test_recsys.py``.

The port's ranks are gloo processes on the CPU
(``tests/torch_recsys_ranks.py``, each world spawned once per case); the
reference runs its ``shard_map`` exchange on ``tests/conftest.py``'s CPU
mesh. Lookups, their gradients, the zero rows and the rotation are held
bitwise; DLRM's ``run_steps`` at dp 4 against the reference's dp 1 at the
reference's own dp4-against-dp1 tolerance (rtol 2e-5, atol 2e-6).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.distributed.embedding import exchange_stats, sharded_embedding_lookup
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.dlrm import DLRM as JDLRM
from paddle_tpu.models.dlrm import DLRMConfig as JDLRMConfig
from paddle_tpu.models.dlrm import DLRMCriterion as JDLRMCriterion
from paddle_tpu.optimizer import RowSparseAdam as JRowSparseAdam

from paddle_tpu_torch.testing.dist import run_ranks

import torch_recsys_ranks as ranks
from torch_hybrid_reference import started

V, D, B = 32, 8, 16
STEPS = dict(atol=2e-6, rtol=2e-5)

_ID_BATCHES = {
    "uniform": np.random.default_rng(1).integers(0, V, B).astype(np.int32),
    "skewed": np.minimum((np.random.default_rng(2).pareto(1.0, B) * 3)
                         .astype(np.int32), V - 1),
    "duplicates": np.array([3] * 8 + [17] * 8, np.int32),
    # every id owned by shard 0: the other shards serve no request
    "empty_shards": np.random.default_rng(3).integers(0, V // 4, B).astype(np.int32),
}


def _table():
    return np.random.default_rng(0).normal(size=(V, D)).astype(np.float32)


def _cot(ids):
    """The cotangent of the lookup: random rows, one per id, made exactly
    (a ``sin``-style loss would differ in its last bit between the two
    packages' elementwise math, before any accumulation)."""
    return np.random.default_rng(4).normal(size=(ids.shape[0], D)).astype(np.float32)


def _reference_lookup(n, table, ids, **kw):
    """The reference's sharded lookup on an n-device mesh: the output and
    the gradient of ``sum(o * cot)``."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("dp",))
    sh = NamedSharding(mesh, P("dp"))
    cot = jnp.asarray(_cot(ids))

    def loss(t, i):
        o = sharded_embedding_lookup(i, t, mesh, axis="dp", **kw)
        return jnp.sum(o * cot), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.device_put(jnp.asarray(table), sh), jax.device_put(jnp.asarray(ids), sh))
    return np.asarray(o), np.asarray(g)


_BAD_IDS = np.array([0, 5, V + 3, -1] * 4, np.int32)  # 2 bad ids per quarter
_CAP_IDS = np.array([0, 1, 2, 0] * 4, np.int32)  # 3 unique ids for shard 0, capacity 2


def _lookup_jobs(world):
    """The lookups a world runs: the four batches plain, and at world 4 the
    out-of-range and capacity batches with their knobs."""
    jobs = {k: (v, _cot(v), {}) for k, v in _ID_BATCHES.items()}
    if world == 4:
        jobs["range"] = (_BAD_IDS, _cot(_BAD_IDS), dict(num_embeddings=V))
        jobs["cap"] = (_CAP_IDS, _cot(_CAP_IDS), dict(capacity=2))
    return jobs


@pytest.fixture(scope="module")
def worlds():
    """This file's lookup worlds of 2 and 4 ranks (the world of 4 also runs
    the divisibility and exchange-event bodies), queued in the background
    while each test computes the reference's side."""
    table = _table()
    return {2: started(ranks.lookups, 2, table, _lookup_jobs(2)),
            4: started(ranks.several, 4, [("lookups", (table, _lookup_jobs(4))),
                                          ("divisibility_errors", ()),
                                          ("exchange_events", (table, _ID_BATCHES["uniform"]))])}


def _joined(results, kind):
    return (np.concatenate([r[kind][0] for r in results]),
            np.concatenate([r[kind][1] for r in results]))


def _world(worlds, world, i=0):
    """Body ``i``'s results of the queued ``world`` (the world of 2 runs one)."""
    return worlds[2].result() if world == 2 else [r[i] for r in worlds[4].result()]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_lookup_and_gradient_bitwise(worlds, world):
    """Uniform, skewed, duplicate and empty-shard batches: every rank's
    lookup and its rows' gradient equal the reference's bits, and those
    equal a dense lookup's (the reference's own test)."""
    table = _table()
    want = {kind: _reference_lookup(world, table, ids) for kind, ids in _ID_BATCHES.items()}
    got = _world(worlds, world)
    for kind, ids in _ID_BATCHES.items():
        out, grad = _joined(got, kind)
        np.testing.assert_array_equal(out, want[kind][0], err_msg=kind)
        np.testing.assert_array_equal(grad, want[kind][1], err_msg=kind)
        np.testing.assert_array_equal(out, table[ids], err_msg=kind)


def test_out_of_range_and_capacity_give_zero_rows(worlds):
    """Out-of-range ids (``num_embeddings``) and ids past an owner's
    ``capacity`` give the zero row and no gradient, as the reference's, at
    world 4."""
    table = _table()
    want_range = _reference_lookup(4, table, _BAD_IDS, num_embeddings=V)
    want_cap = _reference_lookup(4, table, _CAP_IDS, capacity=2)
    got = _world(worlds, 4)
    out, grad = _joined(got, "range")
    np.testing.assert_array_equal(out, want_range[0])
    np.testing.assert_array_equal(grad, want_range[1])
    bad = (_BAD_IDS < 0) | (_BAD_IDS >= V)
    np.testing.assert_array_equal(out[bad], 0.0)
    out, grad = _joined(got, "cap")
    np.testing.assert_array_equal(out, want_cap[0])
    np.testing.assert_array_equal(grad, want_cap[1])
    np.testing.assert_array_equal(out[_CAP_IDS == 2], 0.0)


def test_divisibility_errors(worlds):
    for msgs in _world(worlds, 4, 1):
        assert len(msgs) == 2, msgs
        assert "table rows 30 not divisible by mesh axis 'dp' degree 4" in msgs[0]
        assert "look up [2, 3, 4, 5] ids" in msgs[1]


def test_exchange_events_and_counters(worlds):
    """The ranks' ``embedding.*`` counters sum to the reference's for the
    same global lookup, and each rank's ``embedding_exchange`` event carries
    the global lookup's ``exchange_stats``."""
    table, ids = _table(), _ID_BATCHES["uniform"]
    got = _world(worlds, 4, 2)
    stats = exchange_stats(B, V, D, 4)
    np.testing.assert_array_equal(np.concatenate([r["out"] for r in got]), table[ids])
    total = {k: sum(r["counters"][k] for r in got) for k in got[0]["counters"]}
    assert total["embedding.lookups"] == 4
    assert total["embedding.ids_exchanged"] == B
    assert total["embedding.a2a_bytes"] == stats["bytes_total"] > 0
    assert total["embedding.rows_touched"] == 0  # no gradient taken
    for r in got:
        (ev,) = r["events"]
        assert {k: ev[k] for k in stats} == stats and ev["shards"] == 4


# ------------------------------------------------------------------- DLRM
def _dlrm_reference(batches):
    """The reference's tiny DLRM from ``paddle.seed(0)``: its weights, and
    its one-device ``run_steps`` over ``batches``."""
    paddle.seed(0)
    jm = JDLRM(JDLRMConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    opt = JRowSparseAdam(learning_rate=1e-2, parameters=jm.parameters(),
                         sparse_params=jm.sparse_param_names())
    out = JTrainStep(jm, opt, JDLRMCriterion())
    metrics = out.run_steps(batches)
    return state, np.asarray(metrics["loss"].numpy()), out.state


def _dlrm_batches(n, seed=0, batch=16):
    rng = np.random.default_rng(seed)
    cfg = JDLRMConfig.tiny()
    out = []
    for _ in range(n):
        dense = rng.normal(size=(batch, cfg.num_dense)).astype(np.float32)
        ids = np.stack([rng.integers(0, v, batch) for v in cfg.vocab_sizes],
                       axis=1).astype(np.int32)
        labels = rng.integers(0, 2, (batch, 1)).astype(np.float32)
        out.append(((dense, ids), (labels,)))
    return out


def test_dlrm_dp4_matches_reference_dp1():
    """Three ``run_steps`` steps of ``RowSparseAdam`` at dp 4 (the table
    row-sharded, the MLPs data-parallel) against the reference's one-device
    run: the losses, the table, its moments and every MLP parameter."""
    batches = _dlrm_batches(3)
    state, jloss, jstate = _dlrm_reference(batches)
    got = run_ranks(ranks.dlrm_steps, 4, state, batches)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["loss"], jloss, **STEPS)
        assert g["rows"] == (r * 56, (r + 1) * 56)
        assert g["counters"]["embedding.ids_exchanged"] == 3 * 16 * 3 // 4
    table = np.concatenate([g["params"]["embedding.weight"] for g in got])
    np.testing.assert_allclose(table, np.asarray(jstate["params"]["embedding.weight"]), **STEPS)
    for key in ("m", "v"):
        np.testing.assert_allclose(np.concatenate([g["opt"][key] for g in got]),
                                   np.asarray(jstate["opt"][key]["embedding.weight"]), **STEPS)
    for name, w in got[0]["params"].items():
        if name != "embedding.weight":
            np.testing.assert_allclose(w, np.asarray(jstate["params"][name]), **STEPS,
                                       err_msg=name)
            for g in got[1:]:
                np.testing.assert_array_equal(g["params"][name], w, err_msg=name)


def test_embedding_checkpoint_rotation_dp4_dp2_dp4_bitwise(tmp_path):
    """Save at dp 4 through the rotation, restore onto dp 2 (which trains
    on), publish again, restore onto dp 4: the whole state, bitwise."""
    batches = _dlrm_batches(3, seed=1)
    paddle.seed(0)
    state = {k: np.asarray(v.numpy()) for k, v in JDLRM(JDLRMConfig.tiny()).state_dict().items()}
    a, b = str(tmp_path / "ckpt"), str(tmp_path / "ckpt2")
    saved = run_ranks(ranks.rotation_save, 4, state, batches[:2], a)
    assert all(s["saved"] and s["again"] is None for s in saved)
    rows = saved[0]["counters"]["embedding.rows_checkpointed"]
    assert rows == 224 and all(s["counters"] == saved[0]["counters"] for s in saved)
    whole0 = saved[0]["whole"]
    down = run_ranks(ranks.rotation_restore, 2, state, a, b, batches[2])
    assert all(d["at"] == 2 for d in down)
    assert np.isfinite(down[0]["loss"]).all()
    for key, v in whole0.items():
        np.testing.assert_array_equal(down[0]["whole"][key], v, err_msg=key)
    up = run_ranks(ranks.rotation_restore, 4, state, b, None, None)
    assert all(u["at"] == 3 for u in up)
    assert up[0]["whole"].keys() == whole0.keys()
    for key, v in whole0.items():
        np.testing.assert_array_equal(up[0]["whole"][key], v, err_msg=key)


def test_convert_cuts_and_joins_the_named_rows():
    """``utils/convert.py`` cuts the leaves ``ep_names`` names (a row-sharded
    table, as ``expert_split_names`` reads it off the model) along their
    rows over the expert degree and joins them back bitwise; without
    ``ep_names`` only GPT-MoE's expert weights are cut, so the table stays
    whole."""
    from paddle_tpu_torch.models.dlrm import DLRM, DLRMConfig
    from paddle_tpu_torch.utils.convert import expert_split_names, gather_state, shard_state

    model = DLRM(DLRMConfig.tiny(), device="cpu")
    assert expert_split_names(model) == set()  # one shard: nothing split
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    names = {"embedding.weight"}
    pieces = [shard_state(state, ep_rank=r, ep_degree=4, ep_names=names) for r in range(4)]
    rows = state["embedding.weight"].shape[0] // 4
    for r, piece in enumerate(pieces):
        np.testing.assert_array_equal(piece["embedding.weight"],
                                      state["embedding.weight"][r * rows:(r + 1) * rows])
        for k, v in state.items():
            if k not in names:
                np.testing.assert_array_equal(piece[k], v, err_msg=k)
    joined = gather_state({(0, 0, 0, r): p for r, p in enumerate(pieces)}, ep_names=names)
    assert joined.keys() == state.keys()
    for k, v in state.items():
        np.testing.assert_array_equal(joined[k], v, err_msg=k)
    whole = shard_state(state, ep_rank=1, ep_degree=4)
    np.testing.assert_array_equal(whole["embedding.weight"], state["embedding.weight"])

"""ERNIE 3.0 pre-training of the port against ``paddle_tpu``'s, on the CPU.

A ``paddle_tpu`` ERNIE made from a seed is carried across by
``paddle_tpu_torch.utils.convert``; both get the same numpy ids and labels
(every second position's MLM label -100 and random SOP labels, as
``bench_1p3b.py:_tpu_run(True)`` makes them). No attention mask, so both
sides' ``sdpa`` picks ``flash``: the reference's Pallas K1/K2 through the
Pallas interpreter (blocks of 64 < s, so the kernels stream tiles), the
port's plain K1/K2. The config is ``ErnieConfig.tiny(hidden_size=128,
num_heads=2, max_seq_len=256)``: d = 64, two layers, s = 256 (the
reference's kernels take s >= 256).

Tolerances, f32: gradients atol 2e-5 / rtol 1e-4, the reference's tolerance
for its own kernels (``tests/test_flash_interpret.py``); forward values atol
1e-5 / rtol 1e-4 (f32 rounding of two post-LN layers, sums in another
order), as ``tests/test_torch_bert.py``. bf16 (AMP O2) tolerances are
stated where they are used.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed.fleet import fleet as jfleet  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.models.ernie import ErnieConfig as JErnieConfig  # noqa: E402
from paddle_tpu.models.ernie import ErnieForPretraining as JErnie  # noqa: E402
from paddle_tpu.models.ernie import ErniePretrainingCriterion as JCriterion  # noqa: E402
from paddle_tpu.observability import metrics as jmetrics  # noqa: E402
from paddle_tpu.ops import flash_attention as jfa  # noqa: E402
from paddle_tpu.ops import registry as jregistry  # noqa: E402

from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models.bert import BertConfig, BertEmbeddings  # noqa: E402
from paddle_tpu_torch.models.ernie import (ErnieConfig, ErnieEmbeddings,  # noqa: E402
                                           ErnieForPretraining, ErniePretrainingCriterion)
from paddle_tpu_torch.observability import metrics  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import registry  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu  # noqa: E402

CFG = dict(hidden_size=128, num_heads=2, max_seq_len=256)
B, S, V = 2, 256, 512
GRAD = dict(atol=2e-5, rtol=1e-4)
VALUE = dict(atol=1e-5, rtol=1e-4)
LR = 1e-3
# parameters after one AdamW step, compared where the reference's |g|
# exceeds 1e-4 (as tests/test_torch_bert.py: the first step moves an entry
# by about lr * sign(g), so one whose gradient sits at the f32 noise of the
# two sides' sums may land 2 lr apart)
PARAMS_AFTER = dict(atol=1e-4, rtol=1e-4)
SIGNED_GRAD = 1e-4


@pytest.fixture(autouse=True)
def one_device_reference():
    """The reference on one device: a fleet mesh another test module left
    initialised would make its mp_layers shard the step; restored after."""
    prior = jfleet._hcg
    jfleet._hcg = None
    yield
    jfleet._hcg = prior


@pytest.fixture
def jax_flash_interpret():
    """The reference's Pallas K1/K2 through the interpreter with 64-row
    blocks, so its ``sdpa`` picks ``flash`` on the CPU as the port's does."""
    prior = jfa.set_interpret(True)
    saved = (jfa._BLOCK_Q, jfa._BLOCK_K)
    jfa._BLOCK_Q = jfa._BLOCK_K = 64
    jregistry.clear_cache()
    registry.clear_cache()
    yield
    jfa.set_interpret(prior)
    jfa._BLOCK_Q, jfa._BLOCK_K = saved
    jregistry.clear_cache()
    registry.clear_cache()


def _pair(seed, **kw):
    paddle.seed(seed)
    jm = JErnie(JErnieConfig.tiny(**CFG, **kw))
    pm = ErnieForPretraining(ErnieConfig.tiny(**CFG, **kw), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    return jm, pm


def _batch(seed):
    """ids, MLM labels (the ids, every second position -100), SOP labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, S)).astype(np.int32)
    mlm = ids.astype(np.int64)
    mlm[:, ::2] = -100
    sop = rng.integers(0, 2, (B,)).astype(np.int64)
    return ids, mlm, sop


def _loss_fn(crit):
    """``TrainStep``'s loss over the model's ``(mlm, sop)`` logits, as
    ``bench_1p3b.py`` wraps the criterion."""
    def loss_fn(outs, mlm, sop):
        return crit(outs[0], outs[1], mlm, sop)
    return loss_fn


def test_forward_and_criterion_match_paddle_tpu(jax_flash_interpret):
    """Eval forward: MLM and SOP logits, and the criterion on them, through
    ``sdpa``/``flash`` on both sides; explicit task-type ids move the
    logits as the reference's do."""
    jm, pm = _pair(seed=61)
    jm.eval()
    pm.eval()
    ids, mlm, sop = _batch(seed=62)
    jmetrics.reset_counters("kernels.sdpa.")
    metrics.reset_counters("kernels.sdpa.")
    jout = jm(paddle.to_tensor(ids))
    with torch.no_grad():
        tout = pm(torch.from_numpy(ids))
    assert jmetrics.counters("kernels.sdpa.").get("kernels.sdpa.picked", 0) >= 1
    assert jmetrics.counters("kernels.sdpa.").get("kernels.sdpa.fallback", 0) == 0
    assert metrics.counters("kernels.sdpa.") == {"kernels.sdpa.picked": 1,
                                                 "kernels.sdpa.fallback": 0}
    assert registry.select("sdpa", *(torch.zeros(B, S, 2, 64),) * 3, None, False, 0.0,
                           None).name == "flash"
    assert tout[0].shape == (B, S, V) and tout[1].shape == (B, 2)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), **VALUE)
    jl = JCriterion()(jout[0], jout[1], paddle.to_tensor(mlm), paddle.to_tensor(sop))
    tl = ErniePretrainingCriterion()(tout[0], tout[1], torch.from_numpy(mlm),
                                     torch.from_numpy(sop))
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl.numpy()), **VALUE)
    task = np.random.default_rng(63).integers(0, 3, (B, S)).astype(np.int32)
    jtask = jm(paddle.to_tensor(ids), task_type_ids=paddle.to_tensor(task))
    with torch.no_grad():
        ttask = pm(torch.from_numpy(ids), task_type_ids=torch.from_numpy(task))
    for t, j in zip(ttask, jtask):
        np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), **VALUE)
    assert not np.allclose(ttask[0].numpy(), tout[0].numpy())


def test_criterion_matches_paddle_tpu():
    """Loss and the logits' gradients on random logits, with and without
    SOP labels."""
    rng = np.random.default_rng(64)
    logits = (2 * rng.standard_normal((2, 8, 40))).astype(np.float32)
    sop_logits = rng.standard_normal((2, 2)).astype(np.float32)
    mlm = np.where(rng.uniform(size=(2, 8)) < 0.5, rng.integers(0, 40, (2, 8)), -100)
    sop = np.array([0, 1])
    for with_sop in (False, True):
        jx, jn = (paddle.to_tensor(a, stop_gradient=False) for a in (logits, sop_logits))
        jl = JCriterion()(jx, jn, paddle.to_tensor(mlm), paddle.to_tensor(sop) if with_sop else None)
        jl.backward()
        tx, tn = (torch.from_numpy(a).requires_grad_() for a in (logits, sop_logits))
        tl = ErniePretrainingCriterion()(tx, tn, torch.from_numpy(mlm),
                                         torch.from_numpy(sop) if with_sop else None)
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()), **VALUE)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()), **GRAD)
        if with_sop:
            np.testing.assert_allclose(tn.grad.numpy(), np.asarray(jn.grad.numpy()), **GRAD)


def test_train_step_f32_matches_paddle_tpu(jax_flash_interpret):
    """One f32 AdamW step: the loss, every gradient (the reference's by its
    eager backward through the interpreted K2) and the parameters after;
    the port's step runs ``sdpa``/``flash``."""
    jm, pm = _pair(seed=65)
    ids, mlm, sop = _batch(seed=66)
    jin, jlab = paddle.to_tensor(ids), (paddle.to_tensor(mlm), paddle.to_tensor(sop))
    loss = _loss_fn(JCriterion())(jm(jin), *jlab)
    loss.backward()
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    jstep = JTrainStep(jm, paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters()),
                       _loss_fn(JCriterion()))
    jl = float(jstep(jin, jlab)["loss"].numpy())
    tstep = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.parameters()),
                      _loss_fn(ErniePretrainingCriterion()))
    metrics.reset_counters("kernels.sdpa.")
    tl = float(tstep(ids, (mlm, sop))["loss"])
    assert metrics.counters("kernels.sdpa.") == {"kernels.sdpa.picked": 1,
                                                 "kernels.sdpa.fallback": 0}
    np.testing.assert_allclose(tl, jl, **GRAD)
    tgrads = {n: p.grad for n, p in pm.named_parameters()}
    assert set(tgrads) == set(jgrads)
    for n, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n], err_msg=n, **GRAD)
    jparams = {n: np.asarray(jnp.asarray(v, jnp.float32)) for n, v in jstep.state["params"].items()}
    for n, p in pm.state_dict().items():
        signed = np.abs(jgrads[n]) > SIGNED_GRAD
        np.testing.assert_allclose(p.numpy()[signed], jparams[n][signed], err_msg=n,
                                   **PARAMS_AFTER)


def test_train_step_amp_o2_matches_paddle_tpu(jax_flash_interpret, monkeypatch):
    """Two AMP O2 steps: bf16 compute over f32 masters on both sides, K1 on
    bf16 views of the packed projection. The loss before the update and
    the loss after it agree within rtol 2e-3 (half a bf16 rounding, 2**-8:
    the frameworks round activations to bf16 at different places); the
    masters and their gradients stay f32."""
    jm, pm = _pair(seed=67)
    ids, mlm, sop = _batch(seed=68)
    seen = []
    real = fa.flash_attention_fwd

    def spy(q, k, v, causal=False):
        seen.append((q.dtype, causal))
        return real(q, k, v, causal)

    monkeypatch.setattr(fa, "flash_attention_fwd", spy)
    import paddle_tpu_torch.nn.functional.attention as tattention
    monkeypatch.setattr(tattention, "flash_attention_fwd", spy)
    jstep = JTrainStep(jm, paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters()),
                       _loss_fn(JCriterion()), amp_level="O2")
    jargs = paddle.to_tensor(ids), (paddle.to_tensor(mlm), paddle.to_tensor(sop))
    jl = [float(jstep(*jargs)["loss"].numpy()) for _ in range(2)]
    tstep = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.parameters()),
                      _loss_fn(ErniePretrainingCriterion()), amp_level="O2")
    outs = [tstep(ids, (mlm, sop)) for _ in range(2)]
    assert all(out["loss"].dtype == torch.float32 for out in outs)
    np.testing.assert_allclose([float(out["loss"]) for out in outs], jl, rtol=2e-3)
    assert seen == [(torch.bfloat16, False)] * 4  # one call per layer and step
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in pm.parameters())


def _std_close(port, ref):
    """Two tensors drawn from one distribution: means and standard
    deviations within 10% of the larger std (a few hundred draws each)."""
    p, r = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert abs(p.std() - r.std()) <= 0.1 * max(p.std(), r.std()), (p.std(), r.std())
    assert abs(p.mean() - r.mean()) <= 0.1 * max(p.std(), r.std()), (p.mean(), r.mean())


def test_task_type_table_initialiser_matches_paddle_tpu_statistics():
    """The task-type table is drawn Normal(0, 1) on both sides: the
    reference's ``weight_attr=I.Normal(0, initializer_range)`` is ignored,
    so its ``initializer_range`` moves no weight and the port's
    ``ErnieConfig``, like ``BertConfig``, takes none. ``use_task_id=False``
    leaves the table out."""
    cfg = dict(CFG, task_type_vocab_size=64)
    paddle.seed(69)
    jm = JErnie(JErnieConfig.tiny(**cfg))
    ref = np.asarray(jm.state_dict()["ernie.embeddings.task_type_embeddings.weight"].numpy())
    pm = ErnieForPretraining(ErnieConfig.tiny(**cfg), device="cpu", seed=69)
    port = pm.ernie.embeddings.task_type_embeddings.weight.detach().numpy()
    assert port.shape == ref.shape == (64, 128)
    _std_close(port, ref)
    assert abs(port.std() - 1.0) < 0.05
    paddle.seed(69)
    wide = JErnie(JErnieConfig.tiny(**cfg, initializer_range=0.5)).state_dict()
    np.testing.assert_array_equal(
        np.asarray(wide["ernie.embeddings.task_type_embeddings.weight"].numpy()), ref)
    with pytest.raises(TypeError, match="initializer_range"):
        ErnieConfig.tiny(initializer_range=0.02)
    off = ErnieForPretraining(ErnieConfig.tiny(use_task_id=False), device="cpu")
    assert off.ernie.embeddings.task_type_embeddings is None
    assert not any("task_type" in n for n in off.state_dict())


def test_embeddings_extend_berts():
    """ERNIE's embeddings are BERT's plus one table: with the task table
    zeroed, the same weights give BERT's embedding exactly."""
    cfg = ErnieConfig.tiny(**CFG)
    gen = torch.Generator().manual_seed(70)
    ernie = ErnieEmbeddings(cfg, "cpu", gen)
    bert = BertEmbeddings(BertConfig.tiny(**CFG), "cpu", torch.Generator())
    bert.load_state_dict({k: v for k, v in ernie.state_dict().items()
                          if not k.startswith("task_type")})
    with torch.no_grad():
        ernie.task_type_embeddings.weight.zero_()
    ids = torch.from_numpy(_batch(seed=71)[0]).long()
    torch.testing.assert_close(ernie(ids), bert(ids), atol=0, rtol=0)


def test_configs_match_paddle_tpu():
    """``ErnieConfig``'s defaults and ``ernie3_xbase`` (BASELINE config #5's
    trunk: h 3072, 12 layers, 24 heads, FFN 12288) as the reference's."""
    names = ("vocab_size", "hidden_size", "num_layers", "num_heads", "ffn_hidden_size",
             "max_seq_len", "type_vocab_size", "dropout", "task_type_vocab_size", "use_task_id")
    for make in (lambda m: m.ErnieConfig(), lambda m: m.ErnieConfig.ernie3_xbase(vocab_size=40000),
                 lambda m: m.ErnieConfig.tiny(), lambda m: m.ErnieConfig.large()):
        import paddle_tpu.models.ernie as jernie
        import paddle_tpu_torch.models.ernie as ternie
        port, ref = make(ternie), make(jernie)
        assert {n: getattr(port, n) for n in names} == {n: getattr(ref, n) for n in names}
    cfg = ErnieConfig.ernie3_xbase()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.ffn_hidden_size,
            cfg.max_seq_len) == (18000, 3072, 12, 24, 12288, 512)


def test_convert_checks_ernie_names_and_shapes():
    jm, _ = _pair(seed=72)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert set(state_dict_from_paddle_tpu(state)) == set(state)
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_paddle_tpu({k: v for k, v in state.items() if k != "sop.bias"})
    with pytest.raises(KeyError, match="extra"):
        state_dict_from_paddle_tpu({**state, "nsp.bias": state["sop.bias"]})
    with pytest.raises(ValueError, match="task_type"):
        state_dict_from_paddle_tpu({**state, "ernie.embeddings.task_type_embeddings.weight":
                                    state["ernie.embeddings.task_type_embeddings.weight"][:, :64]})
    with pytest.raises(ValueError, match="pooler"):
        state_dict_from_paddle_tpu({**state, "ernie.pooler.weight": state["transform.weight"][:64]})
    paddle.seed(73)
    off = {k: np.asarray(v.numpy())
           for k, v in JErnie(JErnieConfig.tiny(**CFG, use_task_id=False)).state_dict().items()}
    pm = ErnieForPretraining(ErnieConfig.tiny(**CFG, use_task_id=False), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(off))
    assert set(pm.state_dict()) == set(off)


def test_training_with_dropout_raises():
    """Dropout in training is not ported: a training forward with dropout
    raises, an eval forward runs."""
    pm = ErnieForPretraining(ErnieConfig.tiny(dropout=0.1), device="cpu")
    ids = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="dropout"):
        pm(ids)
    pm.eval()
    assert pm(ids)[0].shape == (1, 8, 512)  # tiny: vocab 512

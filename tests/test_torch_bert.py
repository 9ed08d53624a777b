"""BERT pretraining of the port against ``paddle_tpu``'s, on the CPU.

A ``paddle_tpu`` BERT made from a seed is carried across by
``paddle_tpu_torch.utils.convert``; both get the same numpy ids, token
types, positions and additive padding mask ``[2, 1, 256, 256]`` (0 where
key j < len_b, -1e30 elsewhere), with ``FLAGS_flash_flat`` on in both
packages, so masked attention runs ``sdpa``/``flash_flat_gqa``: the
reference's Pallas K3/K3b through the Pallas interpreter (blocks of 128,
which divide 256), the port's plain K3/K3b. The config is
``BertConfig.tiny(hidden_size=128, num_heads=2, max_seq_len=256)`` (d = 64,
two layers). Also here: the one-rank ``mp_layers``, the ``nn.layer``
initialisers and GPT's ``attention_core``/``flash_packed`` route.

Tolerances, f32: gradients atol 2e-5 / rtol 1e-4, the reference's tolerance
for its own kernels (``tests/test_flash_interpret.py``); forward values
atol 1e-5 / rtol 1e-4 (f32 rounding of two post-LN layers, sums in another
order). bf16 (AMP O2) tolerances are stated where they are used.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
from paddle_tpu.distributed import mp_layers as jmp  # noqa: E402
from paddle_tpu.distributed.fleet import fleet as jfleet  # noqa: E402
from paddle_tpu.framework.flags import set_flags as jset_flags  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.models.bert import BertConfig as JBertConfig  # noqa: E402
from paddle_tpu.models.bert import BertForPretraining as JBert  # noqa: E402
from paddle_tpu.models.bert import BertPretrainingCriterion as JCriterion  # noqa: E402
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models.gpt import GPTForPretraining as JGPT  # noqa: E402
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JGPTCriterion  # noqa: E402
from paddle_tpu.observability import metrics as jmetrics  # noqa: E402
from paddle_tpu.ops import flash_attention_flat as jfaf  # noqa: E402
from paddle_tpu.ops import registry as jregistry  # noqa: E402

from paddle_tpu_torch.distributed import mp_layers as tmp  # noqa: E402
from paddle_tpu_torch.framework.flags import set_flags  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,  # noqa: E402
                                          BertPretrainingCriterion)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion  # noqa: E402
from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from paddle_tpu_torch.nn.layer import Embedding, LayerNorm, Linear  # noqa: E402
from paddle_tpu_torch.observability import metrics  # noqa: E402
from paddle_tpu_torch.ops import flash_attention_flat as ff  # noqa: E402
from paddle_tpu_torch.ops import registry  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu  # noqa: E402

CFG = dict(hidden_size=128, num_heads=2, max_seq_len=256)
B, S = 2, 256
LENGTHS = (100, 256)
GRAD = dict(atol=2e-5, rtol=1e-4)
VALUE = dict(atol=1e-5, rtol=1e-4)
LR = 1e-3
# parameters after one AdamW step at lr 1e-3: the first step is about
# lr * sign(g) whatever |g|, so an entry whose gradient sits at the f32 noise
# level of the two sides' sums (e.g. the key part of the qkv bias, whose
# gradient is 0 in exact arithmetic: softmax ignores a constant added to
# every key's score) may land up to 2 lr apart. They are compared where the
# reference's |g| exceeds 1e-4, five times the gradient atol, so that both
# sides' gradients share a sign: there atol 1e-4 / rtol 1e-4
PARAMS_AFTER = dict(atol=1e-4, rtol=1e-4)
SIGNED_GRAD = 1e-4


@pytest.fixture(autouse=True)
def one_device_reference():
    """The reference on one device: a fleet mesh that another test module
    left initialised (``fleet._hcg``) would make its mp_layers shard the
    step, which the port's one-rank layers do not; restored after."""
    prior = jfleet._hcg
    jfleet._hcg = None
    yield
    jfleet._hcg = prior


@pytest.fixture
def flat_on_both():
    """``FLAGS_flash_flat`` on in both packages, the reference's flat Pallas
    kernels interpreted with 128-row blocks; everything restored after."""
    prior = jfaf.set_interpret(True)
    blocks = jfaf.set_blocks(128, 128, 128)
    jset_flags({"FLAGS_flash_flat": True})
    set_flags({"FLAGS_flash_flat": True})
    jregistry.clear_cache()
    registry.clear_cache()
    yield
    jset_flags({"FLAGS_flash_flat": False})
    set_flags({"FLAGS_flash_flat": False})
    jfaf.set_interpret(prior)
    jfaf.set_blocks(*blocks)
    jregistry.clear_cache()
    registry.clear_cache()


def _pair(seed, **kw):
    paddle.seed(seed)
    jm = JBert(JBertConfig.tiny(**CFG, **kw))
    pm = BertForPretraining(BertConfig.tiny(**CFG, **kw), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    return jm, pm


def _batch(seed):
    """ids, token types, positions, the additive padding mask, MLM labels
    (the first 64 tokens, the rest -100) and NSP labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (B, S)).astype(np.int32)
    keep = np.arange(S)[None, None, None, :] < np.asarray(LENGTHS)[:, None, None, None]
    mask = np.broadcast_to(np.where(keep, 0.0, -1e30), (B, 1, S, S)).astype(np.float32)
    mlm = np.full((B, S), -100, np.int32)
    mlm[:, :64] = rng.integers(0, 512, (B, 64))
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    inputs = (ids, np.zeros((B, S), np.int32), np.arange(S, dtype=np.int32), mask)
    return inputs, (mlm, nsp)


def _loss_fn(crit):
    """``TrainStep``'s loss over the model's ``(mlm, nsp)`` logits, as
    ``bench_suite.py`` wraps the criterion."""
    def loss_fn(outs, mlm, nsp):
        return crit(outs[0], outs[1], mlm, nsp)
    return loss_fn


def test_forward_and_criterion_match_paddle_tpu(flat_on_both):
    """Eval forward: MLM and NSP logits, and the criterion on them, through
    ``flash_flat_gqa`` on both sides."""
    jm, pm = _pair(seed=21)
    jm.eval()
    pm.eval()
    inputs, (mlm, nsp) = _batch(seed=22)
    jmetrics.reset_counters("kernels.sdpa.")
    metrics.reset_counters("kernels.sdpa.")
    jout = jm(*(paddle.to_tensor(x) for x in inputs))
    with torch.no_grad():
        tout = pm(*(torch.from_numpy(x) for x in inputs))
    assert jmetrics.counters("kernels.sdpa.").get("kernels.sdpa.picked", 0) >= 1
    assert jmetrics.counters("kernels.sdpa.").get("kernels.sdpa.fallback", 0) == 0
    assert metrics.counters("kernels.sdpa.") == {"kernels.sdpa.picked": 1,
                                                 "kernels.sdpa.fallback": 0}
    assert tout[0].shape == (B, S, 512) and tout[1].shape == (B, 2)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), **VALUE)
    jl = JCriterion()(jout[0], jout[1], paddle.to_tensor(mlm), paddle.to_tensor(nsp))
    tl = BertPretrainingCriterion()(tout[0], tout[1], torch.from_numpy(mlm), torch.from_numpy(nsp))
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl.numpy()), **VALUE)


def test_criterion_matches_paddle_tpu():
    """Loss and logits' gradients on random logits, with and without NSP."""
    rng = np.random.default_rng(23)
    logits = (2 * rng.standard_normal((2, 8, 40))).astype(np.float32)
    nsp_logits = rng.standard_normal((2, 2)).astype(np.float32)
    mlm = np.where(rng.uniform(size=(2, 8)) < 0.4, rng.integers(0, 40, (2, 8)), -100)
    nsp = np.array([1, 0])
    for with_nsp in (False, True):
        jx, jn = (paddle.to_tensor(a, stop_gradient=False) for a in (logits, nsp_logits))
        jl = JCriterion()(jx, jn, paddle.to_tensor(mlm), paddle.to_tensor(nsp) if with_nsp else None)
        jl.backward()
        tx, tn = (torch.from_numpy(a).requires_grad_() for a in (logits, nsp_logits))
        tl = BertPretrainingCriterion()(tx, tn, torch.from_numpy(mlm),
                                        torch.from_numpy(nsp) if with_nsp else None)
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()), **VALUE)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()), **GRAD)
        if with_nsp:
            np.testing.assert_allclose(tn.grad.numpy(), np.asarray(jn.grad.numpy()), **GRAD)


def test_train_step_f32_matches_paddle_tpu(flat_on_both):
    """One f32 AdamW step: the loss, every gradient (the reference's by its
    eager backward through the interpreted K3b) and the parameters after."""
    jm, pm = _pair(seed=24)
    inputs, labels = _batch(seed=25)
    jin = [paddle.to_tensor(x) for x in inputs]
    jlab = [paddle.to_tensor(x) for x in labels]
    jcrit = JCriterion()
    loss = _loss_fn(jcrit)(jm(*jin), *jlab)
    loss.backward()
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    jstep = JTrainStep(jm, paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters()),
                       _loss_fn(jcrit))
    jl = float(jstep(tuple(jin), tuple(jlab))["loss"].numpy())
    tstep = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.parameters()),
                      _loss_fn(BertPretrainingCriterion()))
    before = ff.flash_flat_bwd.launches
    tl = float(tstep(inputs, labels)["loss"])
    assert ff.flash_flat_bwd.launches == before  # the CPU runs the plain K3b
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


def test_train_step_amp_o2_matches_paddle_tpu(flat_on_both, monkeypatch):
    """Two AMP O2 steps: bf16 compute over f32 masters on both sides. The
    float mask rides the inputs and is cast to bf16 with them, as the
    reference's ``_to_amp`` casts it, so K3 gets bf16 q/k/v and a bf16 bias.
    The loss before the update and the loss after it (so the O2 AdamW update
    of the masters too) agree within rtol 2e-3 (half a bf16 rounding, 2**-8:
    the frameworks round activations to bf16 at different places); the
    masters and their gradients stay f32."""
    jm, pm = _pair(seed=26)
    inputs, labels = _batch(seed=27)
    seen = []
    real = ff.flash_flat_gqa

    def spy(q, k, v, causal=False, mask=None):
        seen.append((q.dtype, mask.dtype))
        return real(q, k, v, causal=causal, mask=mask)

    monkeypatch.setattr(ff, "flash_flat_gqa", spy)
    jstep = JTrainStep(jm, paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters()),
                       _loss_fn(JCriterion()), amp_level="O2")
    jin = tuple(paddle.to_tensor(x) for x in inputs), tuple(paddle.to_tensor(x) for x in labels)
    jl = [float(jstep(*jin)["loss"].numpy()) for _ in range(2)]
    tstep = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.parameters()),
                      _loss_fn(BertPretrainingCriterion()), amp_level="O2")
    outs = [tstep(inputs, labels) for _ in range(2)]
    assert all(out["loss"].dtype == torch.float32 for out in outs)
    assert jl[1] < jl[0]
    np.testing.assert_allclose([float(out["loss"]) for out in outs], jl, rtol=2e-3)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 4  # one call per layer and step
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in pm.parameters())


def test_gpt_attention_core_through_flash_packed_matches_paddle_tpu(flat_on_both):
    """GPT's stacked trunk with ``FLAGS_flash_flat`` on: ``attention_core``
    picks ``flash_packed`` on both sides (the reference's packed Pallas
    K3/K3b interpreted). One f32 step: loss and every gradient."""
    paddle.seed(28)
    jcfg = JGPTConfig.tiny(**CFG)
    jm = JGPT(jcfg)
    pm = GPTForPretraining(GPTConfig(**jcfg.to_dict()), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    ids = np.random.default_rng(29).integers(0, 512, (1, S)).astype(np.int32)
    t = paddle.to_tensor(ids)
    loss = JGPTCriterion()(jm(t), t)
    loss.backward()
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    assert jregistry.select("attention_core", jnp.zeros((1, S, 3, 2, 64)), 0.0, None).name == "flash_packed"
    metrics.reset_counters("kernels.attention_core.")
    tl = GPTPretrainingCriterion()(pm(torch.from_numpy(ids)), torch.from_numpy(ids))
    tl.backward()
    assert registry.select("attention_core", torch.zeros(1, S, 3, 2, 64), 0.0, None).name == "flash_packed"
    assert metrics.counters("kernels.attention_core.") == {
        "kernels.attention_core.picked": 1, "kernels.attention_core.fallback": 0}
    np.testing.assert_allclose(float(tl), float(loss.numpy()), **GRAD)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], err_msg=n, **GRAD)


# ------------------------------------------------------- layers and inits


def _std_close(port, ref):
    """Two tensors drawn from one distribution: means and standard
    deviations within 5% of the larger std (some 10^4-10^5 draws each: the
    sampling error is under 1%)."""
    p, r = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert abs(p.std() - r.std()) <= 0.05 * max(p.std(), r.std()), (p.std(), r.std())
    assert abs(p.mean() - r.mean()) <= 0.05 * max(p.std(), r.std()), (p.mean(), r.mean())


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_paddle_tpu(approximate):
    """``nn.functional.gelu`` with the reference's ``approximate`` flag:
    the erf form, or the tanh form BERT's FFN and MLM transform use."""
    x = (3 * np.random.default_rng(34).standard_normal((4, 64))).astype(np.float32)
    want = np.asarray(jF.gelu(paddle.to_tensor(x), approximate=approximate).numpy())
    np.testing.assert_allclose(tF.gelu(torch.from_numpy(x), approximate=approximate).numpy(), want,
                               atol=1e-6, rtol=1e-5)


def test_layer_initialisers_match_paddle_tpu_statistics():
    """``Linear`` (XavierNormal ``[in, out]``, zero bias), ``Embedding``
    (Normal(0, 1)), ``LayerNorm`` (ones, zeros, eps 1e-5) and the
    ``mp_layers`` (XavierNormal; Normal(0, 0.02) for the vocab table), drawn
    from a ``torch.Generator`` on the device given; and the reference's
    effective BERT init (its ``weight_attr`` Normal is ignored, so its
    ``initializer_range`` changes no weight and the port takes none)."""
    paddle.seed(30)
    gen = torch.Generator().manual_seed(30)
    pairs = [(Linear(256, 384, device="cpu", generator=gen), jnn.Linear(256, 384)),
             (Embedding(300, 128, device="cpu", generator=gen), jnn.Embedding(300, 128)),
             (tmp.ColumnParallelLinear(256, 512, device="cpu", generator=gen),
              jmp.ColumnParallelLinear(256, 512)),
             (tmp.RowParallelLinear(512, 128, device="cpu", generator=gen),
              jmp.RowParallelLinear(512, 128)),
             (tmp.VocabParallelEmbedding(1000, 64, device="cpu", generator=gen),
              jmp.VocabParallelEmbedding(1000, 64))]
    for port, ref in pairs:
        assert port.weight.shape == tuple(ref.weight.shape) and port.weight.device.type == "cpu"
        _std_close(port.weight.detach().numpy(), ref.weight.numpy())
        if getattr(ref, "bias", None) is not None:
            np.testing.assert_array_equal(port.bias.detach().numpy(), ref.bias.numpy())
    ln = LayerNorm(96, device="cpu")
    assert ln.epsilon == 1e-5 and bool((ln.weight == 1).all()) and bool((ln.bias == 0).all())
    jm, _ = _pair(seed=31)
    pm = BertForPretraining(BertConfig.tiny(**CFG), device="cpu", seed=31)
    jstate = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for name, p in pm.state_dict().items():
        if p.numel() >= 4096:
            _std_close(p.numpy(), jstate[name])
    # the reference's initializer_range moves no weight, so the port has none
    paddle.seed(31)
    wide = JBert(JBertConfig.tiny(**CFG, initializer_range=0.5)).state_dict()
    for name, v in wide.items():
        np.testing.assert_array_equal(np.asarray(v.numpy()), jstate[name], err_msg=name)
    with pytest.raises(TypeError, match="initializer_range"):
        BertConfig.tiny(initializer_range=0.02)


def test_layers_and_mp_layers_compute_as_paddle_tpu():
    """With the reference's weights: Linear, LayerNorm, the one-rank
    Column/RowParallelLinear and VocabParallelEmbedding, and
    ParallelCrossEntropy (``reduction="none"``, ``ignore_index``) give the
    reference's outputs. Given a model-parallel group of two ranks a layer
    keeps its shard of the whole draw; a width the degree does not divide
    raises."""
    paddle.seed(32)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 5))
    cases = [(jnn.Linear(16, 8), Linear(16, 8, device="cpu"), x),
             (jmp.ColumnParallelLinear(16, 8), tmp.ColumnParallelLinear(16, 8, device="cpu"), x),
             (jmp.RowParallelLinear(16, 8), tmp.RowParallelLinear(16, 8, device="cpu"), x),
             (jnn.LayerNorm(16), LayerNorm(16, device="cpu"), 3 * x + 1),
             (jmp.VocabParallelEmbedding(50, 16), tmp.VocabParallelEmbedding(50, 16, device="cpu"), ids)]
    for ref, port, inp in cases:
        port.load_state_dict({k: torch.from_numpy(np.array(v.numpy()))
                              for k, v in ref.state_dict().items()})
        want = np.asarray(ref(paddle.to_tensor(inp)).numpy())
        got = port(torch.from_numpy(inp)).detach().numpy()
        np.testing.assert_allclose(got, want, **VALUE)
    logits = rng.standard_normal((3, 5, 50)).astype(np.float32)
    labels = np.where(rng.uniform(size=(3, 5)) < 0.3, -100, ids)
    want = np.asarray(jmp.ParallelCrossEntropy()(paddle.to_tensor(logits), paddle.to_tensor(labels)).numpy())
    got = tmp.ParallelCrossEntropy()(torch.from_numpy(logits), torch.from_numpy(labels))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **VALUE)

    class _Group:  # a model-parallel group as the layers read it
        def __init__(self, nranks, rank):
            self.nranks, self.rank = nranks, rank

    # a group of more than one rank: the layer draws the whole weight from the
    # generator and keeps this rank's shard (tests/test_torch_mp_layers.py
    # runs them over gloo ranks); a width the degree does not divide raises
    whole = tmp.ColumnParallelLinear(4, 4, device="cpu", generator=torch.Generator().manual_seed(5))
    shard = tmp.ColumnParallelLinear(4, 4, mp_group=_Group(2, 1), device="cpu",
                                     generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(shard.weight, whole.weight[:, 2:], rtol=0, atol=0)
    assert shard.weight.is_distributed is True and shard.weight.split_axis == 1
    for make in (lambda: tmp.ColumnParallelLinear(4, 6, mp_group=_Group(4, 0), device="cpu"),
                 lambda: tmp.RowParallelLinear(6, 4, mp_group=_Group(4, 0), device="cpu"),
                 lambda: tmp.VocabParallelEmbedding(6, 4, mp_group=_Group(4, 0), device="cpu")):
        with pytest.raises(ValueError, match="does not split"):
            make()


def test_convert_checks_bert_names_and_shapes():
    jm, _ = _pair(seed=33)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert set(state_dict_from_paddle_tpu(state)) == set(state)
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_paddle_tpu({k: v for k, v in state.items() if k != "nsp.bias"})
    with pytest.raises(KeyError, match="extra"):
        state_dict_from_paddle_tpu({**state, "bert.layers.0.moe.w1": state["nsp.weight"]})
    with pytest.raises(ValueError, match="qkv_proj"):
        state_dict_from_paddle_tpu({**state, "bert.layers.1.attn.qkv_proj.weight":
                                    state["bert.layers.1.attn.out_proj.weight"]})


def test_training_with_dropout_raises(monkeypatch):
    """Dropout trains: each training forward draws new masks, an eval
    forward none. In training at a model-parallel degree above 1 it no
    longer raises: every site is replicated over mp, so a rank draws the
    whole masks of the same stream as at mp 1 (the mp 2 parity with the
    reference is in ``tests/test_torch_parallel_dropout.py``)."""
    import paddle_tpu_torch.models.bert as port_bert
    from paddle_tpu_torch.framework import random as R

    pm = BertForPretraining(BertConfig.tiny(dropout=0.1), device="cpu")
    ids = torch.zeros((1, 8), dtype=torch.long)
    assert not torch.equal(pm(ids)[0], pm(ids)[0])
    R.seed(11)
    one = pm(ids)[0]
    monkeypatch.setattr(port_bert, "model_parallel_degree", lambda: 2)
    R.seed(11)
    assert torch.equal(pm(ids)[0], one)
    pm.eval()
    assert pm(ids)[0].shape == (1, 8, 512)

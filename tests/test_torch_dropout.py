"""Dropout of the port against ``paddle_tpu``'s, on the CPU, and the port's
random streams.

Identical random streams across the two packages are not a goal: JAX's
keys and torch's generators give other bits. So both sides get the same
masks: a numpy generator makes one keep mask per draw, in draw order, and
the reference's ``jax.random.bernoulli`` (patched by ``monkeypatch`` in
the test; the package is not edited) and the port's
``nn.functional.common.dropout_mask`` each take the next one. With the
same masks the formulas (both modes, ``axis``, eval, the 2-D/3-D and alpha
dropouts) agree to f32 rounding (atol 1e-6 / rtol 1e-6), and GPT's
per-layer trunk, BERT and ERNIE train to the reference's loss and
gradients (atol 2e-5 / rtol 1e-4, the parity tests' f32 gradient
tolerance). The reference's stacked trunk draws under its own layer loop
with divisions where the per-layer block multiplies; the port's stacked
trunk is held against the port's per-layer trunk with the same masks.

The streams (the port only): keep share within 5 binomial standard
deviations, the same masks for the same name, other masks for another
seed, step, micro-batch, layer, site or rank; a recompute's gradients
bitwise equal to those without it; a step the guard skips redraws its
masks; a resume through ``TrainStep.state`` and through
``CheckpointManager`` bitwise; two gloo ranks at dp 2 draw their own
masks, and at mp 2 both draw the one-process stream's (the worlds at mp,
sep, pp and ep > 1 are in ``tests/test_torch_parallel_dropout.py``).
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
from paddle_tpu.models.bert import BertConfig as JBertConfig  # noqa: E402
from paddle_tpu.models.bert import BertForPretraining as JBert  # noqa: E402
from paddle_tpu.models.bert import BertPretrainingCriterion as JBertCriterion  # noqa: E402
from paddle_tpu.models.ernie import ErnieConfig as JErnieConfig  # noqa: E402
from paddle_tpu.models.ernie import ErnieForPretraining as JErnie  # noqa: E402
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models.gpt import GPTForPretraining as JGPT  # noqa: E402
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JGPTCriterion  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402
from paddle_tpu_torch.distributed.resilience import CheckpointManager  # noqa: E402
from paddle_tpu_torch.framework import random as R  # noqa: E402
from paddle_tpu_torch.framework.flags import flag, set_flags  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,  # noqa: E402
                                          BertPretrainingCriterion)
from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining  # noqa: E402
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion  # noqa: E402
from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from paddle_tpu_torch.nn.functional import common as tcommon  # noqa: E402
from paddle_tpu_torch.observability import metrics  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.testing.dist import run_ranks  # noqa: E402
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu  # noqa: E402

FORMULA = dict(atol=1e-6, rtol=1e-6)
GRAD = dict(atol=2e-5, rtol=1e-4)


class _Masks:
    """One keep mask per draw from a numpy generator: True with the
    probability asked for, in draw order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.shapes = []

    def next(self, shape, keep):
        self.shapes.append(tuple(int(s) for s in shape))
        return self.rng.random(self.shapes[-1]) < keep


@pytest.fixture
def same_masks(monkeypatch):
    """The reference's and the port's draws fed the same masks."""
    ref, port = _Masks(5), _Masks(5)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(ref.next(shape, p)))
    monkeypatch.setattr(tcommon, "dropout_mask", lambda shape, p, generator=None, device=None:
                        torch.from_numpy(port.next(shape, 1.0 - p)).to(device))
    return ref, port


@pytest.fixture
def port_masks(monkeypatch):
    """The port's draws fed masks from a numpy generator (port only)."""
    def install(seed):
        masks = _Masks(seed)
        monkeypatch.setattr(tcommon, "dropout_mask", lambda shape, p, generator=None, device=None:
                            torch.from_numpy(masks.next(shape, 1.0 - p)).to(device))
        return masks
    return install


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- formulas ----------------------------------------------------------------------
FORMULAS = {
    "upscale": lambda F, x: F.dropout(x, p=0.3),
    "upscale_axis": lambda F, x: F.dropout(x, p=0.4, axis=[0, 2]),
    "downscale": lambda F, x: F.dropout(x, p=0.3, mode="downscale_in_infer"),
    "downscale_axis_int": lambda F, x: F.dropout(x, p=0.5, axis=1, mode="downscale_in_infer"),
    "eval_upscale": lambda F, x: F.dropout(x, p=0.3, training=False),
    "eval_downscale": lambda F, x: F.dropout(x, p=0.3, training=False, mode="downscale_in_infer"),
    "p_zero": lambda F, x: F.dropout(x, p=0.0),
    "dropout2d": lambda F, x: F.dropout2d(x, p=0.5),
    "dropout2d_nhwc": lambda F, x: F.dropout2d(x, p=0.5, data_format="NHWC"),
    "dropout3d": lambda F, x: F.dropout3d(x[..., None], p=0.5),
    "alpha": lambda F, x: F.alpha_dropout(x, p=0.2),
    "alpha_eval": lambda F, x: F.alpha_dropout(x, p=0.2, training=False),
}


@pytest.mark.parametrize("case", sorted(FORMULAS))
def test_dropout_formulas_match_reference(same_masks, case):
    x = _x((2, 3, 4, 5), seed=1)
    want = np.asarray(FORMULAS[case](jF, paddle.to_tensor(x)).numpy())
    got = FORMULAS[case](tF, torch.from_numpy(x)).numpy()
    ref, port = same_masks
    assert ref.shapes == port.shapes
    np.testing.assert_allclose(got, want, **FORMULA)


# -- models against the reference ------------------------------------------------------
def _ids(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int64)


def _grads_match(jm, pm, jloss, tloss):
    jloss.backward()
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()), **GRAD)
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], err_msg=n, **GRAD)


def test_gpt_per_layer_trunk_matches_reference_with_same_masks(same_masks):
    """The per-layer trunk with ``dropout`` and ``attn_dropout`` 0.1 in
    training: the embeddings', the attention probabilities' and both
    residuals' masks; the attention takes the ``xla`` composite on both
    sides (dropout)."""
    kw = dict(stacked=False, dropout=0.1, attn_dropout=0.1, num_layers=1)
    paddle.seed(3)
    jm = JGPT(JGPTConfig.tiny(**kw))
    pm = GPTForPretraining(GPTConfig.tiny(**kw), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    ids = _ids((2, 8), 512, seed=4)
    metrics.reset_counters("kernels.sdpa.")
    jl = JGPTCriterion()(jm(paddle.to_tensor(ids)), paddle.to_tensor(ids))
    tl = GPTPretrainingCriterion()(pm(torch.from_numpy(ids)), torch.from_numpy(ids))
    assert metrics.counters("kernels.sdpa.").get("kernels.sdpa.picked", 0) == 0
    ref, port = same_masks
    assert ref.shapes == port.shapes and len(port.shapes) == 1 + 3
    _grads_match(jm, pm, jl, tl)


_STACK_LEAVES = {"norm1_w": "norm1.weight", "norm1_b": "norm1.bias",
                 "qkv_w": "attn.qkv_proj.weight", "qkv_b": "attn.qkv_proj.bias",
                 "out_w": "attn.out_proj.weight", "out_b": "attn.out_proj.bias",
                 "norm2_w": "norm2.weight", "norm2_b": "norm2.bias", "ffn1_w": "ffn1.weight",
                 "ffn1_b": "ffn1.bias", "ffn2_w": "ffn2.weight", "ffn2_b": "ffn2.bias"}


def _to_stacked(per_layer, layers):
    """A per-layer trunk's named tensors under the stacked trunk's names."""
    out = {k: v for k, v in per_layer.items() if not k.startswith("gpt.layers.")}
    for n, leaf in _STACK_LEAVES.items():
        out[f"gpt.layers.{n}"] = torch.stack([per_layer[f"gpt.layers.{i}.{leaf}"]
                                              for i in range(layers)])
    return out


@pytest.mark.parametrize("attn_dropout", [0.0, 0.1])
def test_gpt_stacked_trunk_matches_per_layer_trunk_with_same_masks(port_masks, attn_dropout):
    """The port's stacked trunk (its sites fold layer and site into one key,
    as the reference's) against its per-layer trunk (a key per site), fed
    the same masks in draw order: loss and gradients."""
    kw = dict(dropout=0.1, attn_dropout=attn_dropout, num_layers=2)
    per = GPTForPretraining(GPTConfig.tiny(stacked=False, **kw), device="cpu", seed=5)
    stk = GPTForPretraining(GPTConfig.tiny(**kw), device="cpu")
    stk.load_state_dict(_to_stacked(per.state_dict(), 2))
    ids = torch.from_numpy(_ids((2, 16), 512, seed=6))
    losses, shapes = [], []
    for m in (per, stk):
        masks = port_masks(7)
        loss = GPTPretrainingCriterion()(m(ids), ids)
        loss.backward()
        losses.append(float(loss.detach()))
        shapes.append(masks.shapes)
    assert shapes[0] == shapes[1] and len(shapes[0]) == 1 + (3 if attn_dropout else 2) * 2
    np.testing.assert_allclose(losses[1], losses[0], **GRAD)
    want = _to_stacked({n: p.grad for n, p in per.named_parameters()}, 2)
    for n, p in stk.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), err_msg=n, **GRAD)


ENCODERS = {
    "bert": (JBert, JBertConfig, BertForPretraining, BertConfig, {}),
    "ernie": (JErnie, JErnieConfig, ErnieForPretraining, ErnieConfig, dict(use_task_id=False)),
}


@pytest.mark.parametrize("family", sorted(ENCODERS))
def test_encoder_trains_with_dropout_like_reference(same_masks, family):
    """BERT and ERNIE with dropout 0.1 in training, a padding mask: the
    embeddings' and both residuals' masks per layer (their attention has
    none), the MLM + NSP/SOP loss and every gradient."""
    JM, JC, PM, PC, extra = ENCODERS[family]
    kw = dict(dropout=0.1, num_layers=1, **extra)
    paddle.seed(8)
    jm = JM(JC.tiny(**kw))
    pm = PM(PC.tiny(**kw), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    B, S = 2, 16
    ids = _ids((B, S), 512, seed=9)
    mask = np.where(np.arange(S)[None, None, None, :] < np.array([10, 16])[:, None, None, None],
                    0.0, -1e30).astype(np.float32).repeat(S, axis=2)
    mlm = np.where(np.random.default_rng(10).random((B, S)) < 0.3, ids, -100)
    nsp = np.array([0, 1])
    jout = jm(paddle.to_tensor(ids), attn_mask=paddle.to_tensor(mask))
    jl = JBertCriterion()(jout[0], jout[1], paddle.to_tensor(mlm), paddle.to_tensor(nsp))
    tout = pm(torch.from_numpy(ids), attn_mask=torch.from_numpy(mask))
    tl = BertPretrainingCriterion()(tout[0], tout[1], torch.from_numpy(mlm), torch.from_numpy(nsp))
    ref, port = same_masks
    assert ref.shapes == port.shapes and len(port.shapes) == 1 + 2
    _grads_match(jm, pm, jl, tl)


# -- the streams (the port) --------------------------------------------------------------
def _mask(gen, shape=(64, 256), p=0.1):
    return tcommon.dropout_mask(shape, p, gen, "cpu")


def test_stream_keep_share_names_and_differences():
    """Each site's keep share lies within 5 binomial standard deviations of
    0.9; a name gives the same mask every time; another seed, step,
    micro-batch, layer, site or rank gives another."""
    base = dict(seed=1, step=3, layer=2, site=1, draw=2)
    m = _mask(R.dropout_generator(**base))
    n = m.numel()
    assert abs(float(m.float().mean()) - 0.9) <= 5 * math.sqrt(0.9 * 0.1 / n)
    assert torch.equal(m, _mask(R.dropout_generator(**base)))
    for change in (dict(seed=2), dict(step=4), dict(layer=3), dict(site=2), dict(micro=1),
                   dict(rank=1)):
        assert not torch.equal(m, _mask(R.dropout_generator(**{**base, **change}))), change
    assert R.step_key(1, 3, None, None) != R.step_key(1, 3, 0, None) != R.step_key(1, 3, None, 0)
    # the global stream: seed, state, and split keys
    R.seed(11)
    state = R.get_rng_state()
    a = [R.split_key() for _ in range(3)]
    R.set_rng_state(state)
    assert [R.split_key() for _ in range(3)] == a and len(set(a)) == 3
    with R.rng_scope(5):
        inner = R.split_key()
    assert inner == R.fold_in(5, 1) and R.get_rng_state()[1] == 3


def test_stacked_trunk_draws_from_its_named_stream(monkeypatch):
    """A ``TrainStep`` step of the stacked trunk: the embeddings' mask is
    the step stream's first key, layer l's site s the second key with l
    then s folded in (:func:`dropout_generator`, the trunk being the
    step's second draw)."""
    drawn, real = [], tcommon.dropout_mask

    def recording(shape, p, generator=None, device=None):
        keep = real(shape, p, generator, device)
        drawn.append(keep)
        return keep

    monkeypatch.setattr(tcommon, "dropout_mask", recording)
    pm = GPTForPretraining(GPTConfig.tiny(dropout=0.1, attn_dropout=0.1), device="cpu")
    step = TrainStep(pm, AdamW(parameters=pm.parameters()), GPTPretrainingCriterion(), seed=4)
    ids = torch.from_numpy(_ids((2, 16), 512, seed=12))
    step(ids, ids)
    step(ids, ids)
    per_step = 1 + 3 * 2
    assert len(drawn) == 2 * per_step
    for t in range(2):
        emb = R.generator(R.fold_in(R.step_key(4, t), 1))
        assert torch.equal(drawn[t * per_step], real((2, 16, 64), 0.1, emb, "cpu"))
        for layer in range(2):
            for site, shape in ((0, (2, 4, 16, 16)), (1, (2, 16, 64)), (2, (2, 16, 64))):
                want = real(shape, 0.1, R.dropout_generator(4, t, layer, site, draw=2), "cpu")
                assert torch.equal(drawn[t * per_step + 1 + 3 * layer + site], want)
    assert not torch.equal(drawn[1], drawn[per_step + 1])


def _train(cfg_kw, steps=2, seed=7, **step_kw):
    pm = GPTForPretraining(GPTConfig.tiny(**cfg_kw), device="cpu", seed=3)
    step = TrainStep(pm, AdamW(parameters=pm.parameters()), GPTPretrainingCriterion(), seed=seed,
                     **step_kw)
    ids = torch.from_numpy(_ids((2, 16), 512, seed=13))
    losses = [float(step(ids, ids)["loss"]) for _ in range(steps)]
    return losses, {n: p.detach().clone() for n, p in pm.named_parameters()}, step, ids


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "per_layer"])
@pytest.mark.parametrize("recompute", ["full", "selective", "remat"])
def test_recompute_gradients_are_bitwise(stacked, recompute):
    """With dropout and attention dropout 0.1, a recomputed step (each
    block at either granularity, or ``TrainStep(remat=True)``'s whole
    model call) gives bitwise the losses and parameters of the step
    without recompute: the recompute draws the forward's masks."""
    kw = dict(stacked=stacked, dropout=0.1, attn_dropout=0.1)
    plain = _train(kw, steps=1)
    if recompute == "remat":
        again = _train(kw, steps=1, remat=True)
    else:
        again = _train(dict(kw, recompute=True, recompute_granularity=recompute), steps=1)
    assert again[0] == plain[0]
    for n, p in plain[1].items():
        assert torch.equal(again[1][n], p), n


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "per_layer"])
def test_recompute_does_not_move_the_global_stream(stacked, monkeypatch):
    """Two eager forward and backward passes outside a ``TrainStep``, drawing
    from the global stream: with every block recomputed, the stream stands
    where it stands without recompute after each pass, and the second
    pass's gradients are bitwise those without recompute (its masks the
    same); no mask of the second pass repeats one of the first (a
    recompute that moved the stream back would repeat the first pass's
    later sites)."""
    ids = torch.from_numpy(_ids((2, 16), 512, seed=15))
    real = tcommon.dropout_mask

    def passes(recompute):
        drawn = []
        monkeypatch.setattr(tcommon, "dropout_mask", lambda *a, **k: drawn.append(real(*a, **k))
                            or drawn[-1])
        pm = GPTForPretraining(GPTConfig.tiny(stacked=stacked, dropout=0.1, attn_dropout=0.1,
                                              recompute=recompute), device="cpu", seed=3)
        R.seed(9)
        states, grads, counts = [], [], []
        for _ in range(2):
            pm.zero_grad()
            GPTPretrainingCriterion()(pm(ids), ids).backward()
            states.append(R.get_rng_state())
            grads.append({n: p.grad.clone() for n, p in pm.named_parameters()
                          if p.grad is not None})
            counts.append(len(drawn))
        return states, grads, drawn, counts

    states, grads, drawn, counts = passes(False)
    states_r, grads_r, _, _ = passes(True)
    assert states_r == states
    for n, g in grads[1].items():
        assert torch.equal(grads_r[1][n], g), n
    first, second = drawn[:counts[0]], drawn[counts[0]:]
    assert len(first) == len(second) > 0
    assert not any(a.shape == b.shape and torch.equal(a, b) for a in first for b in second)


def test_guard_skipped_step_redraws_its_masks(port_masks, monkeypatch):
    """A step whose gradients the guard rejects does not advance the
    stream: the next dispatch draws the skipped one's masks again."""
    drawn, real = [], tcommon.dropout_mask
    monkeypatch.setattr(tcommon, "dropout_mask", lambda *a, **k: drawn.append(real(*a, **k))
                        or drawn[-1])
    prior = {k: flag(k) for k in ("FLAGS_chaos", "FLAGS_chaos_nan_at_step")}
    set_flags({"FLAGS_chaos": True, "FLAGS_chaos_nan_at_step": 1})
    try:
        _, _, step, _ = _train(dict(dropout=0.1), steps=3, guard=True)
    finally:
        set_flags(prior)
    assert step.skipped == 1 and step.state["step"] == 2
    per = len(drawn) // 3
    first, skipped, retried = (drawn[i * per:(i + 1) * per] for i in range(3))
    assert all(torch.equal(a, b) for a, b in zip(skipped, retried))
    assert not torch.equal(first[0], skipped[0])


def test_resume_is_bitwise(tmp_path):
    """Two steps, a checkpoint, two more: a new step loaded from the
    step's state, and one restored by ``CheckpointManager``, give bitwise
    the same later losses (the state carries the dropout seed; the step
    count names the stream)."""
    kw = dict(dropout=0.1, attn_dropout=0.1)
    _, _, step, ids = _train(kw, steps=2, seed=21)
    CheckpointManager(str(tmp_path / "ck")).save(step, 2)
    state = {k: v for k, v in step.state.items()}
    state = {k: ({n: t.clone() for n, t in v.items()} if k in ("params", "buffers") else v)
             for k, v in state.items()}
    state["opt"] = {k: {n: t.clone() for n, t in tree.items()} for k, tree in state["opt"].items()}
    later = [float(step(ids, ids)["loss"]) for _ in range(2)]
    for how in ("state", "manager"):
        _, _, fresh, _ = _train(kw, steps=0, seed=0)
        if how == "state":
            fresh.load_state(state)
        else:
            assert CheckpointManager(str(tmp_path / "ck")).restore_latest(target=fresh) is not None
        assert fresh.seed == 21
        assert [float(fresh(ids, ids)["loss"]) for _ in range(2)] == later, how


def test_dp_ranks_draw_their_own_masks_and_mp_raises():
    """Two gloo ranks at dp 2: each rank's embedding mask is its stream's
    first key with its rank folded in, so the ranks' masks differ. At mp 2
    a dropout GPT's training step no longer raises: both ranks draw the
    one-process stream's masks, the whole embedding mask (replicated after
    the vocabulary-parallel reduce) the same on both."""
    ids = _ids((4, 16), 512, seed=14)
    out = run_ranks(ranks.dropout_streams, 2, 6, ids[:2])
    (m0, mp0), (m1, mp1) = out
    assert len(m0) == len(m1) == 1 + 2 * 2
    for r, masks in enumerate((m0, m1)):
        want = tcommon.dropout_mask((2, 16, 64), 0.1,
                                    R.generator(R.fold_in(R.step_key(6, 0, None, r), 1)), "cpu")
        np.testing.assert_array_equal(masks[0], want.numpy())
    assert not np.array_equal(m0[0], m1[0])
    assert len(mp0) == len(mp1) == 1 + 2 * 2
    for a, b in zip(mp0, mp1):
        np.testing.assert_array_equal(a, b)
    whole = tcommon.dropout_mask((2, 16, 64), 0.1,
                                 R.generator(R.fold_in(R.step_key(6, 0, None, None), 1)), "cpu")
    np.testing.assert_array_equal(mp0[0], whole.numpy())

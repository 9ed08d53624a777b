"""The training half of the port against ``paddle_tpu``'s, on the CPU.

Each piece gets the same numpy inputs on both sides: the closed-form
LayerNorm backward, the fused softmax cross entropy, ``AdamWCore``, the
global-norm clip, the warm-up + cosine schedule, ``GPTPretrainingCriterion``
and, end to end, ``TrainStep`` over five steps of a GPT whose weights
``paddle_tpu`` made and ``paddle_tpu_torch.utils.convert`` carried across.

Tolerances, f32: gradients atol 2e-5 / rtol 1e-4, the reference's tolerance
for its own kernel pair (``tests/test_flash_interpret.py``); values of one
formula evaluated on both sides atol 1e-6 / rtol 1e-5 (f32 rounding, sums in
another order). bf16 tolerances are stated where they are used.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops import registry as jregistry
from paddle_tpu.ops.layer_norm import layer_norm_fused as jlayer_norm
from paddle_tpu.optimizer import functional as jFopt
from paddle_tpu.optimizer import lr as jlr

import jax

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.layer_norm import layer_norm_fused
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import functional as Fopt
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu

GRAD = dict(atol=2e-5, rtol=1e-4)
VALUE = dict(atol=1e-6, rtol=1e-5)
# bf16 carries 8 significant bits: one rounding is 2**-8 (0.39%) relative;
# the two sides round the same f32 values, at most one ulp apart
BF16 = dict(atol=1e-2, rtol=1e-2)


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ pieces


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_backward_matches_paddle_tpu(dtype):
    rng = _rng(0)
    x, dy = (rng.standard_normal((3, 5, 64)).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    args = [jnp.asarray(a, jdt) for a in (x, w, b)]
    y_j, vjp = jax.vjp(lambda x, w, b: jlayer_norm(x, w, b, 1e-5), *args)
    want = (y_j,) + vjp(jnp.asarray(dy, jdt))
    leaves = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_() for a in (x, w, b)]
    y = layer_norm_fused(*leaves, 1e-5)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    got = (y,) + tuple(t.grad for t in leaves)
    tol = GRAD if dtype == "float32" else BF16
    for g, w_ in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.detach().float().numpy(), _np(w_), **tol)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_forward_backward_match_paddle_tpu(reduction, weighted):
    """Hard labels with one ``ignore_index`` row, optional class weights;
    the backward of ``sum(loss * g)`` for a random ``g``."""
    rng = _rng(1)
    logits = (3 * rng.standard_normal((6, 4, 50))).astype(np.float32)
    label = rng.integers(0, 50, (6, 4))
    label[2, 1] = -100
    weight = rng.uniform(0.5, 2.0, 50).astype(np.float32) if weighted else None
    g = rng.standard_normal((6, 4)).astype(np.float32) if reduction == "none" else np.float32(1.7)

    x = paddle.to_tensor(logits, stop_gradient=False)
    jl = JF.cross_entropy(x, paddle.to_tensor(label), reduction=reduction,
                          weight=None if weight is None else paddle.to_tensor(weight))
    (jl * paddle.to_tensor(g)).sum().backward()

    t = torch.from_numpy(logits).requires_grad_()
    tl = cross_entropy(t, torch.from_numpy(label), reduction=reduction,
                       weight=None if weight is None else torch.from_numpy(weight))
    (tl * torch.as_tensor(g)).sum().backward()
    assert tl.dtype == torch.float32 and tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl.numpy()), **VALUE)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(x.grad.numpy()), **GRAD)
    assert not t.grad[2, 1].any()  # the ignored row gets no gradient


def test_cross_entropy_bf16_logits_and_unported_branches():
    """bf16 logits (AMP O2): the loss is f32 and the logits' gradient comes
    back in bf16, equal to the reference's to one bf16 rounding, through the
    fused branch and through each non-fused one (soft labels, smoothing,
    probabilities), which were once unported (their f32 cases:
    ``tests/test_torch_amp.py``)."""
    rng = _rng(2)
    logits = (3 * rng.standard_normal((8, 64))).astype(np.float32)
    label = rng.integers(0, 64, 8)
    x = paddle.to_tensor(jnp.asarray(logits, jnp.bfloat16), stop_gradient=False)
    jl = JF.cross_entropy(x, paddle.to_tensor(label))
    jl.backward()
    t = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    tl = cross_entropy(t, torch.from_numpy(label))
    tl.backward()
    assert tl.dtype == torch.float32 and t.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()), **VALUE)
    np.testing.assert_allclose(t.grad.float().numpy(), _np(x.grad.numpy()), **BF16)
    soft = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for kw, lab in ((dict(soft_label=True), soft.astype(np.float32)),
                    (dict(label_smoothing=0.1), label), (dict(use_softmax=False), label)):
        x = paddle.to_tensor(jnp.asarray(soft if "use_softmax" in kw else logits, jnp.bfloat16),
                             stop_gradient=False)
        jl = JF.cross_entropy(x, paddle.to_tensor(lab), **kw)
        jl.backward()
        t = torch.from_numpy(soft if "use_softmax" in kw else logits).to(
            torch.bfloat16).requires_grad_()
        tl = cross_entropy(t, torch.from_numpy(lab), **kw)
        tl.backward()
        assert tl.dtype == torch.float32 and t.grad.dtype == torch.bfloat16, kw
        np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()), **VALUE, err_msg=str(kw))
        np.testing.assert_allclose(t.grad.float().numpy(), _np(x.grad.numpy()), **BF16,
                                   err_msg=str(kw))


@pytest.mark.parametrize("kind", ["Adam", "AdamW"])
def test_adam_cores_match_paddle_tpu(kind):
    """Three updates of three parameters; AdamW with the middle one
    undecayed."""
    rng = _rng(3)
    shapes = [(4, 5), (7,), (2, 3, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    mask = [1.0, 0.0, 1.0]
    if kind == "AdamW":
        jcore = jFopt.AdamWCore(0.9, 0.95, 1e-8, weight_decay=0.1,
                                decay_mask={i: m for i, m in enumerate(mask)})
        tcore = Fopt.AdamWCore(0.9, 0.95, 1e-8, weight_decay=0.1, decay_mask=mask)
    else:
        jcore, tcore = jFopt.AdamCore(0.9, 0.95, 1e-8), Fopt.AdamCore(0.9, 0.95, 1e-8)
    jp = {i: jnp.asarray(p) for i, p in enumerate(params)}
    jstate = jcore.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = tcore.init(tp)
    for step, gs in enumerate(grads):
        jp, jstate = jcore.update({i: jnp.asarray(g) for i, g in enumerate(gs)}, jstate, jp, 1e-2, step)
        tcore.update([torch.from_numpy(g) for g in gs], tstate, tp, 1e-2, step)
    for i in range(3):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[i]), **VALUE)
        np.testing.assert_allclose(tstate["m"][i].numpy(), np.asarray(jstate["m"][i]), **VALUE)
        np.testing.assert_allclose(tstate["v"][i].numpy(), np.asarray(jstate["v"][i]), **VALUE)
        assert tstate["m"][i].dtype == torch.float32


@pytest.mark.parametrize("scale", [0.01, 100.0, float("nan")])
def test_global_norm_clip_matches_paddle_tpu(scale):
    """Below the clip (untouched), above it (scaled), and the NaN pin: a
    non-finite norm turns every clipped gradient into NaN."""
    rng = _rng(4)
    gs = [(scale * rng.standard_normal(s)).astype(np.float32) for s in [(3, 4), (5,)]]
    if np.isnan(scale):
        gs = [rng.standard_normal(g.shape).astype(np.float32) for g in gs]
        gs[1][2] = np.nan
    want = JClip(clip_norm=1.0).apply_tree({i: jnp.asarray(g) for i, g in enumerate(gs)})
    got = ClipGradByGlobalNorm(clip_norm=1.0).apply_list([torch.from_numpy(g) for g in gs])
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[i]), **VALUE)
    if np.isnan(scale):
        assert all(torch.isnan(g).all() for g in got)


def test_warmup_cosine_schedule_matches_paddle_tpu():
    def make(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=20, eta_min=1e-5),
                                warmup_steps=5, start_lr=0.0, end_lr=1e-3)

    jsched, tsched = make(jlr), make(tlr)
    for step in range(30):
        # the reference's lr_at evaluates the schedule in f32
        np.testing.assert_allclose(tsched.lr_at(step), float(jsched.lr_at(jnp.asarray(step))),
                                   rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(tsched(), jsched(), rtol=1e-12)
        jsched.step()
        tsched.step()


@pytest.mark.parametrize("masked", [False, True])
def test_pretraining_criterion_matches_paddle_tpu(masked):
    rng = _rng(5)
    logits = rng.standard_normal((2, 6, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 6))
    mask = (rng.uniform(size=(2, 6)) > 0.3).astype(np.float32) if masked else None
    x = paddle.to_tensor(logits, stop_gradient=False)
    jl = JCriterion()(x, paddle.to_tensor(labels), None if mask is None else paddle.to_tensor(mask))
    jl.backward()
    t = torch.from_numpy(logits).requires_grad_()
    tl = GPTPretrainingCriterion()(t, torch.from_numpy(labels),
                                   None if mask is None else torch.from_numpy(mask))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl.numpy()), **VALUE)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(x.grad.numpy()), **GRAD)
    # GPT-MoE's (logits, aux) input adds aux * moe_aux_coef (0.01), as the
    # reference's criterion does
    aux = np.float32(2.5)
    jl_moe = JCriterion()((paddle.to_tensor(logits), paddle.to_tensor(aux)), paddle.to_tensor(labels),
                          None if mask is None else paddle.to_tensor(mask))
    tl_moe = GPTPretrainingCriterion()((torch.from_numpy(logits), torch.tensor(aux)),
                                       torch.from_numpy(labels),
                                       None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(tl_moe), float(jl_moe.numpy()), **VALUE)


# ------------------------------------------------------------- TrainStep


def _converted_pair(seed, **cfg_kw):
    """A paddle_tpu GPT made from ``seed`` and the port's, on the CPU, with
    its weights carried across by ``utils/convert``."""
    paddle.seed(seed)
    jcfg = JGPTConfig.tiny(**cfg_kw)
    jm = JGPT(jcfg)
    pm = GPTForPretraining(GPTConfig(**jcfg.to_dict()), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    return jm, pm


def _batches(n, shape, vocab, seed):
    rng = _rng(seed)
    return [rng.integers(0, vocab, shape).astype(np.int32) for _ in range(n)]


LR = 1e-3
# parameters after five AdamW steps at lr 1e-3: each step moves a parameter
# by about lr * m_hat / sqrt(v_hat), which is lr * sign(g) at step one
# whatever |g|. Where g is at the f32 noise level of the two sides' sums its
# sign can differ, so such an entry may land up to 2 lr per step apart;
# atol 1e-4 (a tenth of one step) holds where the gradients the update reads
# stand well above that noise, as in these runs (measured on the tiny config:
# 2.1e-5 at most, from entries whose gradients are near 0)
PARAMS_AFTER = dict(atol=1e-4, rtol=1e-4)


def _run_both(jm, pm, batches, amp_level=None):
    """Step-1 gradients of both sides (the reference's by its eager
    backward), then five TrainSteps each; returns (jax losses, port losses,
    jax params, port model)."""
    crit = JCriterion()
    t0 = paddle.to_tensor(batches[0])
    loss = crit(jm(t0), t0)
    loss.backward()
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    jstep = JTrainStep(jm, paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters()),
                       crit, amp_level=amp_level)
    tstep = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.named_parameters()),
                      GPTPretrainingCriterion(), amp_level=amp_level)
    jl, tl, tgrads = [], [], None
    for i, ids in enumerate(batches):
        jl.append(float(jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))["loss"].numpy()))
        out = tstep(ids, ids)
        assert out["loss"].dtype == torch.float32 and out["lr"] == LR
        tl.append(float(out["loss"]))
        if i == 0:
            tgrads = {n: p.grad.clone() for n, p in pm.named_parameters()}
    jparams = {n: np.asarray(jnp.asarray(v, jnp.float32)) for n, v in jstep.state["params"].items()}
    return jgrads, tgrads, jl, tl, jparams


def test_train_step_f32_matches_paddle_tpu():
    """Tiny GPT, f32, five AdamW steps on five batches: step-1 gradients,
    every loss and the parameters after step 5."""
    jm, pm = _converted_pair(seed=11)
    metrics.reset_counters("train_step.")
    jgrads, tgrads, jl, tl, jparams = _run_both(jm, pm, _batches(5, (2, 32), 512, seed=12))
    assert metrics.counters("train_step.") == {"train_step.dispatches": 5, "train_step.steps": 5}
    assert set(tgrads) == set(jgrads)
    for n, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n], err_msg=n, **GRAD)
    np.testing.assert_allclose(tl, jl, **GRAD)
    assert tl[-1] < tl[0]
    for n, p in pm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jparams[n], err_msg=n, **PARAMS_AFTER)


@pytest.fixture
def jax_flash_interpret():
    prior = jfa.set_interpret(True)
    saved = (jfa._BLOCK_Q, jfa._BLOCK_K)
    jfa._BLOCK_Q = jfa._BLOCK_K = 64  # < s: the Pallas kernels stream tiles
    jregistry.clear_cache()
    registry.clear_cache()
    yield
    jfa.set_interpret(prior)
    jfa._BLOCK_Q, jfa._BLOCK_K = saved
    jregistry.clear_cache()
    registry.clear_cache()


def test_train_step_through_flash_matches_paddle_tpu(jax_flash_interpret):
    """hidden 128 / 2 heads (d = 64) at s = 256: the JAX step runs
    ``attention_core``/``flash``, so its backward is the Pallas K2 pair
    (interpreted); the port picks ``attention_core``/``flash`` too (the
    plain K1 and K2 on the CPU)."""
    jm, pm = _converted_pair(seed=13, hidden_size=128, num_heads=2, max_seq_len=256)
    jmetrics.reset_counters("kernels.attention_core.")
    metrics.reset_counters("kernels.attention_core.")
    jgrads, tgrads, jl, tl, jparams = _run_both(jm, pm, _batches(5, (1, 256), 512, seed=14))
    assert jmetrics.counters("kernels.attention_core.").get("kernels.attention_core.picked", 0) >= 1
    assert jmetrics.counters("kernels.attention_core.").get("kernels.attention_core.fallback", 0) == 0
    assert metrics.counters("kernels.attention_core.") == {
        "kernels.attention_core.picked": 1, "kernels.attention_core.fallback": 0}
    for n, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n], err_msg=n, **GRAD)
    np.testing.assert_allclose(tl, jl, **GRAD)
    for n, p in pm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jparams[n], err_msg=n, **PARAMS_AFTER)


def test_train_step_amp_o2_matches_paddle_tpu():
    """AMP O2 on the tiny GPT: bf16 compute over f32 masters on both sides.
    The losses agree within rtol 2e-3 (half a bf16 rounding, 2**-8): the
    two frameworks round activations to bf16 at different places (XLA keeps
    fused bias adds and activations in f32 inside one kernel, PyTorch rounds
    after each op), which moves the mean loss by far less than one rounding
    (measured: 4.5e-5 relative). The masters and their gradients stay f32."""
    jm, pm = _converted_pair(seed=15)
    _, tgrads, jl, tl, _ = _run_both(jm, pm, _batches(5, (2, 32), 512, seed=16), amp_level="O2")
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert tl[-1] < tl[0]
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert all(g.dtype == torch.float32 for g in tgrads.values())


class _RunningSum(torch.nn.Module):
    """A linear layer whose f32 buffers are updated in place in forward: a
    call count and the running sum of its inputs (small integers, exact in
    bf16, so an O2 step and an f32 step add the same values)."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 3)
        self.register_buffer("calls", torch.zeros(()))
        self.register_buffer("seen", torch.zeros(4))

    def forward(self, x):
        self.calls.add_(1.0)
        self.seen.add_(x.detach().float().sum(0))
        return self.lin(x)


def test_o2_keeps_in_place_buffer_updates():
    """Under O2 the parameters run as bf16 casts, but the buffers run as
    they are: forward's in-place updates survive the step, in f32, exactly
    as in an f32 step."""
    x = torch.from_numpy(_rng(41).integers(-3, 4, (5, 4)).astype(np.float32))
    y = torch.zeros(5, 3)
    buffers = {}
    for amp in (None, "O2"):
        torch.manual_seed(0)
        model = _RunningSum()
        step = TrainStep(model, AdamW(learning_rate=1e-3, parameters=model.parameters()),
                         lambda out, t: ((out.float() - t) ** 2).mean(), amp_level=amp)
        step(x, y)
        step(x, y)
        buffers[amp] = {n: b.clone() for n, b in model.named_buffers()}
        assert all(b.dtype == torch.float32 for b in model.buffers()), amp
    assert float(buffers["O2"]["calls"]) == 2.0
    for n, b in buffers[None].items():
        torch.testing.assert_close(buffers["O2"][n], b, atol=0, rtol=0)
    torch.testing.assert_close(buffers["O2"]["seen"], 2 * x.sum(0), atol=0, rtol=0)


def test_run_steps_equals_single_steps_and_stacks():
    _, pm = _converted_pair(seed=17)
    _, pm2 = _converted_pair(seed=17)
    batches = _batches(3, (2, 16), 512, seed=18)
    a = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.parameters()), GPTPretrainingCriterion())
    b = TrainStep(pm2, AdamW(learning_rate=LR, parameters=pm2.parameters()), GPTPretrainingCriterion())
    single = [float(a(ids, ids)["loss"]) for ids in batches]
    stacked = np.stack(batches[:2])
    out = b.run_steps((stacked, stacked), k=2)  # pre-stacked [k, ...] leaves
    assert out["loss"].shape == (2,) and out["lr"].shape == (2,)
    out3 = b.run_steps([(batches[2], batches[2])])  # a list of per-step batches
    np.testing.assert_array_equal(torch.cat([out["loss"], out3["loss"]]).numpy(),
                                  np.asarray(single, np.float32))
    with pytest.raises(ValueError, match="leading dim"):
        b.run_steps((stacked, stacked), k=3)


@pytest.mark.parametrize("kw", [dict(batch_shardings={}), dict(state_shardings={}), dict(guard=True),
                                dict(amp_level="O1"), dict(amp_level="O2", amp_dtype="float16")])
def test_unported_train_step_knobs_raise(kw):
    """Each of these knobs was once unported: the state and batch
    shardings (ZeRO's stage, the batch's axes) need the fleet's grid as
    ``mesh``; ``guard`` reports health (its parity is
    ``tests/test_torch_stability.py``); O1 runs a step (its parity is
    ``tests/test_torch_amp.py``); float16 raises ``ValueError`` as the
    reference's step does, its loss scaling being the eager path's."""
    pm = GPTForPretraining(GPTConfig.tiny(), device="cpu")
    if "batch_shardings" in kw or "state_shardings" in kw:
        with pytest.raises(ValueError, match="need a mesh"):
            TrainStep(pm, AdamW(parameters=pm.parameters()), GPTPretrainingCriterion(), **kw)
    elif kw.get("guard"):
        step = TrainStep(pm, AdamW(parameters=pm.parameters()), GPTPretrainingCriterion(), **kw)
        ids = np.zeros((2, 8), np.int64)
        assert step.guard and not bool(step(ids, ids)["health"]["bad_step"])
    elif kw.get("amp_level") == "O1":
        step = TrainStep(pm, AdamW(parameters=pm.parameters()), GPTPretrainingCriterion(), **kw)
        ids = np.zeros((2, 8), np.int64)
        assert np.isfinite(float(step(ids, ids)["loss"]))
        assert all(p.dtype == torch.float32 for p in pm.parameters())
    else:
        with pytest.raises(ValueError, match="GradScaler"):
            TrainStep(pm, AdamW(parameters=pm.parameters()), GPTPretrainingCriterion(), **kw)
    with pytest.raises(ValueError, match="amp_level"):
        TrainStep(pm, AdamW(parameters=pm.parameters()), GPTPretrainingCriterion(), amp_level="O3")
    # a mesh is the fleet's grid (tests/test_torch_dist_step.py), nothing else
    with pytest.raises(TypeError, match="HybridCommunicateGroup"):
        TrainStep(pm, AdamW(parameters=pm.parameters()), GPTPretrainingCriterion(), mesh=object())


def test_training_with_dropout_raises():
    """Dropout trains through ``TrainStep``; a pipeline stage's trunk no
    longer raises: it folds its layers' global indices, so a trunk whose
    first layer is layer 2 (stage 1 of 2 over 4 layers) draws other masks
    than the first stage's from the same stream (the pipeline worlds are in
    ``tests/test_torch_parallel_dropout.py``)."""
    from paddle_tpu_torch.framework import random as R

    pm = GPTForPretraining(GPTConfig.tiny(dropout=0.1), device="cpu")
    step = TrainStep(pm, AdamW(parameters=pm.parameters()), GPTPretrainingCriterion())
    ids = _batches(1, (1, 8), 512, seed=19)[0]
    assert np.isfinite(float(step(ids, ids)["loss"]))
    pm.gpt.layers.pp = 2  # as a pipeline stage's trunk sees its grid
    assert np.isfinite(float(step(ids, ids)["loss"]))

    def hidden(first_layer):
        pm.gpt.layers.first_layer = first_layer
        R.seed(5)
        return pm.gpt(torch.as_tensor(ids))

    assert torch.equal(hidden(0), hidden(0))
    assert not torch.equal(hidden(2), hidden(0))
    pm.gpt.layers.first_layer = 0


def test_adamw_decay_mask_by_name_in_train_step_and_step():
    """``apply_decay_param_fun`` picks by name which parameters decay, in
    ``TrainStep`` and in ``step()`` alike. With zero gradients only the
    decay moves a parameter: by the factor ``1 - lr * weight_decay``."""
    for use_train_step in (True, False):
        torch.manual_seed(0)
        lin = torch.nn.Linear(4, 4)
        w0, b0 = lin.weight.detach().clone(), lin.bias.detach().clone()
        opt = AdamW(learning_rate=0.1, weight_decay=0.5, parameters=lin.named_parameters(),
                    apply_decay_param_fun=lambda name: name == "bias")
        x = torch.ones(2, 4)
        if use_train_step:
            TrainStep(lin, opt, lambda out, y: (out * 0).sum())(x, x)
        else:
            (lin(x) * 0).sum().backward()
            opt.step()
        torch.testing.assert_close(lin.weight.detach(), w0, atol=0, rtol=0)
        torch.testing.assert_close(lin.bias.detach(), b0 * (1 - 0.1 * 0.5))


def test_optimizer_state_dict_round_trip():
    """Two steps, then the state moves to a fresh optimizer over a copy of
    the parameters: the third step is the same on both."""
    rng = _rng(20)
    p = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)).requires_grad_()
    grads = [torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)) for _ in range(3)]
    sched = tlr.LinearWarmup(1e-2, warmup_steps=2, start_lr=0.0, end_lr=1e-2)
    opt = AdamW(learning_rate=sched, parameters=[p])
    for g in grads[:2]:
        p.grad = g
        opt.step()
        sched.step()
    state = opt.state_dict()
    assert state["step"] == 2 and set(state) == {"step", "m.0", "v.0", "LR_Scheduler"}
    q = p.detach().clone().requires_grad_()
    sched2 = tlr.LinearWarmup(1e-2, warmup_steps=2, start_lr=0.0, end_lr=1e-2)
    opt2 = AdamW(learning_rate=sched2, parameters=[q])
    opt2.set_state_dict(state)
    assert opt2.get_lr() == opt.get_lr() == 1e-2
    for param, o in ((p, opt), (q, opt2)):
        param.grad = grads[2]
        o.step()
    torch.testing.assert_close(q, p, atol=0, rtol=0)


# ------------------------------------------- accumulation, return_outputs


def test_microbatch_is_the_references_strided_split():
    """Micro-batch i holds rows ``i::k``, as in the reference; unmicrobatch
    inverts it; a batch that k does not divide raises."""
    from paddle_tpu.distributed.pipeline import microbatch as jmicro
    from paddle_tpu.distributed.pipeline import unmicrobatch as junmicro

    from paddle_tpu_torch.distributed.pipeline import microbatch, unmicrobatch

    x = _rng(42).standard_normal((6, 3, 2)).astype(np.float32)
    for k in (1, 2, 3, 6):
        got = microbatch(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jmicro(jnp.asarray(x), k)))
        np.testing.assert_array_equal(got[1 % k].numpy(), x[1 % k::k])
        np.testing.assert_array_equal(unmicrobatch(got).numpy(),
                                      np.asarray(junmicro(jmicro(jnp.asarray(x), k))))
    with pytest.raises(ValueError, match="divisible"):
        microbatch(torch.from_numpy(x), 4)


def _accumulated_pair(seed, **cfg_kw):
    """The reference's tiny GPT from ``seed`` and the port's with its
    weights, GShard's random routing off on both sides' MoE layers."""
    paddle.seed(seed)
    jm = JGPT(JGPTConfig.tiny(**cfg_kw))
    pm = GPTForPretraining(GPTConfig.tiny(**cfg_kw), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    if cfg_kw.get("moe"):
        for j, t in zip(jm.gpt.layers, pm.gpt.layers):
            j.moe.gate.random_routing = t.moe.gate.random_routing = False
    return jm, pm


@pytest.mark.parametrize("cfg_kw", [dict(), dict(moe=4, moe_every=1)], ids=["dense", "moe"])
def test_accumulate_steps_matches_paddle_tpu(cfg_kw):
    """``accumulate_steps=2`` on both sides, three AdamW steps of ids
    ``[4, 32]``: every loss (the mean of the two micro-batch losses; with
    MoE, each micro-batch routes under its own capacity) and the parameters
    after, within the tolerances of ``test_train_step_f32_matches_paddle_tpu``."""
    jm, pm = _accumulated_pair(seed=43, **cfg_kw)
    batches = _batches(3, (4, 32), 512, seed=44)
    jstep = JTrainStep(jm, paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters()),
                       JCriterion(), accumulate_steps=2)
    tstep = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.parameters()),
                      GPTPretrainingCriterion(), accumulate_steps=2)
    jl = [float(jstep(paddle.to_tensor(b), paddle.to_tensor(b))["loss"].numpy()) for b in batches]
    tl = [float(tstep(b, b)["loss"]) for b in batches]
    np.testing.assert_allclose(tl, jl, **GRAD)
    assert tl[-1] < tl[0]
    jparams = {n: np.asarray(jnp.asarray(v, jnp.float32)) for n, v in jstep.state["params"].items()}
    for n, p in pm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jparams[n], err_msg=n, **PARAMS_AFTER)


def test_accumulated_gradients_are_the_batch_mean():
    """Dense GPT: a token mean over equal token counts, so the gradients
    averaged over two micro-batches are the whole batch's (the reference's
    eager ones), the loss its loss, and a global-norm clip sees the
    average."""
    jm, pm = _accumulated_pair(seed=45)
    ids = _batches(1, (4, 32), 512, seed=46)[0]
    t = paddle.to_tensor(ids)
    jloss = JCriterion()(jm(t), t)
    jloss.backward()
    clip = ClipGradByGlobalNorm(clip_norm=1e-3)
    seen = []
    real = clip.apply_list

    def spy(grads):
        seen.append(float(torch.sqrt(sum((g * g).sum() for g in grads))))
        return real(grads)

    clip.apply_list = spy
    step = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.parameters(), grad_clip=clip),
                     GPTPretrainingCriterion(), accumulate_steps=2)
    loss = float(step(ids, ids)["loss"])
    np.testing.assert_allclose(loss, float(jloss.numpy()), **VALUE)
    norm = 0.0
    for n, p in jm.named_parameters():
        g = np.asarray(p.grad.numpy())
        np.testing.assert_allclose(dict(pm.named_parameters())[n].grad.numpy(), g, err_msg=n, **GRAD)
        norm += float((g.astype(np.float64) ** 2).sum())
    np.testing.assert_allclose(seen, [np.sqrt(norm)], rtol=1e-5)


@pytest.mark.parametrize("k", [1, 2])
def test_return_outputs_match_paddle_tpu_in_batch_order(k):
    """``return_outputs``: the step's logits (before its update), in batch
    order under accumulation, equal the reference's and the port's own
    forward of the whole batch."""
    jm, pm = _accumulated_pair(seed=47)
    ids = _batches(1, (4, 32), 512, seed=48)[0]
    with torch.no_grad():
        want = pm(torch.from_numpy(ids).long())
    jout = JTrainStep(jm, paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters()),
                      JCriterion(), accumulate_steps=k, return_outputs=True)(
        paddle.to_tensor(ids), paddle.to_tensor(ids))["outputs"]
    step = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.parameters()),
                     GPTPretrainingCriterion(), accumulate_steps=k, return_outputs=True)
    out = step(ids, ids)["outputs"]
    assert out.shape == (4, 32, 512) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(jout.numpy()), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    assert "outputs" not in TrainStep(pm, AdamW(parameters=pm.parameters()),
                                      GPTPretrainingCriterion())(ids, ids)


def test_return_outputs_of_moe_and_run_steps():
    """GPT-MoE's ``(logits, aux)`` under accumulation: the logits in batch
    order, the aux loss one per micro-batch; ``run_steps`` stacks the
    outputs of its steps."""
    pm = GPTForPretraining(GPTConfig.tiny(moe=4, moe_every=1), device="cpu")
    ids = _batches(1, (4, 16), 512, seed=49)[0]
    step = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.parameters()),
                     GPTPretrainingCriterion(), accumulate_steps=2, return_outputs=True)
    logits, aux = step(ids, ids)["outputs"]
    assert logits.shape == (4, 16, 512) and aux.shape == (2,)
    out = step.run_steps([(ids, ids)] * 3)
    assert out["outputs"][0].shape == (3, 4, 16, 512) and out["outputs"][1].shape == (3, 2)
    with pytest.raises(ValueError, match="accumulate_steps"):
        TrainStep(pm, AdamW(parameters=pm.parameters()), GPTPretrainingCriterion(),
                  accumulate_steps=0)

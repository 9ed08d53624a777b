"""Activation recompute of the port (``paddle_tpu_torch.distributed.recompute``)
against ``paddle_tpu``'s, and against itself without recompute, on the CPU.

A tiny GPT made by ``paddle_tpu`` from a seed is carried across by
``paddle_tpu_torch.utils.convert``; both packages get the same numpy ids.
Against the reference: one f32 step with ``GPTConfig(recompute=True)`` at
both granularities, on the stacked and the per-layer trunk and on GPT-MoE
(GShard's random routing off on both sides' instances: the reference draws
from threefry, the port from the layer's generator), and
``TrainStep(remat=True)`` / ``FLAGS_remat_policy``: the loss, the step-1
gradients (the reference's by its eager backward, which recompute does not
change) and the parameters after the step (the reference's through its
compiled step, which runs ``jax.checkpoint``).

Against the port without recompute, from the same weights: GPT-MoE with
GShard's jitter ON, drawn from the same generator seed, so the recompute
must replay the forward's draws; and a net with batch norms, whose running
statistics the recompute must not move a second time.

Tolerances, f32: gradients atol 2e-5 / rtol 1e-4 (as
``tests/test_torch_train.py``); the loss rtol 1e-5; the parameters after
one AdamW step atol 1e-4 / rtol 1e-4 where the reference's gradient is
above 1e-4, as in ``tests/test_torch_bert.py`` (the first step moves a
parameter by about lr * sign(g), so an entry whose gradient sits at the
f32 noise of the two sides' sums may land 2 lr apart). The port with
recompute against itself without: rtol 1e-6, atol 1e-7 (the same ops on
the same data; only a sum's order may differ).
"""
import contextlib
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion

from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.distributed import recompute as trecompute
from paddle_tpu_torch.framework.flags import flag, set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
from paddle_tpu_torch.nn import layer as L
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu

# the module (``paddle_tpu.distributed`` exports its ``recompute`` function
# under the same name)
jrecompute = importlib.import_module("paddle_tpu.distributed.recompute")

GRAD = dict(atol=2e-5, rtol=1e-4)
LOSS = dict(rtol=1e-5)
PARAMS_AFTER = dict(atol=1e-4, rtol=1e-4)
SIGNED_GRAD = 1e-4
SAME = dict(atol=1e-7, rtol=1e-6)
LR = 1e-3

TRUNKS = {"stacked": dict(), "per_layer": dict(stacked=False), "moe": dict(moe=4, moe_every=1)}


def _pair(seed, port_kw=(), **cfg_kw):
    """The reference's tiny GPT from ``seed`` and the port's with its
    weights (random routing off on both sides' MoE layers); ``port_kw``
    adds config on the port's side only."""
    paddle.seed(seed)
    jm = JGPT(JGPTConfig.tiny(**cfg_kw))
    pm = GPTForPretraining(GPTConfig.tiny(**cfg_kw, **dict(port_kw)), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    if not pm.gpt.cfg.stacked:
        for j, t in zip(jm.gpt.layers, pm.gpt.layers):
            if j.moe is not None:
                j.moe.gate.random_routing = t.moe.gate.random_routing = False
    return jm, pm


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _one_step_against_reference(jm, pm, ids, **step_kw):
    """One f32 AdamW step on both sides (``step_kw`` on the port's side
    only): the loss, the port's gradients against the reference's eager
    ones, and the parameters after."""
    t = paddle.to_tensor(ids)
    jloss = JCriterion()(jm(t), t)
    jloss.backward()
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    jstep = JTrainStep(jm, paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters()),
                       JCriterion())
    jl = float(jstep(t, t)["loss"].numpy())
    tstep = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.parameters()),
                      GPTPretrainingCriterion(), **step_kw)
    tl = float(tstep(ids, ids)["loss"])
    np.testing.assert_allclose(tl, jl, **LOSS)
    np.testing.assert_allclose(tl, float(jloss.numpy()), **LOSS)
    tgrads = {n: p.grad for n, p in pm.named_parameters()}
    assert set(tgrads) == set(jgrads)
    for n, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n], err_msg=n, **GRAD)
    jparams = {n: np.asarray(jnp.asarray(v, jnp.float32)) for n, v in jstep.state["params"].items()}
    for n, p in pm.state_dict().items():
        signed = np.abs(jgrads[n]) > SIGNED_GRAD
        np.testing.assert_allclose(p.numpy()[signed], jparams[n][signed], err_msg=n,
                                   **PARAMS_AFTER)


@pytest.mark.parametrize("granularity", ["full", "selective"])
@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_recompute_step_matches_paddle_tpu(trunk, granularity):
    """The same config on both sides; for GPT-MoE the reference runs
    without recompute, as its compiled step cannot take a MoE block under
    ``jax.checkpoint`` (the gate's aux loss, kept on the layer, leaks the
    checkpoint's tracer: ``UnexpectedTracerError``; ROADMAP.md, Queue 3)."""
    remat = dict(recompute=True, recompute_granularity=granularity)
    if trunk == "moe":
        jm, pm = _pair(seed=41, port_kw=remat, **TRUNKS[trunk])
    else:
        jm, pm = _pair(seed=41, **remat, **TRUNKS[trunk])
    assert (pm.gpt.cfg.recompute, pm.gpt.cfg.recompute_granularity) == (True, granularity)
    _one_step_against_reference(jm, pm, _ids((2, 32), seed=42))


def test_remat_train_step_matches_paddle_tpu():
    """``TrainStep(remat=True)``: the whole model call and loss recomputed
    on the port's side, against the reference's step without it (its
    ``remat=True`` step raises ``UnexpectedTracerError``: the fused cross
    entropy's saved residual leaks out of ``jax.checkpoint``; ROADMAP.md,
    Queue 3)."""
    jm, pm = _pair(seed=43)
    _one_step_against_reference(jm, pm, _ids((2, 32), seed=44), remat=True)


@pytest.fixture
def remat_policy_flag():
    """``FLAGS_remat_policy`` set in the port's registry, restored after."""
    prior = flag("FLAGS_remat_policy")
    set_flags({"FLAGS_remat_policy": "dots_saveable"})
    yield
    set_flags({"FLAGS_remat_policy": prior})


def test_remat_policy_flag_turns_remat_on(remat_policy_flag):
    """Any ``FLAGS_remat_policy`` but ``"none"`` turns remat on, as in the
    reference (``paddle_tpu/jit/__init__.py:132``); the step stays the
    reference's."""
    jm, pm = _pair(seed=45)
    step = TrainStep(pm, AdamW(parameters=pm.parameters()), GPTPretrainingCriterion())
    assert step.remat is True
    _one_step_against_reference(jm, pm, _ids((2, 32), seed=46))


def test_remat_off_by_default():
    pm = GPTForPretraining(GPTConfig.tiny(), device="cpu")
    assert flag("FLAGS_remat_policy") == "none"
    assert TrainStep(pm, AdamW(parameters=pm.parameters()), GPTPretrainingCriterion()).remat is False


# ------------------------------------------------- the port against itself


def _port_step(cfg_kw, ids, seed=47, **step_kw):
    """One f32 step of a fresh port GPT from ``seed``: ``(loss, grads,
    model)``. GShard's jitter stays on: each MoE layer's generator is
    seeded alike in every fresh model."""
    pm = GPTForPretraining(GPTConfig.tiny(**cfg_kw), device="cpu", seed=seed)
    step = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.parameters()),
                     GPTPretrainingCriterion(), **step_kw)
    loss = float(step(ids, ids)["loss"])
    return loss, {n: p.grad.clone() for n, p in pm.named_parameters()}, pm


@pytest.mark.parametrize("granularity", ["full", "selective", "remat"])
@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_recompute_equals_no_recompute(trunk, granularity):
    """From the same weights (and, for GPT-MoE, the same jitter seeds) a
    step with recompute equals one without; the MoE generators end where
    the run without recompute left them."""
    ids = _ids((4, 32), seed=48)
    loss, grads, pm = _port_step(TRUNKS[trunk], ids)
    if granularity == "remat":
        loss_r, grads_r, pm_r = _port_step(TRUNKS[trunk], ids, remat=True)
    else:
        loss_r, grads_r, pm_r = _port_step(
            dict(TRUNKS[trunk], recompute=True, recompute_granularity=granularity), ids)
    np.testing.assert_allclose(loss_r, loss, **SAME)
    assert set(grads_r) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(grads_r[n].numpy(), g.numpy(), err_msg=n, **SAME)
    states = [[m.generator.get_state() for m in model.modules() if isinstance(m, tmoe.MoELayer)]
              for model in (pm, pm_r)]
    assert len(states[0]) == (2 if trunk == "moe" else 0)
    assert all(torch.equal(a, b) for a, b in zip(*states))


def test_recompute_without_routing_replay_would_route_differently(monkeypatch):
    """The check above has teeth: with the routing replay switched off, the
    recompute draws new jitter and the gradients move."""
    ids = _ids((4, 32), seed=48)
    _, grads, _ = _port_step(TRUNKS["moe"], ids)
    monkeypatch.setattr(trecompute, "routing_replay",
                        lambda module: (contextlib.nullcontext(), contextlib.nullcontext()))
    _, grads_r, _ = _port_step(dict(TRUNKS["moe"], recompute=True), ids)
    worst = max(float((grads_r[n] - g).norm() / g.norm()) for n, g in grads.items() if g.norm() > 0)
    assert worst > 1e-3


def _bn_step(remat, amp_level, seed=52):
    """One AdamW step of a small net with two ``BatchNorm2D`` from fresh
    weights drawn from ``seed``: ``(loss, grads, running buffers)``."""
    gen = torch.Generator().manual_seed(seed)
    d = dict(device="cpu", generator=gen)
    model = torch.nn.Sequential(L.Conv2D(2, 4, 3, padding=1, **d), L.BatchNorm2D(4, device="cpu"),
                                L.ReLU(), L.Conv2D(4, 4, 3, stride=2, **d),
                                L.BatchNorm2D(4, device="cpu"), L.ReLU(), L.AdaptiveAvgPool2D(1),
                                torch.nn.Flatten(), L.Linear(4, 5, **d))
    x = torch.randn(6, 2, 9, 9, generator=gen)
    y = torch.randint(0, 5, (6,), generator=gen)
    step = TrainStep(model, AdamW(learning_rate=LR, parameters=model.parameters()),
                     L.CrossEntropyLoss(), remat=remat, amp_level=amp_level)
    loss = float(step(x, y)["loss"])
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss, grads, {n: b.clone() for n, b in model.named_buffers()}


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("amp_level", [None, "O2"])
def test_remat_keeps_batch_norm_statistics(amp_level, early_stop):
    """``TrainStep(remat=True)`` replays the forward, batch norms and all,
    in the backward; the running statistics still move once per step, to
    the last bit where they move without recompute, and the loss and the
    gradients are those of the step without it. With the checkpoint's
    early stop on (torch's default: the recompute ends once the backward
    has what it needs) and off."""
    loss, grads, buffers = _bn_step(False, amp_level)
    with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
        loss_r, grads_r, buffers_r = _bn_step(True, amp_level)
    assert set(buffers) == {"1._mean", "1._variance", "4._mean", "4._variance"}
    for n, b in buffers.items():
        assert b.dtype == torch.float32 and not torch.equal(b, torch.zeros_like(b)), n
        assert torch.equal(buffers_r[n], b), n
    np.testing.assert_allclose(loss_r, loss, **SAME)
    for n, g in grads.items():
        np.testing.assert_allclose(grads_r[n].numpy(), g.numpy(), err_msg=n, **SAME)


def test_recompute_without_buffer_replay_would_update_twice(monkeypatch):
    """The check above has teeth: with the buffer replay switched off, the
    recompute's forward moves each running statistic a second time."""
    _, _, buffers = _bn_step(False, None)
    monkeypatch.setattr(trecompute, "buffer_replay",
                        lambda module: (contextlib.nullcontext(), contextlib.nullcontext()))
    _, _, buffers_r = _bn_step(True, None)
    assert not torch.equal(buffers_r["1._mean"], buffers["1._mean"])
    # a second EMA step from the first: 0.9 m1 + 0.1 m, where m1 = 0.1 m
    torch.testing.assert_close(buffers_r["1._mean"], 1.9 * buffers["1._mean"], rtol=1e-5, atol=1e-7)


def test_recompute_keeps_the_aux_loss_the_criterion_read():
    """The recompute puts back each MoE layer's ``aux_loss``: after the
    backward it is still the tensor of the forward, in the graph."""
    pm = GPTForPretraining(GPTConfig.tiny(moe=4, moe_every=1, recompute=True), device="cpu")
    ids = torch.from_numpy(_ids((2, 16), seed=49)).long()
    out = pm(ids)
    layers = [m for m in pm.modules() if isinstance(m, tmoe.MoELayer)]
    seen = [m.aux_loss for m in layers]
    assert all(a.requires_grad for a in seen)
    GPTPretrainingCriterion()(out, ids).backward()
    assert all(m.aux_loss is a for m, a in zip(layers, seen))
    assert all(p.grad is not None for p in (m.gate.weight for m in layers))


@pytest.mark.parametrize("granularity", ["full", "selective"])
def test_attention_reruns_in_the_recompute(monkeypatch, granularity):
    """No policy saves a kernel's output: K1's forward (its plain version
    here) runs again in the recompute, twice per layer in all, and K2 once
    per layer."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa._reference_attention, fa._reference_attention_bwd

    def fwd(*a):
        calls["fwd"] += 1
        return real_fwd(*a)

    def bwd(*a):
        calls["bwd"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(fa, "_reference_attention", fwd)
    monkeypatch.setattr(fa, "_reference_attention_bwd", bwd)
    cfg = GPTConfig.tiny(hidden_size=128, num_heads=2, recompute=True,
                         recompute_granularity=granularity)  # d = 64: attention_core/flash
    pm = GPTForPretraining(cfg, device="cpu")
    ids = torch.from_numpy(_ids((2, 16), seed=50)).long()
    GPTPretrainingCriterion()(pm(ids), ids).backward()
    assert calls == {"fwd": 2 * cfg.num_layers, "bwd": cfg.num_layers}


class _CountProducts(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the 2-D (``mm``) and batched (``bmm``) products it sees."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.counts["mm"] += 1
        elif func is torch.ops.aten.bmm.default:
            self.counts["bmm"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["nothing_saveable", "none", "dots_saveable",
                                    "dots_with_no_batch_dims_saveable"])
def test_policies_save_what_they_name(policy):
    """A block of 2-D and batched products: its backward under recompute
    runs the gradients' products plus the forward products the policy does
    not save (all for ``nothing_saveable`` and ``none``, none for
    ``dots_saveable``, the batched ones for
    ``dots_with_no_batch_dims_saveable``), and the gradients do not move."""
    g = torch.Generator().manual_seed(51)
    x = torch.randn(2, 5, 8, generator=g, requires_grad=True)
    w1, w2 = (torch.randn(8, 8, generator=g, requires_grad=True) for _ in range(2))

    def block(x):
        h = torch.tanh(x @ w1)
        return torch.tanh(torch.bmm(h, h.transpose(1, 2)) @ x @ w2).sum()

    with _CountProducts() as forward:
        y = block(x)
    with _CountProducts() as plain:
        y.backward()
    grads = [t.grad.clone() for t in (x, w1, w2)]
    for t in (x, w1, w2):
        t.grad = None
    y = trecompute.recompute(block, x, policy=policy)
    with _CountProducts() as counted:
        y.backward()
    fwd = forward.counts
    assert fwd["mm"] > 0 and fwd["bmm"] > 0
    rerun = {"nothing_saveable": fwd, "none": fwd, "dots_saveable": {"mm": 0, "bmm": 0},
             "dots_with_no_batch_dims_saveable": {"mm": 0, "bmm": fwd["bmm"]}}[policy]
    assert counted.counts == {k: plain.counts[k] + rerun[k] for k in rerun}
    for t, want in zip((x, w1, w2), grads):
        torch.testing.assert_close(t.grad, want, **SAME)


def test_recompute_policies_and_remat_wrapper():
    """The reference's policy names; an unknown one raises in both
    packages; ``remat`` wraps a function; without grad mode recompute calls
    through."""
    assert set(trecompute.POLICIES) == set(jrecompute.POLICIES)
    for mod in (trecompute, jrecompute):
        with pytest.raises(ValueError, match="unknown recompute policy"):
            mod.remat(lambda x: x, policy="dots_savable")
    with pytest.raises(ValueError, match="unknown recompute policy"):
        trecompute.recompute(torch.tanh, torch.ones(2), policy="dots_savable")
    x = torch.linspace(-1, 1, 7, requires_grad=True)
    f = trecompute.remat(lambda v: (torch.sin(v) * v).sum(), policy="dots_saveable")
    f(x).backward()
    torch.testing.assert_close(x.grad, torch.cos(x.detach()) * x.detach() + torch.sin(x.detach()))
    with torch.no_grad():
        assert trecompute.recompute(torch.tanh, x).grad_fn is None

"""AMP of the port (``paddle_tpu_torch/amp``, ``TrainStep(amp_level="O1")``,
``GradScaler``, the eager float16 path) and the cross entropy's non-fused
branches against ``paddle_tpu``'s, on the CPU.

The cases of ``tests/test_io_amp_metric.py::TestAMP`` and
``tests/test_stability.py::TestGradScalerDynamic`` run on both packages
with the same weights and inputs. A tiny GPT's O1 ``TrainStep`` (the
stacked trunk, which the reference runs as one unlisted op, and the
per-layer trunk, whose linears and attention it casts) and its eager
float16 steps with a ``GradScaler`` are held to the reference's losses
and parameters; each ``cross_entropy`` branch with ``weight``,
``ignore_index`` and every reduction to its loss and gradient.

Tolerances: the lists' dtypes exactly; GradScaler's scale, skips and
untouched parameters exactly; the cross entropy in f32 at atol 1e-6 /
rtol 1e-5 (f32 sums in another order). O1 losses within rtol 5e-5 (read
2.3e-7 on the stacked trunk, 5.2e-6 on the per-layer one: the two
frameworks round the bf16 products at different places) and every
parameter after three AdamW steps within the steps' reach, 2 lr a step:
AdamW moves an entry whose gradient is rounding noise (the zero-initialised
qkv biases) by about lr times that noise's sign. The eager float16 steps
likewise (an MLP: the reference's eager tape takes no GPT under float16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion

from paddle_tpu_torch import amp, observability
from paddle_tpu_torch import tensor as T
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.nn.layer import CrossEntropyLoss, Linear
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu

VALUE = dict(atol=1e-6, rtol=1e-5)
LOSS_RTOL = 5e-5
LR, STEPS = 1e-3, 3
REACH = dict(atol=2 * LR * STEPS, rtol=0.0)


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ the lists
def test_auto_cast_casts_matmul():
    a = _rng(0).standard_normal((4, 4)).astype(np.float32)
    with jamp.auto_cast(dtype="bfloat16"):
        jout = paddle.matmul(paddle.to_tensor(a), paddle.to_tensor(a))
    with amp.auto_cast(dtype="bfloat16"):
        out = T.matmul(torch.from_numpy(a), torch.from_numpy(a))
    assert str(jout.dtype).endswith("bfloat16") and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), _np(jout.numpy()))
    assert T.matmul(torch.from_numpy(a), torch.from_numpy(a)).dtype == torch.float32
    assert not amp.amp_state().enabled


def test_black_list_stays_fp32():
    a = torch.from_numpy(_rng(1).standard_normal((4, 4)).astype(np.float32)).to(torch.bfloat16)
    with amp.amp_guard(dtype="bfloat16"):
        assert T.sum(a).dtype == torch.float32
        assert T.mean(a).dtype == torch.float32 and T.exp(a).dtype == torch.float32
        assert torch.relu(a).dtype == torch.bfloat16  # unlisted: the incoming dtype
    assert T.sum(a).dtype == torch.bfloat16


def test_lists_letter_for_letter_and_custom_lists():
    assert amp.WHITE_LIST == jamp.WHITE_LIST and amp.BLACK_LIST == jamp.BLACK_LIST
    x = torch.ones(2, 2)
    with amp.auto_cast(custom_white_list={"exp"}, custom_black_list={"matmul"}, dtype="float16"):
        assert amp.amp_state().dtype == "float16"
        # a name on both lists takes the white list, as the reference checks it first
        assert T.exp(x).dtype == torch.float16
        assert T.matmul(x.half(), x.half()).dtype == torch.float16
    with amp.auto_cast(enable=False):
        assert T.matmul(x, x).dtype == torch.float32
    lin = Linear(2, 2, device="cpu")
    assert amp.decorate(lin, dtype="bfloat16") is lin and lin.weight.dtype == torch.bfloat16


# -------------------------------------------------------- GradScaler
def _linear_pair(n_in, n_out, seed):
    paddle.seed(seed)
    jlin = paddle.nn.Linear(n_in, n_out)
    lin = Linear(n_in, n_out, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(jlin.weight.numpy())))
        lin.bias.copy_(torch.from_numpy(np.asarray(jlin.bias.numpy())))
    return jlin, lin


def test_grad_scaler_fp16_flow():
    jnet, net = _linear_pair(4, 2, 0)
    x = _rng(2).standard_normal((4, 4)).astype(np.float32)
    jopt = paddle.optimizer.SGD(learning_rate=0.01, parameters=jnet.parameters())
    opt = SGD(learning_rate=0.01, parameters=net.parameters())
    jscaler = jamp.GradScaler(init_loss_scaling=128.0)
    scaler = amp.GradScaler(init_loss_scaling=128.0)
    jscaler.scale(jnet(paddle.to_tensor(x)).sum()).backward()
    jscaler.step(jopt)
    scaler.scale(net(torch.from_numpy(x)).sum()).backward()
    scaler.step(opt)
    assert np.isfinite(net.weight.detach().numpy()).all()
    np.testing.assert_allclose(net.weight.detach().numpy(), np.asarray(jnet.weight.numpy()),
                               **VALUE)
    assert scaler.get_loss_scaling() == jscaler.get_loss_scaling() == 128.0


def test_grad_scaler_skips_on_inf():
    jnet, net = _linear_pair(2, 2, 1)
    w0 = net.weight.detach().clone()
    opt = SGD(learning_rate=0.1, parameters=net.parameters())
    scaler = amp.GradScaler(init_loss_scaling=4.0)
    loss = (net(torch.tensor([[1e30, 1e30]])) * 1e30).sum()
    scaler.scale(loss).backward()
    scaler.step(opt)
    torch.testing.assert_close(net.weight.detach(), w0, atol=0, rtol=0)  # step skipped
    assert scaler.get_loss_scaling() <= 4.0


class TestGradScalerDynamic:
    def _setup(self):
        jlin, lin = _linear_pair(4, 4, 0)
        return lin, SGD(learning_rate=0.1, parameters=lin.parameters())

    def test_growth_after_clean_steps(self):
        lin, opt = self._setup()
        observability.monitor().clear()
        scaler = amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                                decr_every_n_nan_or_inf=1)
        x = torch.ones(2, 4)
        for _ in range(2):
            scaler.scale(T.mean(lin(x))).backward()
            scaler.step(opt)
            opt.clear_grad()
        assert scaler.get_loss_scaling() == 16.0  # doubled after 2 clean
        assert metrics.gauges("amp.")["amp.loss_scale"] == 16.0
        evs = observability.monitor().events("loss_scale")
        assert any(e.get("reason") == "grow" and e.get("value") == 16.0 for e in evs)

    def test_overflow_backoff_and_skip(self):
        lin, opt = self._setup()
        observability.monitor().clear()
        scaler = amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=1000,
                                decr_every_n_nan_or_inf=1)
        metrics.reset_counters("amp.")
        scaler.scale(T.mean(lin(torch.ones(2, 4)))).backward()
        p = opt._params[0]
        p.grad = p.grad * np.inf
        w = p.detach().clone()
        scaler.step(opt)
        assert scaler.get_loss_scaling() == 4.0  # backed off
        torch.testing.assert_close(p.detach(), w, atol=0, rtol=0)  # skipped
        assert metrics.counters("amp.")["amp.skipped_steps"] == 1
        evs = observability.monitor().events("loss_scale")
        assert any(e.get("reason") == "backoff" and e.get("value") == 4.0 for e in evs)
        assert metrics.gauges("amp.")["amp.loss_scale"] == 4.0
        assert scaler.state_dict() == {"scale": 4.0, "good_steps": 0, "bad_steps": 0}

    def test_disabled_passthrough(self):
        lin, opt = self._setup()
        scaler = amp.GradScaler(enable=False)
        loss = T.mean(lin(torch.ones(2, 4)))
        assert scaler.scale(loss) is loss  # bf16-style pass-through

    def test_schedule_matches_paddle_tpu(self):
        """The same sequence of clean and overflowed steps moves both
        packages' scales and counters alike."""
        kw = dict(init_loss_scaling=64.0, incr_every_n_steps=2, decr_every_n_nan_or_inf=2)
        scalers = {"port": amp.GradScaler(**kw), "ref": jamp.GradScaler(**kw)}
        trace = {k: [] for k in scalers}
        for bad in (False, False, True, False, True, True, False, False, False):
            for k, s in scalers.items():
                s._found_inf = bad
                s.update()
                trace[k].append((s.get_loss_scaling(), s.state_dict()))
        assert trace["port"] == trace["ref"]


# -------------------------------------------------------- O1 TrainStep
def _gpt_pair(seed, **cfg_kw):
    paddle.seed(seed)
    jcfg = JGPTConfig.tiny(**cfg_kw)
    jm = JGPT(jcfg)
    pm = GPTForPretraining(GPTConfig(**jcfg.to_dict()), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    return jm, pm


def _batches(n, seed):
    rng = _rng(seed)
    return [rng.integers(0, 512, (2, 32)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "per_layer"])
def test_train_step_o1_matches_paddle_tpu(stacked):
    """Three O1 AdamW steps of the tiny GPT: the losses and the f32
    parameters after them. The stacked trunk runs in f32 (an unlisted op
    in the reference) and the tied head in bf16; the per-layer trunk runs
    its linears and attention in bf16, its LayerNorms in f32."""
    jm, pm = _gpt_pair(21, stacked=stacked)
    jstep = JTrainStep(jm, paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters()),
                       JCriterion(), amp_level="O1")
    tstep = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.named_parameters()),
                      GPTPretrainingCriterion(), amp_level="O1")
    jl, tl = [], []
    for ids in _batches(STEPS, 22):
        jl.append(float(jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))["loss"].numpy()))
        out = tstep(ids, ids)
        assert out["loss"].dtype == torch.float32
        tl.append(float(out["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in pm.parameters())
    jparams = {n: _np(v) for n, v in jstep.state["params"].items()}
    for n, p in pm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jparams[n], err_msg=n, **REACH)


def test_eager_float16_mlp_with_grad_scaler_matches_paddle_tpu():
    """The eager float16 path on both packages: an MLP's forward under
    ``auto_cast(dtype="float16")`` (its linears in float16), the cross
    entropy outside it, a ``GradScaler`` growing every 2 steps and the
    eager AdamW, three steps: the losses, the scale, and the f32
    parameters after them."""
    paddle.seed(3)
    jnet = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(), paddle.nn.Linear(16, 4))
    net = torch.nn.Sequential(Linear(8, 16, device="cpu"), torch.nn.ReLU(),
                              Linear(16, 4, device="cpu"))
    with torch.no_grad():
        for (_, p), (_, jp) in zip(net.named_parameters(), jnet.named_parameters()):
            p.copy_(torch.from_numpy(np.array(jp.numpy())))
    jopt = paddle.optimizer.AdamW(learning_rate=LR, parameters=jnet.parameters())
    opt = AdamW(learning_rate=LR, parameters=net.parameters())
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2)
    jscaler, scaler = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    rng = _rng(24)
    jl, tl = [], []
    for _ in range(STEPS):
        x = rng.standard_normal((6, 8)).astype(np.float32)
        y = rng.integers(0, 4, 6)
        with jamp.auto_cast(dtype="float16"):
            jout = jnet(paddle.to_tensor(x))
        loss = JF.cross_entropy(jout, paddle.to_tensor(y))
        jscaler.scale(loss).backward()
        jscaler.step(jopt)
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        with amp.auto_cast(dtype="float16"):
            out = net(torch.from_numpy(x))
        assert out.dtype == torch.float16
        loss = cross_entropy(out, torch.from_numpy(y))
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert scaler.get_loss_scaling() == jscaler.get_loss_scaling() == 2048.0
    for (n, p), (_, jp) in zip(net.named_parameters(), jnet.named_parameters()):
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.detach().numpy(), _np(jp.numpy()), err_msg=n, **REACH)


def test_eager_float16_gpt_with_grad_scaler():
    """The port's per-layer tiny GPT trained eagerly in float16 (the forward
    under ``auto_cast``, ``loss.backward()`` through the scaled loss, the
    eager AdamW), three steps, against the same steps in f32 from the same
    weights: the losses within rtol 2e-5 (read 1.4e-6 at most: the
    float16 products round at 2**-11, averaged over the batch), the master
    weights f32. The reference's eager tape cannot take this
    model under ``auto_cast``: a white-listed op that consumes an f32
    activation hands its producer a float16 cotangent, which its VJP
    refuses (ROADMAP.md, Queue 3)."""
    losses = {}
    for dtype in ("float16", None):
        _, pm = _gpt_pair(23, stacked=False)
        opt = AdamW(learning_rate=LR, parameters=pm.parameters())
        scaler = amp.GradScaler(enable=dtype is not None, init_loss_scaling=1024.0)
        crit = GPTPretrainingCriterion()
        out_l = []
        for ids in _batches(STEPS, 24):
            x = torch.from_numpy(ids).long()
            with amp.auto_cast(enable=dtype is not None, dtype=dtype or "float16"):
                logits = pm(x)
            assert logits.dtype == (torch.float16 if dtype else torch.float32)
            loss = crit(logits, x)
            scaler.scale(loss).backward()
            scaler.step(opt)
            opt.clear_grad()
            out_l.append(float(loss))
        assert all(p.dtype == torch.float32 for p in pm.parameters())
        losses[dtype] = out_l
    assert np.isfinite(losses["float16"]).all()
    np.testing.assert_allclose(losses["float16"], losses[None], rtol=2e-5)


# ------------------------------------------------------- cross entropy
_CE_CASES = [
    dict(soft_label=True, reduction="mean"),
    dict(soft_label=True, reduction="sum"),
    dict(soft_label=True, reduction="none", axis=1),
    dict(label_smoothing=0.1, reduction="mean"),
    dict(label_smoothing=0.1, reduction="mean", weight=True, ignore_index=3),
    dict(label_smoothing=0.2, reduction="sum", ignore_index=3),
    dict(label_smoothing=0.1, reduction="none", weight=True, axis=1),
    dict(use_softmax=False, reduction="mean"),
    dict(use_softmax=False, reduction="mean", weight=True, ignore_index=3),
    dict(use_softmax=False, reduction="sum", weight=True),
    dict(use_softmax=False, reduction="none", ignore_index=3, axis=1),
]


@pytest.mark.parametrize("case", _CE_CASES,
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_cross_entropy_branches_match_paddle_tpu(case):
    """Each non-fused branch of ``cross_entropy``: the loss and the input's
    gradient, f32, with ``weight``, ``ignore_index``, ``axis`` and each
    reduction; and ``nn.CrossEntropyLoss`` passing the same arguments."""
    case = dict(case)
    use_weight = case.pop("weight", False)
    axis = case.get("axis", -1)
    rng = _rng(5)
    logits = (2 * rng.standard_normal((6, 10, 3) if axis == 1 else (6, 10))).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(axis, keepdims=True)
    x_np = probs if case.get("use_softmax") is False else logits
    if case.get("soft_label"):
        raw = rng.random(logits.shape).astype(np.float32)
        label = raw / raw.sum(axis, keepdims=True)
    else:
        label = rng.integers(0, 10, (6, 3) if axis == 1 else (6,))
        label[1] = 3  # an ignored row where ignore_index is 3
    weight = rng.random(10).astype(np.float32) + 0.5 if use_weight else None
    jx = paddle.to_tensor(x_np, stop_gradient=False)
    jl = JF.cross_entropy(jx, paddle.to_tensor(label),
                          weight=None if weight is None else paddle.to_tensor(weight), **case)
    JF_sum = jl.sum() if case.get("reduction") == "none" else jl
    JF_sum.backward()
    tx = torch.from_numpy(x_np).requires_grad_()
    tw = None if weight is None else torch.from_numpy(weight)
    tl = cross_entropy(tx, torch.from_numpy(label), weight=tw, **case)
    (tl.sum() if case.get("reduction") == "none" else tl).backward()
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl.numpy()), **VALUE)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()), **VALUE)
    layer = CrossEntropyLoss(weight=tw, **case)
    torch.testing.assert_close(layer(tx.detach(), torch.from_numpy(label)), tl.detach(),
                               atol=0, rtol=0)
    with amp.auto_cast(dtype="bfloat16"):  # on the black list: bf16 inputs go up to f32
        assert cross_entropy(tx.detach().to(torch.bfloat16), torch.from_numpy(label),
                             weight=tw, **case).dtype == torch.float32


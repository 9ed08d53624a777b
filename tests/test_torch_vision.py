"""The vision path of the port (convolution, batch norm, pooling, Momentum,
ResNet, LeNet) against ``paddle_tpu``'s, on the CPU.

Inputs are made with numpy from a seed and go through both packages;
models made by ``paddle_tpu`` from a seed are carried across by
``paddle_tpu_torch.utils.convert.state_dict_by_name`` (parameters and the
batch norms' ``_mean``/``_variance`` buffers).

Tolerances, f32: values of one formula on both sides atol 1e-5 / rtol
1e-5, gradients atol 2e-5 / rtol 1e-4 (as ``tests/test_torch_train.py``);
running statistics atol 1e-6 / rtol 1e-5. bf16 (AMP O2): atol / rtol 1e-2
(a bf16 rounding is 2**-8), the O2 loss rtol 2e-3 as the GPT O2 test.

A deep stack of batch norms over few values per channel is ill-conditioned
in f32: on resnet18 at ``[4, 3, 32, 32]`` the port's own f32 gradients
stand 8.5e-5 (relative L2) from its float64 ones, and the reference's
1.1e-4 from the port's (measured). ResNet50's gradients at such sizes are
worse conditioned still (3-14% between f32 and float64 on both sides), so
ResNet50 is held to the reference in its forwards and the step runs on
resnet18, held by its loss and the parameters and buffers after it.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.lenet import LeNet as JLeNet
from paddle_tpu.optimizer import functional as jFopt
from paddle_tpu.vision.models import resnet18 as jresnet18
from paddle_tpu.vision.models import resnet50 as jresnet50

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.lenet import LeNet
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import layer as L
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.optimizer import functional as Fopt
from paddle_tpu_torch.utils.convert import state_dict_by_name
from paddle_tpu_torch.vision import models as tv

VALUE = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=2e-5, rtol=1e-4)
STATS = dict(atol=1e-6, rtol=1e-5)
# running statistics inside a deep model inherit the forward's f32
# differences (ResNet50 at [2, 3, 64, 64]: logits 1.1e-4 apart relative to
# their largest, running variances up to 6.3e-5 relative, measured)
MODEL_STATS = dict(atol=1e-5, rtol=5e-4)
BF16 = dict(atol=1e-2, rtol=1e-2)
# parameters after one Momentum step at lr 0.1 move by 0.1 g: within 1e-4
# holds the gradients to about 1e-3 of theirs (|g| stays below 1 here)
PARAMS_AFTER = dict(atol=1e-4, rtol=1e-4)
LR = 0.1


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_of(jm, pm):
    pm.load_state_dict(state_dict_by_name(_state(jm), pm))
    return pm


# ---------------------------------------------------------------- functionals


@pytest.mark.parametrize("case", [
    dict(padding=0), dict(padding=1), dict(padding=[1, 2]), dict(padding=[1, 0, 2, 1]),
    dict(padding="SAME", stride=2), dict(padding="same"), dict(padding="VALID", stride=[2, 1]),
    dict(padding=2, dilation=2), dict(padding=1, groups=2), dict(padding=1, bias=False),
])
def test_conv2d_matches_paddle_tpu(case):
    """``conv2d`` forward and its gradients for each of the reference's
    padding forms, with stride, dilation and groups."""
    case = dict(case)
    bias, groups = case.pop("bias", True), case.get("groups", 1)
    rng = _rng(0)
    x = rng.standard_normal((2, 4, 9, 8)).astype(np.float32)
    w = (0.3 * rng.standard_normal((6, 4 // groups, 3, 3))).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32) if bias else None
    jx, jw = (paddle.to_tensor(a, stop_gradient=False) for a in (x, w))
    jb = paddle.to_tensor(b, stop_gradient=False) if bias else None
    jy = JF.conv2d(jx, jw, jb, **case)
    g = rng.standard_normal(tuple(jy.shape)).astype(np.float32)
    (jy * paddle.to_tensor(g)).sum().backward()
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    tb = torch.from_numpy(b).requires_grad_() if bias else None
    ty = F.conv2d(tx, tw, tb, **case)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), **VALUE)
    pairs = [(tx, jx), (tw, jw)] + ([(tb, jb)] if bias else [])
    for t, j in pairs:
        np.testing.assert_allclose(t.grad.numpy(), j.grad.numpy(), **GRAD)


@pytest.mark.parametrize("n", [1, 3])
def test_conv1d_and_conv3d_match_paddle_tpu(n):
    rng = _rng(1)
    x = rng.standard_normal((2, 3) + (7,) * n).astype(np.float32)
    w = (0.3 * rng.standard_normal((5, 3) + (3,) * n)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    fn_j, fn_t = {1: (JF.conv1d, F.conv1d), 3: (JF.conv3d, F.conv3d)}[n]
    want = fn_j(*(paddle.to_tensor(a) for a in (x, w, b)), stride=2, padding=1).numpy()
    got = fn_t(*(torch.from_numpy(a) for a in (x, w, b)), stride=2, padding=1)
    np.testing.assert_allclose(got.numpy(), want, **VALUE)


@pytest.mark.parametrize("pool", ["max_k3s2p1", "max_k2s2", "avg_exclusive_p1", "avg_inclusive_p1",
                                  "avg_k2", "adaptive_1", "adaptive_3", "adaptive_none"])
def test_pools_match_paddle_tpu(pool):
    """The three pools, forward and gradient, on a 7 x 9 input (odd, so the
    padded and adaptive windows are ragged)."""
    rng = _rng(2)
    x = rng.standard_normal((2, 3, 7, 9)).astype(np.float32)
    calls = {
        "max_k3s2p1": lambda f, v: f.max_pool2d(v, 3, 2, 1),
        "max_k2s2": lambda f, v: f.max_pool2d(v, 2, 2),
        "avg_exclusive_p1": lambda f, v: f.avg_pool2d(v, 3, 2, 1),
        "avg_inclusive_p1": lambda f, v: f.avg_pool2d(v, 3, 2, 1, exclusive=False),
        "avg_k2": lambda f, v: f.avg_pool2d(v, [2, 3]),
        "adaptive_1": lambda f, v: f.adaptive_avg_pool2d(v, (1, 1)),
        "adaptive_3": lambda f, v: f.adaptive_avg_pool2d(v, 3),
        "adaptive_none": lambda f, v: f.adaptive_avg_pool2d(v, (2, None)),
    }[pool]
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = calls(JF, jx)
    g = rng.standard_normal(tuple(jy.shape)).astype(np.float32)
    (jy * paddle.to_tensor(g)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    ty = calls(F, tx)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), **VALUE)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **GRAD)


def test_knobs_the_reference_drops_raise():
    """``ceil_mode``, a channel-last layout, ``divisor_override`` and
    ``return_mask`` raise in the port (the reference drops them without a
    word), as do the transposed convolutions and a channel-last conv."""
    x = torch.zeros(1, 2, 6, 6)
    w = torch.zeros(3, 2, 3, 3)
    for call in (lambda: F.max_pool2d(x, 2, ceil_mode=True),
                 lambda: F.max_pool2d(x, 2, data_format="NHWC"),
                 lambda: F.max_pool2d(x, 2, return_mask=True),
                 lambda: F.avg_pool2d(x, 2, divisor_override=3),
                 lambda: F.avg_pool2d(x, 2, ceil_mode=True),
                 lambda: F.adaptive_avg_pool2d(x, 1, data_format="NHWC"),
                 lambda: F.conv2d(x, w, data_format="NHWC"),
                 lambda: L.MaxPool2D(2, ceil_mode=True)(x)):
        with pytest.raises(NotImplementedError):
            call()
    from paddle_tpu_torch.nn.functional import conv
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        conv.conv2d_transpose(x, w)
    with pytest.raises(ValueError, match="SAME"):
        F.conv2d(x, w, padding="FULL")
    with pytest.raises(NotImplementedError):
        L.Conv2D(2, 3, 3, padding_mode="reflect", device="cpu")


def _bn_both(x, training, use_global_stats=None, seed=3):
    """``batch_norm`` on both sides from the same buffers and affine
    parameters, with the backward of ``sum(y * g)``: ``(port, reference)``
    each ``(y, dx, dw, db, running mean, running var)``."""
    rng = _rng(seed)
    c = x.shape[1]
    w = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    b = (0.2 * rng.standard_normal(c)).astype(np.float32)
    rm = (0.1 * rng.standard_normal(c)).astype(np.float32)
    rv = rng.uniform(0.5, 1.5, c).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(training=training, momentum=0.9, epsilon=1e-5, use_global_stats=use_global_stats,
              data_format="NCHW" if x.ndim == 4 else "NCL")
    jx, jw, jb = (paddle.to_tensor(a, stop_gradient=False) for a in (x, w, b))
    jrm, jrv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    jy = JF.batch_norm(jx, jrm, jrv, jw, jb, **kw)
    (jy * paddle.to_tensor(g)).sum().backward()
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    ty = F.batch_norm(tx, trm, trv, tw, tb, **kw)
    ty.backward(torch.from_numpy(g))
    port = (ty.detach(), tx.grad, tw.grad, tb.grad, trm, trv)
    ref = (jy, jx.grad, jw.grad, jb.grad, jrm, jrv)
    return [t.numpy() for t in port], [np.asarray(j.numpy()) for j in ref], (rm, rv)


@pytest.mark.parametrize("shape", [(4, 3, 5, 5), (6, 4)])
def test_batch_norm_training_matches_paddle_tpu(shape):
    """Training: the output, its gradients, and both running buffers, whose
    update is ``0.9 old + 0.1 batch`` with the BIASED batch variance (torch's
    own ``batch_norm`` would take the unbiased one and the complement of the
    momentum)."""
    x = (1.5 * _rng(4).standard_normal(shape) + 0.7).astype(np.float32)
    port, ref, (rm, rv) = _bn_both(x, training=True)
    for got, want, tol in zip(port, ref, (VALUE, GRAD, GRAD, GRAD, STATS, STATS)):
        np.testing.assert_allclose(got, want, **tol)
    axes = tuple(i for i in range(x.ndim) if i != 1)
    np.testing.assert_allclose(port[4], 0.9 * rm + 0.1 * x.mean(axes), **STATS)
    np.testing.assert_allclose(port[5], 0.9 * rv + 0.1 * x.var(axes), **STATS)
    assert not np.allclose(port[5], 0.9 * rv + 0.1 * x.var(axes, ddof=1), **STATS)


@pytest.mark.parametrize("mode", ["eval", "use_global_stats"])
def test_batch_norm_on_running_stats_matches_paddle_tpu(mode):
    """Eval, and training with ``use_global_stats``: normalised by the
    running buffers, which stay as they were."""
    x = (1.5 * _rng(5).standard_normal((4, 3, 5, 5)) + 0.7).astype(np.float32)
    port, ref, (rm, rv) = _bn_both(x, training=mode != "eval",
                                   use_global_stats=True if mode != "eval" else None)
    for got, want, tol in zip(port, ref, (VALUE, GRAD, GRAD, GRAD, STATS, STATS)):
        np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_array_equal(port[4], rm)
    np.testing.assert_array_equal(port[5], rv)


def test_batch_norm_bf16_input_bf16_affine_f32_stats():
    """The O2 case: bf16 ``x``, bf16 ``weight``/``bias`` (the casts of the
    f32 masters) and f32 running buffers. The output and ``x``'s gradient
    are bf16, the buffers stay f32 and agree with the f32 computation to a
    bf16 rounding of ``x``; the reference, whose statistics are bf16 here,
    agrees at bf16 tolerance."""
    rng = _rng(6)
    x = (1.5 * rng.standard_normal((4, 3, 5, 5)) + 0.7).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    w = torch.from_numpy((1 + 0.2 * rng.standard_normal(3)).astype(np.float32)).bfloat16()
    b = torch.from_numpy((0.2 * rng.standard_normal(3)).astype(np.float32)).bfloat16()
    rm, rv = torch.zeros(3), torch.ones(3)
    tx, tw, tb = (t.clone().requires_grad_() for t in (xb, w, b))
    y = F.batch_norm(tx, rm, rv, tw, tb, training=True)
    y.float().sum().backward()
    assert y.dtype == tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    assert rm.dtype == rv.dtype == torch.float32
    xf = xb.float().numpy()
    np.testing.assert_allclose(rm.numpy(), 0.1 * xf.mean((0, 2, 3)), **STATS)
    np.testing.assert_allclose(rv.numpy(), 0.9 + 0.1 * xf.var((0, 2, 3)), **STATS)
    jrm, jrv = paddle.to_tensor(np.zeros(3, np.float32)), paddle.to_tensor(np.ones(3, np.float32))
    jy = JF.batch_norm(*(paddle.to_tensor(jnp.asarray(t.float().numpy(), jnp.bfloat16))
                         for t in (xb,)), jrm, jrv,
                       *(paddle.to_tensor(jnp.asarray(t.float().numpy(), jnp.bfloat16))
                         for t in (w, b)), training=True)
    np.testing.assert_allclose(y.detach().float().numpy(), _np(jy.numpy()), **BF16)
    np.testing.assert_allclose(rv.numpy(), _np(jrv.numpy()), **BF16)
    # eval on the f32 buffers with the bf16 affine casts
    ye = F.batch_norm(xb, rm, rv, w, b, training=False)
    assert ye.dtype == torch.bfloat16


@pytest.mark.parametrize("layer,shape", [("BatchNorm", (4, 3, 5, 5)), ("BatchNorm1D", (6, 3)),
                                         ("BatchNorm1D", (4, 3, 7)), ("BatchNorm2D", (4, 3, 5, 5)),
                                         ("BatchNorm3D", (2, 3, 3, 4, 5))])
def test_batch_norm_layers_match_paddle_tpu(layer, shape):
    """Each batch-norm layer from its defaults (weight ones, bias zeros,
    buffers zeros and ones) in training and then in eval: the outputs and
    the buffers ``_mean``/``_variance``."""
    x = (1.5 * _rng(8).standard_normal(shape) + 0.7).astype(np.float32)
    jm, pm = getattr(jnn, layer)(3), getattr(L, layer)(3, device="cpu")
    assert [n for n, _ in pm.named_buffers()] == ["_mean", "_variance"]
    for _ in range(2):
        np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                                   jm(paddle.to_tensor(x)).numpy(), **VALUE)
    jstate = _state(jm)
    for n, t in pm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), jstate[n], err_msg=n, **STATS)
    jm.eval()
    pm.eval()
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               jm(paddle.to_tensor(x)).numpy(), **VALUE)


def test_conv_layers_defaults():
    """The reference's conv defaults: weight ``[out, in / groups, *k]``
    drawn Normal(0, sqrt(2 / fan_in)), a zero bias, none with
    ``bias_attr=False``; ``Conv1D``/``Conv3D`` take their own layouts."""
    gen = torch.Generator().manual_seed(9)
    conv = L.Conv2D(64, 128, 3, groups=2, device="cpu", generator=gen)
    assert tuple(conv.weight.shape) == (128, 32, 3, 3) and not conv.bias.any()
    std = math.sqrt(2.0 / (32 * 9))
    w = conv.weight.detach()
    assert abs(float(w.std()) / std - 1) < 0.02 and abs(float(w.mean())) < 0.01 * std
    assert L.Conv2D(3, 4, 1, bias_attr=False, device="cpu").bias is None
    x = torch.zeros(1, 2, 5)
    assert tuple(L.Conv1D(2, 3, 3, padding=1, device="cpu")(x).shape) == (1, 3, 5)
    assert tuple(L.Conv3D(2, 3, 3, device="cpu")(torch.zeros(1, 2, 4, 4, 4)).shape) == (1, 3, 2, 2, 2)
    with pytest.raises(NotImplementedError, match="weight_attr"):
        L.Conv2D(3, 4, 1, weight_attr=0.5, device="cpu")


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_core_matches_paddle_tpu(nesterov):
    """Three updates of three parameters (f32 velocity, in place)."""
    rng = _rng(7)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jcore, tcore = jFopt.MomentumCore(0.9, nesterov), Fopt.MomentumCore(0.9, nesterov)
    jp = {i: jnp.asarray(p) for i, p in enumerate(params)}
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jcore.init(jp), tcore.init(tp)
    for step in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jp, js = jcore.update({i: jnp.asarray(g) for i, g in enumerate(grads)}, js, jp, LR, step)
        tcore.update([torch.from_numpy(g) for g in grads], ts, tp, LR, step)
    for i, t in enumerate(tp):
        np.testing.assert_allclose(t.numpy(), _np(jp[i]), **VALUE)
        np.testing.assert_allclose(ts["velocity"][i].numpy(), _np(js["velocity"][i]), **VALUE)
    assert all(v.dtype == torch.float32 for v in ts["velocity"])


def test_momentum_weight_decay_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Momentum(parameters=[torch.zeros(2, requires_grad=True)], weight_decay=1e-4)


# --------------------------------------------------------------------- models


def _images(shape, seed):
    return _rng(seed).standard_normal(shape).astype(np.float32)


def test_resnet50_forward_matches_paddle_tpu():
    """A reference ResNet50 from a seed, carried across: the train-mode
    forward (batch statistics) and the running buffers it leaves, then the
    eval forward on them. The train-mode logits within 1e-3 (measured
    3.6e-4: the last stage's batch norms normalise 8 values per channel
    here, which magnifies f32 rounding). One EMA step leaves the buffers
    near (0, 1), so the eval forward hardly normalises and its logits grow
    to about 1e3: they are held by their relative L2 distance, within 1e-4
    (measured 9.1e-6)."""
    paddle.seed(20)
    jm = jresnet50(num_classes=10)
    pm = _port_of(jm, tv.resnet50(num_classes=10, device="cpu"))
    x = _images((2, 3, 64, 64), seed=21)
    want = jm(paddle.to_tensor(x)).numpy()
    got = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    jstate = _state(jm)
    for n, t in pm.state_dict().items():
        if n.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(t.numpy(), jstate[n], err_msg=n, **MODEL_STATS)
    jm.eval()
    pm.eval()
    want = jm(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel_l2 <= 1e-4, rel_l2


def test_lenet_eager_momentum_loop_matches_paddle_tpu():
    """LeNet's forward (no batch norm: train and eval alike), then
    ``bench_suite.py:bench_mnist``'s eager loop, three steps:
    ``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``."""
    paddle.seed(24)
    jm = JLeNet()
    pm = _port_of(jm, LeNet(device="cpu"))
    jopt = paddle.optimizer.Momentum(learning_rate=0.01, parameters=jm.parameters())
    topt = Momentum(learning_rate=0.01, parameters=pm.parameters())
    jloss_fn, tloss_fn = jnn.CrossEntropyLoss(), L.CrossEntropyLoss()
    x = _images((8, 1, 28, 28), seed=25)
    y = _rng(26).integers(0, 10, (8,)).astype(np.int64)
    with torch.no_grad():
        logits = pm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits, jm(paddle.to_tensor(x)).numpy(), **VALUE)
    pm.train()
    jl, tl = [], []
    for _ in range(3):
        loss = jloss_fn(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        loss = tloss_fn(pm(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(float(loss.detach()))
        assert all(p.grad is None for p in pm.parameters())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jstate = _state(jm)
    for n, t in pm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), jstate[n], err_msg=n, **VALUE)


def _steps_both(jm, pm, x, y, **step_kw):
    """One Momentum ``TrainStep`` on each side (``step_kw`` on both): the
    losses, the reference's state after and the port's model."""
    jstep = JTrainStep(jm, paddle.optimizer.Momentum(learning_rate=LR, parameters=jm.parameters()),
                       jnn.CrossEntropyLoss(), **step_kw)
    jl = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))["loss"].numpy())
    tstep = TrainStep(pm, Momentum(learning_rate=LR, parameters=pm.parameters()),
                      L.CrossEntropyLoss(), **step_kw)
    out = tstep(x, y)
    assert out["loss"].dtype == torch.float32
    jafter = {n: _np(v) for part in ("params", "buffers") for n, v in jstep.state[part].items()}
    return float(out["loss"]), jl, jafter


def test_resnet18_train_step_f32_matches_paddle_tpu():
    """One f32 ``TrainStep`` with Momentum (lr 0.1) and ``CrossEntropyLoss``
    on resnet18: the loss, the parameters and the running buffers after
    the step."""
    paddle.seed(30)
    jm = jresnet18(num_classes=10)
    pm = _port_of(jm, tv.resnet18(num_classes=10, device="cpu"))
    x = _images((4, 3, 32, 32), seed=31)
    y = _rng(32).integers(0, 10, (4,)).astype(np.int64)
    tl, jl, jafter = _steps_both(jm, pm, x, y)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(pm.state_dict()) == set(jafter)
    for n, t in pm.state_dict().items():
        tol = MODEL_STATS if n.endswith(("_mean", "_variance")) else PARAMS_AFTER
        np.testing.assert_allclose(t.numpy(), jafter[n], err_msg=n, **tol)


class _JBNNet(jnn.Layer):
    """A small convolutional net with batch norms, in the reference."""

    def __init__(self):
        super().__init__()
        self.features = jnn.Sequential(jnn.Conv2D(1, 4, 3, padding=1), jnn.BatchNorm2D(4),
                                       jnn.ReLU(), jnn.MaxPool2D(2, 2),
                                       jnn.Conv2D(4, 8, 3, padding=1, bias_attr=False),
                                       jnn.BatchNorm2D(8), jnn.ReLU(), jnn.AdaptiveAvgPool2D(1))
        self.fc = jnn.Linear(8, 10)

    def forward(self, x):
        from paddle_tpu.tensor.manipulation import flatten

        return self.fc(flatten(self.features(x), 1))


class _BNNet(torch.nn.Module):
    """The same net in the port, with the same names."""

    def __init__(self, device="cpu"):
        super().__init__()
        d = dict(device=device)
        self.features = torch.nn.Sequential(L.Conv2D(1, 4, 3, padding=1, **d), L.BatchNorm2D(4, **d),
                                            L.ReLU(), L.MaxPool2D(2, 2),
                                            L.Conv2D(4, 8, 3, padding=1, bias_attr=False, **d),
                                            L.BatchNorm2D(8, **d), L.ReLU(), L.AdaptiveAvgPool2D(1))
        self.fc = L.Linear(8, 10, **d)

    def forward(self, x):
        return self.fc(torch.flatten(self.features(x), 1))


def test_accumulate_steps_with_batch_norm_matches_paddle_tpu():
    """``accumulate_steps=2``: two strided micro-batches run in sequence,
    each normalised by its own statistics and each moving the running
    buffers once, as the reference's ``lax.scan`` carries them; one
    Momentum update of the averaged gradients."""
    paddle.seed(36)
    jm = _JBNNet()
    pm = _port_of(jm, _BNNet())
    x = _images((8, 1, 12, 12), seed=37)
    y = _rng(38).integers(0, 10, (8,)).astype(np.int64)
    with torch.no_grad():  # the first batch norm's input, per micro-batch, before the step
        means = [pm.features[0](torch.from_numpy(x[i::2])).mean((0, 2, 3)) for i in range(2)]
    tl, jl, jafter = _steps_both(jm, pm, x, y, accumulate_steps=2)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n, t in pm.state_dict().items():
        tol = STATS if n.endswith(("_mean", "_variance")) else PARAMS_AFTER
        np.testing.assert_allclose(t.numpy(), jafter[n], err_msg=n, **tol)
    # two EMA steps in micro-batch order, each from its own micro-batch
    want = 0.9 * (0.1 * means[0]) + 0.1 * means[1]
    torch.testing.assert_close(pm.features[1]._mean, want, **STATS)


def test_o2_step_with_batch_norm_matches_paddle_tpu():
    """AMP O2 on both sides: bf16 compute over f32 masters; the batch norms
    see bf16 inputs and bf16 affine casts and update their f32 buffers. The
    loss within rtol 2e-3, the parameters and buffers after the step at
    bf16 tolerance (the reference's batch statistics are bf16, the port's
    f32); the masters and buffers stay f32. The small net's batch norms see
    many values per channel; resnet18 at ``[4, 3, 32, 32]`` is no fit for a
    bf16 comparison: rounding after each op (the port) or inside fused
    kernels (XLA) moves its logits by up to 10% through the last stage's
    batch norms over 4 values per channel (measured on the port against its
    own f32 forward)."""
    paddle.seed(33)
    jm = _JBNNet()
    pm = _port_of(jm, _BNNet())
    x = _images((8, 1, 12, 12), seed=34)
    y = _rng(35).integers(0, 10, (8,)).astype(np.int64)
    tl, jl, jafter = _steps_both(jm, pm, x, y, amp_level="O2")
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert all(t.dtype == torch.float32 for t in pm.state_dict().values())
    for n, t in pm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), jafter[n], err_msg=n, **BF16)
    assert not torch.equal(pm.features[1]._mean, torch.zeros(4))


def test_every_resnet_constructor_builds():
    """Every constructor of the reference's ``resnet.py``: the parameter
    counts of the architectures with published counts (1000 classes), the
    grouped 3 x 3 convolution of every ResNeXt, and ``pretrained=True``
    raises (the port downloads nothing)."""
    published = {"resnet18": 11689512, "resnet34": 21797672, "resnet50": 25557032,
                 "resnet101": 44549160, "resnet152": 60192808, "resnext50_32x4d": 25028904,
                 "wide_resnet50_2": 68883240, "wide_resnet101_2": 126886696}
    grouped = {"resnext50_32x4d": 32, "resnext50_64x4d": 64, "resnext101_32x4d": 32,
               "resnext101_64x4d": 64, "resnext152_32x4d": 32, "resnext152_64x4d": 64}
    for name in sorted(set(published) | set(grouped)):
        m = getattr(tv, name)(device="cpu")
        if name in published:
            assert sum(p.numel() for p in m.parameters()) == published[name], name
        if name in grouped:
            groups = grouped[name]
            width = 4 * groups  # planes 64 * base_width 4 / 64 * groups
            assert m.layer1[0].conv2.groups == groups
            assert tuple(m.layer1[0].conv2.weight.shape) == (width, width // groups, 3, 3), name
        del m
    with pytest.raises(NotImplementedError, match="pretrained"):
        tv.resnet50(pretrained=True, device="cpu")


def test_state_dict_by_name_checks_names_and_shapes():
    paddle.seed(39)
    jm = JLeNet()
    pm = LeNet(device="cpu")
    state = _state(jm)
    assert set(state_dict_by_name(state, pm)) == set(pm.state_dict())
    with pytest.raises(KeyError, match="missing"):
        state_dict_by_name({k: v for k, v in state.items() if k != "fc.0.bias"}, pm)
    with pytest.raises(KeyError, match="extra"):
        state_dict_by_name(dict(state, stray=np.zeros(1)), pm)
    with pytest.raises(ValueError, match="fc.0.weight"):
        state_dict_by_name(dict(state, **{"fc.0.weight": np.zeros((120, 400))}), pm)
    bn = _BNNet()
    assert {"features.1._mean", "features.1._variance"} <= set(bn.state_dict())
    assert not any("num_batches_tracked" in n for n in bn.state_dict())

"""The rest of the port's ``nn`` layer library against ``paddle_tpu``'s, on
the CPU: the norms (``layer_norm``, ``instance_norm``, ``group_norm``,
``local_response_norm``, ``rms_norm``, channel-last ``batch_norm`` and
their layers), the 1-D, 2-D and 3-D pools and adaptive pools, and the
transposed and channel-last convolutions.

The same numpy inputs go through both packages, with the gradients of
``sum(y * g)``. Tolerances, f32: values atol 1e-5 / rtol 1e-5, gradients
atol 2e-5 / rtol 1e-4 (as ``tests/test_torch_vision.py``).

Where the reference is at fault (ROADMAP.md, "Faults in the reference":
``ceil_mode``, ``divisor_override`` and channel-last pools, the adaptive
max pools' ``return_mask``, channel-last ``local_response_norm``, and the
transposed convolutions at dilation > 1, ``groups`` > 1 or with
``output_size``), the port runs in float64 against an independent float64
numpy construction (an explicit window loop for the pools, a scatter-add
loop for the transposed convolutions) to atol 1e-10, and its gradients by
``torch.autograd.gradcheck``.
"""
import itertools
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import layer as L
from paddle_tpu_torch.utils.convert import state_dict_by_name

VALUE = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=2e-5, rtol=1e-4)
EXACT64 = dict(atol=1e-10, rtol=1e-10)


def _x(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _both(fn_ref, fn_port, arrays, seed=1):
    """``fn`` of the arrays in both packages, forward and the gradients of
    ``sum(y * g)`` with respect to the float arrays, held to each other."""
    floats = [a.dtype.kind == "f" for a in arrays]
    js = [paddle.to_tensor(a, stop_gradient=not f) for a, f in zip(arrays, floats)]
    ts = [torch.from_numpy(a.copy()).requires_grad_(f) for a, f in zip(arrays, floats)]
    jy, ty = fn_ref(*js), fn_port(*ts)
    g = np.random.default_rng(seed).standard_normal(tuple(jy.shape)).astype(np.float32)
    (jy * paddle.to_tensor(g)).sum().backward()
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy.numpy()), **VALUE)
    for t, j, f in zip(ts, js, floats):
        if f:
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad.numpy()), **GRAD)
    return ty


def _gradcheck(fn, *arrays):
    ins = [torch.from_numpy(a.astype(np.float64)).requires_grad_() for a in arrays]
    assert torch.autograd.gradcheck(fn, ins, eps=1e-6, atol=1e-6)


# ---------------------------------------------------------------- norms

NORM_CASES = {
    "layer_norm_last_affine": (lambda f, x, w, b: f.layer_norm(x, 6, w, b), [(3, 4, 6), (6,), (6,)]),
    "layer_norm_two_dims": (lambda f, x, w, b: f.layer_norm(x, [4, 6], w, b),
                            [(3, 4, 6), (4, 6), (4, 6)]),
    "layer_norm_no_affine": (lambda f, x: f.layer_norm(x, [4, 6], epsilon=1e-3), [(3, 4, 6)]),
    "instance_norm_nchw": (lambda f, x, w, b: f.instance_norm(x, weight=w, bias=b),
                           [(2, 3, 5, 4), (3,), (3,)]),
    "instance_norm_nhwc": (lambda f, x, w, b: f.instance_norm(x, weight=w, bias=b,
                                                              data_format="NHWC"),
                           [(2, 5, 4, 3), (3,), (3,)]),
    "instance_norm_ncl": (lambda f, x: f.instance_norm(x, data_format="NCL"), [(2, 3, 7)]),
    "group_norm": (lambda f, x, w, b: f.group_norm(x, 2, 1e-5, w, b), [(2, 6, 3, 4), (6,), (6,)]),
    "group_norm_3d": (lambda f, x: f.group_norm(x, 3), [(2, 6, 2, 3, 2)]),
    "local_response_norm": (lambda f, x: f.local_response_norm(x, 3, 1e-2, 0.75, 2.0),
                            [(2, 5, 3, 3)]),
    "local_response_norm_even": (lambda f, x: f.local_response_norm(x, 4), [(2, 6, 3)]),
    "rms_norm": (lambda f, x, w: f.rms_norm(x, w), [(3, 8), (8,)]),
    "rms_norm_no_weight": (lambda f, x: f.rms_norm(x, epsilon=1e-3), [(2, 3, 8)]),
    "batch_norm_nhwc": (lambda f, x, w, b: f.batch_norm(x, _rm(f), _rv(f), w, b, training=True,
                                                        data_format="NHWC"),
                        [(4, 3, 3, 5), (5,), (5,)]),
    "batch_norm_nlc_eval": (lambda f, x: f.batch_norm(x, _rm(f, 4), _rv(f, 4), data_format="NLC"),
                            [(3, 5, 4)]),
}


def _rm(f, c=5):
    v = np.linspace(-0.2, 0.2, c).astype(np.float32)
    return paddle.to_tensor(v) if f is JF else torch.from_numpy(v)


def _rv(f, c=5):
    v = np.linspace(0.5, 1.5, c).astype(np.float32)
    return paddle.to_tensor(v) if f is JF else torch.from_numpy(v)


@pytest.mark.parametrize("case", sorted(NORM_CASES))
def test_norm_functionals_match_paddle_tpu(case):
    fn, shapes = NORM_CASES[case]
    arrays = [_x(s, seed=i) + (1.0 if i and len(s) == 1 else 0.0) for i, s in enumerate(shapes)]
    _both(lambda *a: fn(JF, *a), lambda *a: fn(F, *a), arrays)


def test_channel_last_batch_norm_moves_running_stats_as_channel_first():
    x = _x((4, 3, 3, 5), seed=3)
    stats = []
    for layout, v in (("NCHW", np.moveaxis(x, -1, 1)), ("NHWC", x)):
        rm, rv = torch.zeros(5), torch.ones(5)
        F.batch_norm(torch.from_numpy(v.copy()), rm, rv, training=True, data_format=layout)
        stats.append((rm, rv))
    torch.testing.assert_close(stats[0], stats[1], atol=1e-7, rtol=1e-6)


def _np_lrn(x, size, alpha, beta, k):
    """Local response norm over dim 1, float64, by an explicit channel loop."""
    out = np.empty_like(x)
    c = x.shape[1]
    for i in range(c):
        lo, hi = max(0, i - size // 2), min(c, i + size - size // 2)
        acc = (x[:, lo:hi] ** 2).sum(1)
        out[:, i] = x[:, i] / (k + alpha * acc / size) ** beta
    return out


def test_local_response_norm_channel_last_against_numpy():
    """Channel-last reads the channels from the last dim (the reference
    always takes dim 1)."""
    x = _x((2, 3, 4, 6), seed=4, dtype=np.float64)
    got = F.local_response_norm(torch.from_numpy(x), 3, 0.1, 0.75, 1.0, data_format="NHWC")
    want = np.moveaxis(_np_lrn(np.moveaxis(x, -1, 1), 3, 0.1, 0.75, 1.0), 1, -1)
    np.testing.assert_allclose(got.numpy(), want, **EXACT64)
    _gradcheck(lambda v: F.local_response_norm(v, 3, 0.1, 0.75, 1.0, data_format="NHWC"),
               x[:1, :2, :2])


def test_group_norm_channel_last_raises_as_the_reference():
    with pytest.raises(NotImplementedError, match="channels first"):
        F.group_norm(torch.zeros(1, 2, 2, 4), 2, data_format="NHWC")


# name: (the layer from a namespace and the port's device keywords, input)
NORM_LAYERS = {
    "GroupNorm": (lambda m, d: m.GroupNorm(2, 6, **d), (2, 6, 3, 3)),
    "InstanceNorm1D": (lambda m, d: m.InstanceNorm1D(3, **d), (2, 3, 7)),
    "InstanceNorm2D": (lambda m, d: m.InstanceNorm2D(3, **d), (2, 3, 4, 5)),
    "InstanceNorm3D": (lambda m, d: m.InstanceNorm3D(3, **d), (2, 3, 2, 3, 4)),
    "LocalResponseNorm": (lambda m, d: m.LocalResponseNorm(3), (2, 4, 3, 3)),
    "RMSNorm": (lambda m, d: m.RMSNorm(8, **d), (3, 8)),
    "LayerNorm_two_dims": (lambda m, d: m.LayerNorm([3, 4], **d), (2, 3, 4)),
}


@pytest.mark.parametrize("name", sorted(NORM_LAYERS))
def test_norm_layers_match_paddle_tpu(name):
    make, shape = NORM_LAYERS[name]
    paddle.seed(5)
    jm = make(jnn, {})
    pm = make(L, dict(device="cpu"))
    state = {k: np.asarray(v.numpy()) + 0.1 for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    pm.load_state_dict(state_dict_by_name(state, pm))
    _both(jm, pm, [_x(shape, seed=6)])
    if state:  # the affine parameters' gradients
        jx = paddle.to_tensor(_x(shape, seed=6))
        jm(jx).sum().backward()
        pm(torch.from_numpy(_x(shape, seed=6))).sum().backward()
        for (n, p), jp in zip(pm.named_parameters(), jm.parameters()):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(jp.grad.numpy()), err_msg=n,
                                       **GRAD)


def test_instance_norm_layer_honours_data_format():
    """The reference's layer drops ``data_format``; the port's reads it."""
    x = _x((2, 4, 5, 3), seed=7)
    pm = L.InstanceNorm2D(3, data_format="NHWC", device="cpu")
    want = L.InstanceNorm2D(3, device="cpu")(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    torch.testing.assert_close(pm(torch.from_numpy(x)), want.movedim(1, -1), atol=1e-6, rtol=1e-6)


def test_spectral_norm_raises_as_the_reference():
    with pytest.raises(NotImplementedError):
        jnn.SpectralNorm([4, 3])
    with pytest.raises(NotImplementedError, match="SpectralNorm"):
        L.SpectralNorm([4, 3])


def test_norm_layers_take_param_attrs_and_no_affine():
    from paddle_tpu_torch.framework.param_attr import ParamAttr
    from paddle_tpu_torch.nn import initializer as I

    gn = L.GroupNorm(2, 4, weight_attr=ParamAttr(initializer=I.Constant(2.0)), bias_attr=False,
                     device="cpu")
    assert torch.equal(gn.weight, torch.full((4,), 2.0)) and gn.bias is None
    inorm = L.InstanceNorm1D(3, weight_attr=False, bias_attr=False, device="cpu")
    assert inorm.weight is None and inorm.bias is None
    ln = L.LayerNorm(4, weight_attr=False, bias_attr=False, device="cpu")
    x = torch.from_numpy(_x((2, 4), seed=8))
    torch.testing.assert_close(ln(x), torch.nn.functional.layer_norm(x, [4]))


# ---------------------------------------------------------------- pools

POOL_CASES = {
    "max1d": (lambda f, x: f.max_pool1d(x, 3, 2, 1), (2, 3, 9)),
    "avg1d_exclusive": (lambda f, x: f.avg_pool1d(x, 3, 2, 1), (2, 3, 9)),
    "avg1d_inclusive": (lambda f, x: f.avg_pool1d(x, 3, 2, 1, exclusive=False), (2, 3, 9)),
    "max3d": (lambda f, x: f.max_pool3d(x, 2, 2), (1, 2, 4, 5, 6)),
    "max3d_pad": (lambda f, x: f.max_pool3d(x, 3, 2, 1), (1, 2, 5, 5, 4)),
    "avg3d": (lambda f, x: f.avg_pool3d(x, [2, 3, 2], 1, 1), (1, 2, 4, 5, 3)),
    "avg3d_inclusive": (lambda f, x: f.avg_pool3d(x, 3, 2, 1, exclusive=False), (1, 2, 5, 4, 5)),
    "adaptive_avg1d": (lambda f, x: f.adaptive_avg_pool1d(x, 4), (2, 3, 9)),
    "adaptive_avg3d": (lambda f, x: f.adaptive_avg_pool3d(x, [2, 3, None]), (1, 2, 5, 7, 3)),
    "adaptive_max1d": (lambda f, x: f.adaptive_max_pool1d(x, 4), (2, 3, 9)),
    "adaptive_max2d": (lambda f, x: f.adaptive_max_pool2d(x, [3, 2]), (2, 3, 7, 5)),
    "adaptive_max3d": (lambda f, x: f.adaptive_max_pool3d(x, 2), (1, 2, 5, 4, 3)),
    "max2d_pad_wide": (lambda f, x: f.max_pool2d(x, 2, 1, 1), (2, 3, 5, 4)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pools_match_paddle_tpu(case):
    fn, shape = POOL_CASES[case]
    _both(lambda x: fn(JF, x), lambda x: fn(F, x), [_x(shape, seed=9)])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_max_pool_mask_matches_paddle_tpu_and_unpools(n):
    """``return_mask``: the flat index into the unpadded input, as the
    reference's; ``max_unpool*`` puts each max back there."""
    shape = {1: (2, 3, 9), 2: (2, 3, 7, 6), 3: (1, 2, 5, 4, 6)}[n]
    x = _x(shape, seed=10)
    pool = getattr(F, f"max_pool{n}d")
    jy, jm = getattr(JF, f"max_pool{n}d")(paddle.to_tensor(x), 3, 2, 1, return_mask=True)
    y, mask = pool(torch.from_numpy(x), 3, 2, 1, return_mask=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy.numpy()), **VALUE)
    assert mask.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm.numpy()))
    back = getattr(F, f"max_unpool{n}d")(y, mask, 3, 2, 1, output_size=list(shape))
    flat_x, flat_b = x.reshape(x.shape[0], x.shape[1], -1), back.reshape(x.shape[0], x.shape[1], -1)
    idx = mask.reshape(x.shape[0], x.shape[1], -1).long()
    np.testing.assert_array_equal(flat_b.gather(2, idx).numpy(),
                                  np.take_along_axis(flat_x, idx.numpy(), 2))
    kept = torch.zeros_like(flat_b, dtype=torch.bool).scatter_(2, idx, True)
    assert not flat_b[~kept].any()  # zeros wherever no max came from


def _np_pool(x, n, k, s, pads, ceil, maxed, exclusive=True, divisor=None):
    """Paddle's pool over the last ``n`` dims of ``x`` (float64), by an
    explicit window loop: output ``(in + a + b - k + (s - 1 if ceil)) // s +
    1`` long; window ``[o s - a, o s - a + k)`` clipped to the input; max
    (-inf over an empty window, mask -1) with its flat index, or the sum over
    ``divisor``, the clipped window's size (exclusive; 1 when empty) or
    ``prod(k)``."""
    sizes = x.shape[-n:]
    outs = [(sz + a + b - kk + (ss - 1 if ceil else 0)) // ss + 1
            for sz, (a, b), kk, ss in zip(sizes, pads, k, s)]
    y = np.empty(x.shape[:-n] + tuple(outs))
    mask = np.zeros(y.shape, np.int64)
    for o in itertools.product(*[range(v) for v in outs]):
        box = []
        for d in range(n):
            lo = o[d] * s[d] - pads[d][0]
            box.append((max(lo, 0), min(lo + k[d], sizes[d])))
        win = x[(Ellipsis,) + tuple(slice(a, b) for a, b in box)]
        count = math.prod(max(b - a, 0) for a, b in box)
        flat = win.reshape(win.shape[:-n] + (-1,))
        if maxed:
            if count == 0:
                y[(Ellipsis,) + o], mask[(Ellipsis,) + o] = -np.inf, -1
                continue
            arg = flat.argmax(-1)
            y[(Ellipsis,) + o] = flat.max(-1)
            local = np.unravel_index(arg, [b - a for a, b in box])
            g = np.zeros_like(arg)
            for d in range(n):
                g = g * sizes[d] + local[d] + box[d][0]
            mask[(Ellipsis,) + o] = g
        else:
            total = flat.sum(-1) if count else np.zeros(x.shape[:-n])
            div = divisor or (max(count, 1) if exclusive else math.prod(k))
            y[(Ellipsis,) + o] = total / div
    return y, mask


WINDOW_CASES = {
    # ceil_mode with a last window torch would drop (it starts in the padding)
    "max2d_ceil": dict(n=2, shape=(2, 2, 5, 6), k=2, s=2, p=1, ceil=True, maxed=True),
    "max1d_ceil": dict(n=1, shape=(2, 3, 8), k=3, s=2, p=0, ceil=True, maxed=True),
    "max3d_ceil": dict(n=3, shape=(1, 2, 5, 4, 5), k=2, s=2, p=0, ceil=True, maxed=True),
    "avg2d_ceil_exclusive": dict(n=2, shape=(2, 2, 5, 6), k=3, s=2, p=1, ceil=True, maxed=False),
    "avg2d_ceil_inclusive": dict(n=2, shape=(2, 2, 5, 7), k=3, s=2, p=1, ceil=True, maxed=False,
                                 exclusive=False),
    "avg1d_ceil": dict(n=1, shape=(2, 3, 8), k=3, s=2, p=0, ceil=True, maxed=False),
    "avg3d_ceil": dict(n=3, shape=(1, 2, 5, 4, 5), k=2, s=2, p=0, ceil=True, maxed=False),
    "avg2d_divisor": dict(n=2, shape=(2, 2, 6, 5), k=3, s=2, p=1, ceil=False, maxed=False,
                          divisor=4),
    "avg2d_ceil_divisor": dict(n=2, shape=(2, 2, 6, 5), k=3, s=2, p=1, ceil=True, maxed=False,
                               divisor=5),
    "max2d_nhwc": dict(n=2, shape=(2, 2, 7, 7), k=3, s=2, p=0, ceil=False, maxed=True, last=True),
    "avg2d_nhwc_ceil": dict(n=2, shape=(2, 3, 5, 6), k=2, s=2, p=1, ceil=True, maxed=False,
                            last=True),
    "max3d_ndhwc": dict(n=3, shape=(1, 2, 4, 5, 3), k=2, s=1, p=1, ceil=False, maxed=True,
                        last=True),
    "avg3d_ndhwc": dict(n=3, shape=(1, 2, 4, 5, 3), k=2, s=2, p=0, ceil=True, maxed=False,
                        last=True),
    "max2d_asymmetric_pad": dict(n=2, shape=(1, 2, 5, 6), k=3, s=2, p=[1, 0, 0, 2], ceil=False,
                                 maxed=True),
    "max2d_pad_over_half": dict(n=2, shape=(1, 2, 5, 5), k=3, s=1, p=2, ceil=False, maxed=True),
}


def _port_pool(c, v, return_mask=False):
    n = c["n"]
    fmt = {1: "NCL", 2: "NHWC" if c.get("last") else "NCHW",
           3: "NDHWC" if c.get("last") else "NCDHW"}[n]
    kw = dict(ceil_mode=c["ceil"])
    if n > 1:
        kw["data_format"] = fmt
    if c["maxed"]:
        return getattr(F, f"max_pool{n}d")(v, c["k"], c["s"], c["p"], return_mask=return_mask,
                                           **kw)
    kw["exclusive"] = c.get("exclusive", True)
    if n > 1:
        kw["divisor_override"] = c.get("divisor")
    return getattr(F, f"avg_pool{n}d")(v, c["k"], c["s"], c["p"], **kw)


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_pools_against_a_window_loop(case):
    """``ceil_mode``, ``divisor_override``, channel-last layouts and the
    paddings torch's pools refuse (wider than half the kernel, uneven),
    with the masks of the max pools."""
    c = WINDOW_CASES[case]
    n = c["n"]
    x = _x(c["shape"], seed=11, dtype=np.float64)
    k, s = [c["k"]] * n, [c["s"]] * n
    p = c["p"]
    pads = ([(p, p)] * n if isinstance(p, int) else [(p[2 * i], p[2 * i + 1]) for i in range(n)])
    want, want_mask = _np_pool(x, n, k, s, pads, c["ceil"], c["maxed"], c.get("exclusive", True),
                               c.get("divisor"))
    v = torch.from_numpy(np.moveaxis(x, 1, -1).copy() if c.get("last") else x)
    out = _port_pool(c, v, return_mask=c["maxed"])
    got, mask = out if c["maxed"] else (out, None)
    if c.get("last"):
        got = got.movedim(-1, 1)
        mask = None if mask is None else mask.movedim(-1, 1)
    np.testing.assert_allclose(got.numpy(), want, **EXACT64)
    if mask is not None:
        np.testing.assert_array_equal(mask.numpy(), want_mask)
    # a window of padding only holds -inf, a constant: checked as 0
    _gradcheck(lambda t: _port_pool(c, t).nan_to_num(neginf=0.0), v.numpy())


@pytest.mark.parametrize("n", [1, 2, 3])
def test_adaptive_max_pool_mask_against_a_window_loop(n):
    """``return_mask`` of the adaptive max pools (the reference ignores
    it): windows ``[floor(i in / out), ceil((i + 1) in / out))``."""
    shape = {1: (2, 3, 9), 2: (2, 2, 7, 5), 3: (1, 2, 5, 4, 3)}[n]
    outs = {1: [4], 2: [3, 2], 3: [2, 3, 2]}[n]
    x = _x(shape, seed=12, dtype=np.float64)
    y, mask = getattr(F, f"adaptive_max_pool{n}d")(torch.from_numpy(x), outs, return_mask=True)
    sizes = shape[-n:]
    for o in itertools.product(*[range(v) for v in outs]):
        box = [(math.floor(o[d] * sizes[d] / outs[d]), math.ceil((o[d] + 1) * sizes[d] / outs[d]))
               for d in range(n)]
        win = x[(Ellipsis,) + tuple(slice(a, b) for a, b in box)].reshape(shape[:2] + (-1,))
        np.testing.assert_allclose(y.numpy()[(Ellipsis,) + o], win.max(-1), **EXACT64)
        local = np.unravel_index(win.argmax(-1), [b - a for a, b in box])
        g = np.zeros(shape[:2], np.int64)
        for d in range(n):
            g = g * sizes[d] + local[d] + box[d][0]
        np.testing.assert_array_equal(mask.numpy()[(Ellipsis,) + o], g)


POOL_LAYERS = {
    "MaxPool1D": ((3, 2, 1), (2, 3, 9)), "MaxPool3D": ((2,), (1, 2, 4, 4, 4)),
    "AvgPool1D": ((3, 2, 1), (2, 3, 9)), "AvgPool3D": ((2, 2), (1, 2, 4, 4, 4)),
    "AdaptiveAvgPool1D": ((3,), (2, 3, 8)), "AdaptiveAvgPool3D": ((2,), (1, 2, 5, 4, 3)),
    "AdaptiveMaxPool1D": ((3,), (2, 3, 8)), "AdaptiveMaxPool2D": ((2,), (2, 3, 5, 4)),
    "AdaptiveMaxPool3D": ((2,), (1, 2, 5, 4, 3)),
}


@pytest.mark.parametrize("name", sorted(POOL_LAYERS))
def test_pool_layers_match_paddle_tpu(name):
    args, shape = POOL_LAYERS[name]
    _both(getattr(jnn, name)(*args), getattr(L, name)(*args), [_x(shape, seed=13)])


def test_pool_layers_pass_their_knobs():
    x = torch.from_numpy(_x((1, 5, 6, 2), seed=14))
    m = L.MaxPool2D(2, 2, 1, return_mask=True, ceil_mode=True, data_format="NHWC")
    y, mask = m(x)
    y2, mask2 = F.max_pool2d(x, 2, 2, 1, True, True, "NHWC")
    assert torch.equal(y, y2) and torch.equal(mask, mask2) and tuple(y.shape) == (1, 4, 4, 2)
    a = L.AvgPool2D(3, 2, 1, ceil_mode=True, exclusive=False, divisor_override=2,
                    data_format="NHWC")
    assert torch.equal(a(x), F.avg_pool2d(x, 3, 2, 1, True, False, 2, "NHWC"))
    am = L.AdaptiveMaxPool2D(3, return_mask=True)
    assert torch.equal(am(x.movedim(-1, 1))[1], F.adaptive_max_pool2d(x.movedim(-1, 1), 3, True)[1])
    assert torch.equal(L.AdaptiveAvgPool2D(2, data_format="NHWC")(x),
                       F.adaptive_avg_pool2d(x, 2, "NHWC"))


# ---------------------------------------------------------------- convolutions

TRANSPOSE_CASES = {
    "2d_plain": dict(n=2, x=(2, 4, 5, 5), w=(4, 3, 3, 3)),
    "2d_stride_pad": dict(n=2, x=(2, 4, 5, 4), w=(4, 3, 3, 3), stride=2, padding=1),
    "2d_output_padding": dict(n=2, x=(2, 4, 5, 5), w=(4, 3, 3, 2), stride=2, padding=1,
                              output_padding=1),
    "1d": dict(n=1, x=(2, 3, 7), w=(3, 2, 4), stride=3, padding=2),
    "3d": dict(n=3, x=(1, 2, 3, 4, 3), w=(2, 3, 2, 3, 2), stride=2, padding=1),
    "2d_no_bias": dict(n=2, x=(2, 4, 5, 5), w=(4, 3, 3, 3), stride=2, bias=False),
}


@pytest.mark.parametrize("case", sorted(TRANSPOSE_CASES))
def test_transposed_convs_match_paddle_tpu(case):
    """Stride, padding and ``output_padding``, where the reference agrees
    with the definition."""
    c = dict(TRANSPOSE_CASES[case])
    n, xs, ws, bias = c.pop("n"), c.pop("x"), c.pop("w"), c.pop("bias", True)
    arrays = [_x(xs, seed=15), 0.3 * _x(ws, seed=16)] + ([_x((ws[1],), seed=17)] if bias else [])
    name = f"conv{n}d_transpose"
    _both(lambda *a: getattr(JF, name)(a[0], a[1], a[2] if bias else None, **c),
          lambda *a: getattr(F, name)(a[0], a[1], a[2] if bias else None, **c), arrays)


def _np_conv_transpose(x, w, b, n, stride, pads, extra, dilation, groups):
    """The transposed convolution by its definition, float64: each input
    element scatters its kernel ``w[ci, co']`` (``co`` = ``g * out_g +
    co'``) into the full output at ``i s + t d``; then ``pads`` cut from
    each end and ``extra`` zeros added at the end; then the bias."""
    N, cin = x.shape[:2]
    ks = w.shape[2:]
    out_g = w.shape[1]
    sizes = x.shape[2:]
    full = [(sz - 1) * s + d * (k - 1) + 1 for sz, s, d, k in zip(sizes, stride, dilation, ks)]
    y = np.zeros((N, out_g * groups) + tuple(f + e for f, e in zip(full, extra)))
    in_g = cin // groups
    for ci in range(cin):
        g = ci // in_g
        for i in itertools.product(*[range(v) for v in sizes]):
            for t in itertools.product(*[range(v) for v in ks]):
                pos = tuple(i[d] * stride[d] + t[d] * dilation[d] for d in range(n))
                y[(slice(None), slice(g * out_g, (g + 1) * out_g)) + pos] += (
                    x[(slice(None), ci) + i][:, None] * w[(ci, slice(None)) + t][None, :])
    cut = tuple(slice(a, y.shape[2 + d] - bb) for d, (a, bb) in enumerate(pads))
    y = y[(slice(None), slice(None)) + cut]
    return y + (0 if b is None else b.reshape((1, -1) + (1,) * n))


FAULT_CASES = {
    "2d_dilation2": dict(n=2, x=(2, 4, 5, 5), w=(4, 3, 3, 3), dilation=2),
    "2d_dilation2_stride_pad": dict(n=2, x=(1, 2, 4, 3), w=(2, 2, 3, 2), dilation=2, stride=2,
                                    padding=1),
    "2d_groups2": dict(n=2, x=(2, 4, 4, 4), w=(4, 3, 3, 3), groups=2, stride=2, padding=1),
    "1d_groups2_dilation2": dict(n=1, x=(2, 4, 6), w=(4, 2, 3), groups=2, dilation=2),
    "2d_output_size": dict(n=2, x=(1, 2, 4, 4), w=(2, 3, 3, 3), stride=3, padding=1,
                           output_size=[12, 11]),
    "2d_uneven_padding": dict(n=2, x=(1, 2, 4, 3), w=(2, 2, 3, 3), stride=2,
                              padding=[1, 0, 2, 1], output_padding=1),
    "3d_groups2": dict(n=3, x=(1, 4, 2, 3, 2), w=(4, 1, 2, 2, 2), groups=2, stride=2),
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_transposed_convs_against_their_definition(case):
    """Dilation, groups, ``output_size`` and uneven padding: Paddle's
    definition, which the reference's misses."""
    c = dict(FAULT_CASES[case])
    n, xs, ws = c.pop("n"), c.pop("x"), c.pop("w")
    x, w = _x(xs, seed=18, dtype=np.float64), 0.3 * _x(ws, seed=19, dtype=np.float64)
    b = _x((ws[1] * c.get("groups", 1),), seed=20, dtype=np.float64)
    fn = getattr(F, f"conv{n}d_transpose")
    got = fn(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), **c)
    stride = [c.get("stride", 1)] * n
    dilation = [c.get("dilation", 1)] * n
    p = c.get("padding", 0)
    pads = [(p, p)] * n if isinstance(p, int) else [(p[2 * i], p[2 * i + 1]) for i in range(n)]
    ks = ws[2:]
    full = [(sz - 1) * s + d * (k - 1) + 1 for sz, s, d, k in zip(xs[2:], stride, dilation, ks)]
    if "output_size" in c:
        extra = [o - (f - a - bb) for o, f, (a, bb) in zip(c["output_size"], full, pads)]
    else:
        extra = [c.get("output_padding", 0)] * n
    want = _np_conv_transpose(x, w, b, n, stride, pads, extra, dilation, c.get("groups", 1))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **EXACT64)
    _gradcheck(lambda *a: fn(*a, **c), x[:1], w, b)


def test_transposed_conv_output_size_checks():
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(2, 3, 3, 3)
    assert tuple(F.conv2d_transpose(x, w, stride=2, output_size=[10, 9]).shape) == (1, 3, 10, 9)
    with pytest.raises(ValueError, match="not reachable"):
        F.conv2d_transpose(x, w, stride=2, output_size=[11, 9])
    with pytest.raises(ValueError, match="mutually exclusive"):
        F.conv2d_transpose(x, w, stride=2, output_padding=1, output_size=[10, 10])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_channel_last_convs_match_paddle_tpu(n):
    fmt = {1: "NLC", 2: "NHWC", 3: "NDHWC"}[n]
    xs = (2,) + (5,) * n + (4,)
    arrays = [_x(xs, seed=21), 0.3 * _x((6, 2) + (3,) * n, seed=22), _x((6,), seed=23)]
    name = f"conv{n}d"
    _both(lambda *a: getattr(JF, name)(*a, stride=2, padding=1, groups=2, data_format=fmt),
          lambda *a: getattr(F, name)(*a, stride=2, padding=1, groups=2, data_format=fmt), arrays)


def test_channel_last_transposed_conv_is_channel_first_moved():
    x = torch.from_numpy(_x((2, 4, 5, 4), seed=24))
    w = torch.from_numpy(_x((4, 3, 3, 3), seed=25))
    got = F.conv2d_transpose(x, w, stride=2, padding=1, dilation=2, data_format="NHWC")
    want = F.conv2d_transpose(x.movedim(-1, 1), w, stride=2, padding=1, dilation=2)
    torch.testing.assert_close(got, want.movedim(1, -1))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_transposed_conv_layers_match_paddle_tpu(n):
    """The reference's init (weight ``[in, out / groups, *k]`` Normal(0,
    sqrt(2 / (in / groups * k...))), a zero bias) and the forward with
    weights carried across."""
    name = f"Conv{n}DTranspose"
    paddle.seed(26)
    jm = getattr(jnn, name)(4, 6, 3, stride=2, padding=1)
    pm = getattr(L, name)(4, 6, 3, stride=2, padding=1, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert tuple(pm.weight.shape) == tuple(jm.weight.shape) == (4, 6) + (3,) * n
    assert not pm.bias.any()
    big = getattr(L, name)(64, 32, 3, groups=2, device="cpu")
    std = math.sqrt(2.0 / (32 * 3 ** n))
    assert abs(float(big.weight.detach().std()) / std - 1) < 0.05
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    pm.load_state_dict(state_dict_by_name(state, pm))
    _both(jm, pm, [_x((2, 4) + (4,) * n, seed=27)])
    out = pm(torch.zeros((1, 4) + (4,) * n), output_size=[8] * n)
    assert tuple(out.shape[2:]) == (8,) * n


def test_nn_namespace_holds_the_layers_and_clips():
    from paddle_tpu_torch.nn import clip

    for name in ("Linear", "Conv2DTranspose", "GroupNorm", "MaxPool3D", "AdaptiveMaxPool2D",
                 "LayerList", "SpectralNorm", "RMSNorm"):
        assert getattr(pnn, name) is getattr(L, name), name
    assert pnn.ClipGradByGlobalNorm is clip.ClipGradByGlobalNorm
    assert pnn.functional.conv3d_transpose is F.conv3d_transpose

"""The first half of the port's ``nn`` layer library against ``paddle_tpu``'s,
on the CPU: the containers, the common functionals and layers, the
activations, and the initialisers.

The same numpy inputs go through both packages; f32 results agree to atol
1e-6 / rtol 1e-5 (elementwise formulas, sums of a few terms in another
order), the resampling of ``interpolate`` to atol 1e-5. A layer with
weights gets the reference's by name. The random activations draw from
the generator each side is handed; their deterministic parts (eval
``rrelu``, ``gumbel_softmax``'s shape and simplex) are compared. The
deterministic initialisers are held exactly; the random ones by their
moments (mean within 5 standard errors, std within 5%), fans and bounds,
with the reference's fan rule, including ``[E, D, H]`` read as a conv
kernel.
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
from paddle_tpu.nn import initializer as jI  # noqa: E402

from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from paddle_tpu_torch.nn import initializer as I  # noqa: E402
from paddle_tpu_torch.nn import layer as L  # noqa: E402
from paddle_tpu_torch.utils.convert import state_dict_by_name  # noqa: E402

TOL = dict(atol=1e-6, rtol=1e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.numpy())


def _both(fn_ref, fn_port, *arrays):
    want = fn_ref(*(paddle.to_tensor(a) for a in arrays))
    got = fn_port(*(torch.from_numpy(a) for a in arrays))
    return _np(got), _np(want)


# -- containers ----------------------------------------------------------------------------
def test_containers_match_reference():
    """Sequential (positional and named), LayerList (append, insert,
    negative index, slice), ParameterList and LayerDict: the same child
    names, state-dict keys and forward."""
    paddle.seed(1)
    jseq = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 3))
    tseq = L.Sequential(L.Linear(4, 8, device="cpu"), L.ReLU(), L.Linear(8, 3, device="cpu"))
    tseq.load_state_dict(state_dict_by_name({k: _np(v) for k, v in jseq.state_dict().items()},
                                            tseq))
    x = _x((5, 4), 2)
    np.testing.assert_allclose(*_both(jseq, tseq, x), **TOL)
    assert len(tseq) == len(jseq) == 3 and isinstance(tseq[1], L.ReLU)
    named = L.Sequential(("lin", L.Linear(4, 2, device="cpu")), ("act", L.Tanh()))
    jnamed = jnn.Sequential(("lin", jnn.Linear(4, 2)), ("act", jnn.Tanh()))
    assert list(named.state_dict()) == list(jnamed.state_dict()) == ["lin.weight", "lin.bias"]
    assert list(L.Sequential([("a", L.ReLU())]).named_children())[0][0] == "a"
    ll = L.LayerList([L.ReLU(), L.Tanh()])
    ll.append(L.Sigmoid())
    ll.insert(0, L.Identity())
    assert [type(m).__name__ for m in ll] == ["Identity", "ReLU", "Tanh", "Sigmoid"]
    assert isinstance(ll[-1], L.Sigmoid) and len(ll[1:3]) == 2
    pl = L.ParameterList([torch.nn.Parameter(torch.ones(2))])
    pl.append(torch.nn.Parameter(torch.zeros(3)))
    assert len(pl) == 2 and list(dict(pl.named_parameters())) == ["0", "1"]
    ld = L.LayerDict({"a": L.ReLU(), "b": L.Tanh()})
    ld["c"] = L.Sigmoid()
    del ld["a"]
    assert list(ld) == ["b", "c"] and list(ld.keys()) == ["b", "c"]


# -- common functionals --------------------------------------------------------------------
FUNCTIONALS = {
    "one_hot": (lambda F, x: F.one_hot(x, 7), [np.array([[0, 3], [6, 2]])]),
    "label_smooth": (lambda F, x: F.label_smooth(x, epsilon=0.2), [np.eye(4, dtype=np.float32)]),
    "label_smooth_prior": (lambda F, x, p: F.label_smooth(x, prior_dist=p, epsilon=0.1),
                           [np.eye(4, dtype=np.float32),
                            np.full((1, 4), 0.25, np.float32)]),
    "pad_constant": (lambda F, x: F.pad(x, [1, 2, 0, 1], value=0.5), [_x((2, 3, 4, 5))]),
    "pad_all_dims": (lambda F, x: F.pad(x, [0, 0, 1, 0, 2, 1]), [_x((2, 3, 4))]),
    "pad_reflect": (lambda F, x: F.pad(x, [1, 2, 2, 1], mode="reflect"), [_x((2, 3, 4, 5))]),
    "pad_replicate": (lambda F, x: F.pad(x, [2, 1], mode="replicate"), [_x((2, 3, 5))]),
    "pad_circular_nhwc": (lambda F, x: F.pad(x, [1, 1, 2, 0], mode="circular",
                                             data_format="NHWC"), [_x((2, 4, 5, 3))]),
    "normalize": (lambda F, x: F.normalize(x, axis=1), [_x((3, 5))]),
    "normalize_p1": (lambda F, x: F.normalize(x, p=1, axis=-1), [_x((3, 5))]),
    "cosine_similarity": (lambda F, a, b: F.cosine_similarity(a, b, axis=1),
                          [_x((3, 5), 1), _x((3, 5), 2)]),
    "bilinear": (lambda F, a, b, w, c: F.bilinear(a, b, w, c),
                 [_x((3, 4), 1), _x((3, 5), 2), _x((2, 4, 5), 3), _x((2,), 4)]),
    "interpolate_nearest_up": (lambda F, x: F.interpolate(x, scale_factor=2), [_x((1, 2, 3, 4))]),
    "interpolate_nearest_down": (lambda F, x: F.interpolate(x, size=[2, 3]), [_x((1, 2, 5, 7))]),
    "interpolate_bilinear_up": (lambda F, x: F.interpolate(x, size=[5, 7], mode="bilinear"),
                                [_x((1, 2, 3, 4))]),
    "interpolate_bilinear_down": (lambda F, x: F.interpolate(x, size=[3, 2], mode="bilinear"),
                                  [_x((1, 2, 7, 5))]),
    "interpolate_bicubic": (lambda F, x: F.interpolate(x, size=[6, 5], mode="bicubic"),
                            [_x((1, 2, 4, 3))]),
    "interpolate_nhwc": (lambda F, x: F.interpolate(x, scale_factor=2, mode="bilinear",
                                                    data_format="NHWC"), [_x((1, 3, 4, 2))]),
    "upsample": (lambda F, x: F.upsample(x, scale_factor=3), [_x((1, 1, 2, 2))]),
    "unfold": (lambda F, x: F.unfold(x, 3, strides=2, paddings=1), [_x((2, 3, 6, 5))]),
    "unfold_dilated": (lambda F, x: F.unfold(x, [2, 3], dilations=[2, 1]), [_x((1, 2, 6, 6))]),
}


@pytest.mark.parametrize("case", sorted(FUNCTIONALS))
def test_common_functionals_match_reference(case):
    fn, arrays = FUNCTIONALS[case]
    tol = dict(atol=1e-5, rtol=1e-5) if case.startswith(("interpolate", "upsample")) else TOL
    got, want = _both(lambda *a: fn(jF, *a), lambda *a: fn(tF, *a), *arrays)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want.astype(got.dtype), **tol)


LAYERS = {
    "Identity": (lambda nn: nn.Identity(), [_x((2, 3))]),
    "Flatten": (lambda nn: nn.Flatten(), [_x((2, 3, 4, 5))]),
    "Flatten_range": (lambda nn: nn.Flatten(0, 2), [_x((2, 3, 4, 5))]),
    "Upsample": (lambda nn: nn.Upsample(scale_factor=2, mode="bilinear"), [_x((1, 2, 3, 3))]),
    "UpsamplingNearest2D": (lambda nn: nn.UpsamplingNearest2D(size=[4, 6]), [_x((1, 2, 2, 3))]),
    "UpsamplingBilinear2D": (lambda nn: nn.UpsamplingBilinear2D(scale_factor=2),
                             [_x((1, 2, 2, 3))]),
    "Pad1D": (lambda nn: nn.Pad1D([1, 2], mode="reflect"), [_x((2, 3, 5))]),
    "Pad2D": (lambda nn: nn.Pad2D([1, 0, 2, 1]), [_x((2, 3, 4, 5))]),
    "Pad3D": (lambda nn: nn.Pad3D([1, 1, 0, 1, 2, 0], mode="replicate"), [_x((1, 2, 3, 4, 5))]),
    "ZeroPad2D": (lambda nn: nn.ZeroPad2D([2, 2, 1, 1]), [_x((1, 2, 3, 3))]),
    "CosineSimilarity": (lambda nn: nn.CosineSimilarity(axis=-1), [_x((3, 4), 1), _x((3, 4), 2)]),
    "Unfold": (lambda nn: nn.Unfold(2, strides=1, paddings=0), [_x((1, 2, 4, 4))]),
    "Dropout_eval": (lambda nn: nn.Dropout(0.5).eval(), [_x((3, 4))]),
    "Dropout2D_eval": (lambda nn: nn.Dropout2D(0.5).eval(), [_x((1, 2, 3, 3))]),
    "Dropout3D_eval": (lambda nn: nn.Dropout3D(0.5).eval(), [_x((1, 2, 3, 3, 2))]),
    "AlphaDropout_eval": (lambda nn: nn.AlphaDropout(0.5).eval(), [_x((3, 4))]),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_common_layers_match_reference(case):
    make, arrays = LAYERS[case]
    got, want = _both(make(jnn), make(L), *arrays)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bilinear_and_linear_layers_carry_weights():
    """``Bilinear`` and ``Linear`` (with ``bias_attr=False``): the
    reference's names and shapes, its weights carried across, the same
    output; Bilinear's weight drawn within +-1/sqrt(in1)."""
    paddle.seed(3)
    jb, jl = jnn.Bilinear(4, 5, 3), jnn.Linear(4, 3, bias_attr=False)
    tb, tl = L.Bilinear(4, 5, 3, device="cpu"), L.Linear(4, 3, bias_attr=False, device="cpu")
    assert float(tb.weight.abs().max()) <= 1 / math.sqrt(4) and tl.bias is None
    for j, t in ((jb, tb), (jl, tl)):
        t.load_state_dict(state_dict_by_name({k: _np(v) for k, v in j.state_dict().items()}, t))
    a, b = _x((2, 4), 4), _x((2, 5), 5)
    np.testing.assert_allclose(*_both(jb, tb, a, b), **TOL)
    np.testing.assert_allclose(*_both(jl, tl, a), **TOL)


# -- activations ---------------------------------------------------------------------------
ACTIVATIONS = {
    "relu": {}, "relu6": {}, "elu": dict(alpha=0.7), "selu": {}, "gelu": {},
    "gelu_tanh": None, "sigmoid": {}, "hardsigmoid": {}, "hardswish": {},
    "hardtanh": dict(min=-0.5, max=0.8), "hardshrink": dict(threshold=0.3),
    "softshrink": dict(threshold=0.3), "tanhshrink": {}, "leaky_relu": dict(negative_slope=0.2),
    "swish": {}, "silu": {}, "mish": {}, "softplus": dict(beta=2, threshold=3), "softsign": {},
    "tanh": {}, "softmax": dict(axis=0), "log_softmax": {}, "log_sigmoid": {},
    "celu": dict(alpha=0.5), "thresholded_relu": dict(threshold=0.4), "glu": dict(axis=-1),
    "maxout": dict(groups=2, axis=1),
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_functionals_match_reference(name):
    kw = ACTIVATIONS[name]
    x = 3 * _x((2, 4, 3, 2), 6)
    if kw is None:
        got, want = _both(lambda v: jF.gelu(v, approximate=True),
                          lambda v: tF.gelu(v, approximate=True), x)
    else:
        got, want = _both(lambda v: getattr(jF, name)(v, **kw),
                          lambda v: getattr(tF, name)(v, **kw), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_random_and_parametric_activations():
    """``prelu`` (one slope and per channel), eval ``rrelu`` and the
    ``RReLU`` layer, ``PReLU``'s initial value, and ``gumbel_softmax``
    (soft: a simplex; hard: one-hot rows with the soft gradient)."""
    x = 2 * _x((2, 3, 4), 7)
    for w in (np.array([0.3], np.float32), np.array([0.1, 0.2, 0.3], np.float32)):
        np.testing.assert_allclose(*_both(jF.prelu, tF.prelu, x, w), **TOL)
    np.testing.assert_allclose(*_both(lambda v: jF.rrelu(v, training=False),
                                      lambda v: tF.rrelu(v, training=False), x), **TOL)
    g = torch.Generator().manual_seed(1)
    y = tF.rrelu(torch.from_numpy(x), 0.1, 0.3, generator=g)
    neg = torch.from_numpy(x) < 0
    slope = (y / torch.from_numpy(x))[neg]
    assert bool(((slope >= 0.1) & (slope <= 0.3)).all()) and torch.equal(y[~neg],
                                                                       torch.from_numpy(x)[~neg])
    assert torch.equal(L.RReLU().eval()(torch.from_numpy(x)), tF.rrelu(torch.from_numpy(x),
                                                                        training=False))
    pr = L.PReLU(3, init=0.2, device="cpu")
    assert torch.equal(pr.weight, torch.full((3,), 0.2))
    np.testing.assert_allclose(*_both(jnn.PReLU(3, init=0.2), pr, x), **TOL)
    logits = torch.from_numpy(x).requires_grad_()
    soft = tF.gumbel_softmax(logits, temperature=0.5, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(soft.sum(-1), torch.ones(2, 3))
    hard = tF.gumbel_softmax(logits, hard=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(hard.detach().sum(-1), torch.ones(2, 3)) and set(hard.unique().tolist()) <= {0.0, 1.0}
    (hard * torch.arange(4.0)).sum().backward()
    assert logits.grad is not None and float(logits.grad.abs().sum()) > 0


LAYER_ACTS = {"ReLU": {}, "ReLU6": {}, "Sigmoid": {}, "Tanh": {}, "Hardswish": {},
              "Hardsigmoid": {}, "Silu": {}, "Swish": {}, "Mish": {}, "Softsign": {},
              "Tanhshrink": {}, "LogSigmoid": {}, "GELU": dict(approximate=True),
              "LeakyReLU": dict(negative_slope=0.3), "ELU": dict(alpha=0.5), "SELU": {},
              "CELU": dict(alpha=2.0), "Hardtanh": dict(min=-2.0, max=1.0),
              "Hardshrink": dict(threshold=0.2), "Softshrink": dict(threshold=0.2),
              "Softplus": dict(beta=3, threshold=5), "Softmax": dict(axis=1),
              "LogSoftmax": dict(axis=1), "GLU": dict(axis=1), "Maxout": dict(groups=2)}


@pytest.mark.parametrize("name", sorted(LAYER_ACTS))
def test_activation_layers_match_reference(name):
    kw = LAYER_ACTS[name]
    x = 2 * _x((2, 4, 3), 8)
    np.testing.assert_allclose(*_both(getattr(jnn, name)(**kw), getattr(L, name)(**kw), x), **TOL)


# -- initializers -----------------------------------------------------------------------------
DETERMINISTIC = {
    "Constant": (lambda M: M.Constant(0.25), (3, 4)),
    "Assign": (lambda M: M.Assign(np.arange(6, dtype=np.float32).reshape(2, 3)), (2, 3)),
    "Dirac": (lambda M: M.Dirac(), (4, 2, 3, 3)),
    "Dirac_groups": (lambda M: M.Dirac(groups=2), (4, 2, 3)),
    "Bilinear": (lambda M: M.Bilinear(), (2, 2, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(DETERMINISTIC))
def test_deterministic_initializers_equal_reference(case):
    make, shape = DETERMINISTIC[case]
    np.testing.assert_array_equal(make(I)(shape).numpy(), np.asarray(make(jI)(shape)))


def _fan_std(shape, kind):
    fi, fo = jI._fans(shape)
    return {"XavierNormal": math.sqrt(2.0 / (fi + fo)), "XavierUniform": math.sqrt(2.0 / (fi + fo)),
            "KaimingNormal": math.sqrt(2.0 / fi), "KaimingUniform": math.sqrt(2.0 / fi)}[kind]


RANDOM = {
    "Normal": (lambda M: M.Normal(0.5, 2.0), (200, 300), 0.5, 2.0, None),
    "TruncatedNormal": (lambda M: M.TruncatedNormal(-1.0, 0.5), (200, 300), -1.0,
                        0.5 * 0.8796, (-2.0, 0.0)),
    "Uniform": (lambda M: M.Uniform(-0.2, 0.6), (200, 300), 0.2, 0.8 / math.sqrt(12), (-0.2, 0.6)),
    "XavierNormal": (lambda M: M.XavierNormal(), (256, 384), 0.0, None, None),
    "XavierUniform": (lambda M: M.XavierUniform(), (256, 384), 0.0, None, "fan"),
    "KaimingNormal": (lambda M: M.KaimingNormal(), (64, 32, 3, 3), 0.0, None, None),
    "KaimingUniform": (lambda M: M.KaimingUniform(), (64, 32, 3, 3), 0.0, None, "fan"),
    "XavierNormal_experts": (lambda M: M.XavierNormal(), (8, 64, 256), 0.0, None, None),
}


@pytest.mark.parametrize("case", sorted(RANDOM))
def test_random_initializers_by_moments_fans_and_bounds(case):
    """Mean within 5 standard errors, std within 5% of the reference's
    formula (its fan rule; ``[E, D, H]`` read as a conv kernel), bounds
    held; the reference's draws pass the same checks; a generator replays."""
    make, shape, mean, std, bounds = RANDOM[case]
    kind = case.split("_")[0]
    std = std if std is not None else _fan_std(shape, kind)
    g = torch.Generator().manual_seed(3)
    port = make(I)(shape, generator=g).numpy()
    ref = np.asarray(make(jI)(shape))
    for v in (port, ref):
        assert abs(v.mean() - mean) <= 5 * std / math.sqrt(v.size), (case, v.mean())
        assert abs(v.std() / std - 1) < 0.05, (case, v.std(), std)
        if bounds == "fan":
            assert np.abs(v).max() <= std * math.sqrt(3) + 1e-6
        elif bounds is not None:
            assert v.min() >= bounds[0] - 1e-6 and v.max() <= bounds[1] + 1e-6
    np.testing.assert_array_equal(make(I)(shape, generator=torch.Generator().manual_seed(3)).numpy(),
                                  port)


def test_orthogonal_and_global_initializer():
    """``Orthogonal``: rows (or columns) orthonormal times the gain, as the
    reference's; ``set_global_initializer`` takes precedence over a layer's
    default and is reset by None; a parameter attribute's ``initializer``
    over both."""
    w = I.Orthogonal(gain=2.0)((3, 5), generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(w @ w.T, 4.0 * torch.eye(3), atol=1e-5, rtol=1e-5)
    jw = np.asarray(jI.Orthogonal(gain=2.0)((3, 5)))
    np.testing.assert_allclose(jw @ jw.T, 4.0 * np.eye(3), atol=1e-5)
    I.set_global_initializer(I.Constant(0.5), I.Constant(-1.0))
    try:
        lin = L.Linear(3, 2, device="cpu")
        assert torch.equal(lin.weight, torch.full((3, 2), 0.5))
        assert torch.equal(lin.bias, torch.full((2,), -1.0))

        class Attr:
            initializer = I.Constant(2.0)

        assert torch.equal(L.Linear(3, 2, weight_attr=Attr(), device="cpu").weight,
                           torch.full((3, 2), 2.0))
    finally:
        I.set_global_initializer(None, None)
    assert not torch.equal(L.Linear(3, 2, device="cpu").weight, torch.full((3, 2), 0.5))

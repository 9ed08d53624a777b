"""The port's ``autograd`` (``PyLayer``, ``vjp``, ``jvp``, ``jacobian``,
``hessian``) and the root's ``grad``, ``backward`` and ``no_grad``
against the reference's: ``tests/test_pylayer_functional.py``'s twelve
cases, each run through both packages on the same inputs."""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = port_device._DEVICE[0]
    port.set_device("cpu")
    yield
    port_device._DEVICE[0] = prev


def _layers(P):
    """The test file's PyLayers, written once against package ``P``."""

    class Cube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return 3 * x * x * dy

    class ScaledAdd(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, y, alpha=2.0):
            ctx.alpha = alpha
            return x + alpha * y

        @staticmethod
        def backward(ctx, dy):
            return dy, ctx.alpha * dy

    class TwoOut(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2, x * x

        @staticmethod
        def backward(ctx, d1, d2):
            (x,) = ctx.saved_tensor()
            return 2 * d1 + 2 * x * d2

    class KwargAdd(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, y=None):
            return x + 3.0 * y

        @staticmethod
        def backward(ctx, dy):
            return dy, 3.0 * dy

    class NoMaterialize(P.autograd.PyLayer):
        seen = []

        @staticmethod
        def forward(ctx, x):
            ctx.set_materialize_grads(False)
            return x * 2, x * 5

        @staticmethod
        def backward(ctx, d1, d2):
            NoMaterialize.seen = [d1, d2]
            g = 0.0
            if d1 is not None:
                g = g + 2 * d1
            if d2 is not None:
                g = g + 5 * d2
            return g

    class Twice(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            return a + 2 * b

        @staticmethod
        def backward(ctx, dy):
            return dy, 2 * dy

    class MaxIdx(P.autograd.PyLayer):
        """A non-differentiable index output beside a differentiable one."""

        @staticmethod
        def forward(ctx, x):
            idx = P.argmax(x, axis=0)
            ctx.mark_non_differentiable(idx)
            ctx.save_for_backward(x)
            return x * 2.0, idx

        @staticmethod
        def backward(ctx, dy, didx=None):
            return dy * 2.0

    return dict(Cube=Cube, ScaledAdd=ScaledAdd, TwoOut=TwoOut, KwargAdd=KwargAdd,
                NoMaterialize=NoMaterialize, Twice=Twice, MaxIdx=MaxIdx)


REF, PORT = _layers(ref), _layers(port)


def _t(P, a, grad=True):
    return P.to_tensor(np.asarray(a, np.float32), stop_gradient=not grad)


def _np(t):
    return np.asarray(t._value) if isinstance(t, ref.Tensor) else t.detach().numpy()


def _grad(P, t):
    return _np(t.grad)


def _both(fn):
    """``fn(P, layers)`` for each package; its results, as numpy, agree."""
    got = fn(port, PORT)
    want = fn(ref, REF)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    return got


def test_pylayer_cube_grad():
    def run(P, L):
        x = _t(P, [1.0, 2.0, 3.0])
        P.sum(L["Cube"].apply(x)).backward()
        return [_grad(P, x)]

    (g,) = _both(run)
    np.testing.assert_allclose(g, 3 * np.array([1, 4, 9]), rtol=1e-6)


def test_pylayer_two_inputs():
    def run(P, L):
        x, y = _t(P, [1.0, 2.0]), _t(P, [3.0, 4.0])
        P.sum(L["ScaledAdd"].apply(x, y, alpha=5.0)).backward()
        return [_grad(P, x), _grad(P, y)]

    gx, gy = _both(run)
    np.testing.assert_allclose(gy, [5.0, 5.0])


def test_pylayer_multi_output():
    def run(P, L):
        x = _t(P, [2.0, 3.0])
        a, b = L["TwoOut"].apply(x)
        P.add(P.sum(a), P.sum(b)).backward()
        return [_grad(P, x)]

    _both(run)


def test_pylayer_composes_with_ops():
    def run(P, L):
        x = _t(P, [1.5])
        y = L["Cube"].apply(P.multiply(x, 2.0))
        P.sum(P.multiply(y, 4.0)).backward()
        return [_grad(P, x)]

    (g,) = _both(run)
    np.testing.assert_allclose(g, 96 * 1.5 ** 2, rtol=1e-5)


def test_pylayer_stopgrad_input_passthrough():
    x = port.to_tensor([1.0])
    assert not PORT["Cube"].apply(x).requires_grad
    assert REF["Cube"].apply(ref.to_tensor([1.0])).stop_gradient


def test_vjp_jvp():
    def run(P, L):
        x = _t(P, [1.0, 2.0])
        v = _t(P, [1.0, 1.0], grad=False)
        out, g = P.autograd.vjp(lambda t: P.multiply(t, t), x, v)
        out2, tang = P.autograd.jvp(lambda t: P.multiply(t, t), x, v)
        _, g_default = P.autograd.vjp(lambda t: P.sin(t), x)
        return [_np(out), _np(g), _np(out2), _np(tang), _np(g_default)]

    _both(run)


def test_vjp_jvp_several_inputs_and_outputs():
    def run(P, L):
        x, y = _t(P, [1.0, 2.0]), _t(P, [3.0, -1.0])

        def f(a, b):
            return P.multiply(a, b), P.sin(a)

        outs, grads = P.autograd.vjp(f, [x, y], [_t(P, [1.0, 2.0]), _t(P, [0.5, 0.5])])
        outs2, tangs = P.autograd.jvp(f, [x, y], [_t(P, [1.0, 0.0]), _t(P, [0.0, 1.0])])
        return [_np(o) for o in outs] + [_np(g) for g in grads] + [_np(t) for t in tangs]

    _both(run)


def test_jacobian_single():
    def run(P, L):
        return [_np(P.autograd.jacobian(lambda t: P.multiply(t, t), _t(P, [1.0, 2.0, 3.0])))]

    (j,) = _both(run)
    np.testing.assert_allclose(j, np.diag([2.0, 4.0, 6.0]))


def test_jacobian_multi_input_and_output():
    def run(P, L):
        x, y = _t(P, [1.0, 2.0]), _t(P, [3.0])
        jx, jy = P.autograd.jacobian(lambda a, b: P.multiply(a, b), [x, y])
        rows = P.autograd.jacobian(lambda a, b: (P.multiply(a, b), P.exp(a)), [x, y])
        assert len(rows) == 2 and len(rows[0]) == 2
        return [_np(jx), _np(jy)] + [_np(b) for row in rows for b in row]

    _both(run)


def test_hessian():
    def run(P, L):
        x, y = _t(P, [1.0, 2.0]), _t(P, [0.5])
        h = P.autograd.hessian(lambda t: P.sum(P.multiply(P.multiply(t, t), t)), x)
        hh = P.autograd.hessian(lambda a, b: P.sum(P.multiply(P.multiply(a, a), b)), [x, y])
        return [_np(h)] + [_np(b) for row in hh for b in row]

    (h, *_) = _both(run)
    np.testing.assert_allclose(h, np.diag([6.0, 12.0]), rtol=1e-6)


def test_pylayer_kwarg_tensor_gets_grad():
    def run(P, L):
        x, y = _t(P, [1.0]), _t(P, [2.0])
        P.sum(L["KwargAdd"].apply(x, y=y)).backward()
        return [_grad(P, x), _grad(P, y)]

    gx, gy = _both(run)
    np.testing.assert_allclose(gy, [3.0])


def test_pylayer_set_materialize_grads_false():
    def run(P, L):
        x = _t(P, [1.0])
        a, b = L["NoMaterialize"].apply(x)
        P.sum(a).backward()  # b unused downstream: its cotangent arrives as None
        assert L["NoMaterialize"].seen[1] is None
        return [_grad(P, x)]

    (g,) = _both(run)
    np.testing.assert_allclose(g, [2.0])


def test_pylayer_same_tensor_multiple_positions():
    def run(P, L):
        x = _t(P, [1.0, 2.0])
        y = L["Twice"].apply(x, x)
        P.autograd.backward([y], [P.ones_like(y)])
        return [_grad(P, x)]

    (g,) = _both(run)
    np.testing.assert_allclose(g, [3.0, 3.0])


def test_pylayer_mark_non_differentiable_and_grads_per_diff_input():
    out, idx = PORT["MaxIdx"].apply(torch.tensor([[1.0, 5.0], [3.0, 2.0]], requires_grad=True))
    assert out.requires_grad and not idx.requires_grad and idx.dtype == torch.int64

    class PerDiff(port.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k, y):
            return x * k + y

        @staticmethod
        def backward(ctx, dy):
            return dy * 4.0  # one gradient: the one differentiable input

    x = torch.ones(2, requires_grad=True)
    PerDiff.apply(x, torch.tensor([4, 4]), torch.ones(2)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0, 4.0])


def test_grad_backward_and_no_grad_match_paddle_tpu():
    def run(P, L):
        x, y = _t(P, [1.0, 2.0]), _t(P, [0.5, -1.0])
        z = P.sum(P.multiply(P.exp(x), y))
        gx, gy = P.grad([z], [x, y], retain_graph=True)
        w = P.multiply(x, 3.0)
        P.backward([w], [_t(P, [1.0, 2.0], grad=False)])
        with P.no_grad():
            n = P.multiply(x, 2.0)
        assert (n.stop_gradient if P is ref else not n.requires_grad)
        return [_np(gx), _np(gy), _grad(P, x)]

    _both(run)


def test_grad_leaves_every_grad_alone_where_the_reference_clears_the_inputs():
    """The reference's ``grad`` sets the inputs' ``.grad`` to None (a
    gradient accumulated before is lost) and accumulates into the other
    leaves' ``.grad``; the port's touches no ``.grad`` (ROADMAP.md, "Faults
    in the reference")."""
    def run(P, L):
        x, other = _t(P, [1.0, 2.0]), _t(P, [3.0, 4.0])
        P.sum(P.multiply(x, 5.0)).backward()
        (g,) = P.grad([P.sum(P.multiply(P.multiply(x, x), other))], [x])
        return _np(g), x.grad, other.grad

    g_port, xg_port, og_port = run(port, PORT)
    g_ref, xg_ref, og_ref = run(ref, REF)
    np.testing.assert_allclose(g_port, g_ref)
    np.testing.assert_allclose(xg_port.numpy(), [5.0, 5.0]) and og_port is None
    assert og_port is None
    assert xg_ref is None and og_ref is not None  # the reference's side effects
    with pytest.raises(ValueError, match="unused"):
        port.grad(port.sum(port.to_tensor([1.0], stop_gradient=False) * 2.0),
                  port.to_tensor([1.0], stop_gradient=False))

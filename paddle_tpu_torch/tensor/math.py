"""Elementwise and reduction math (``paddle_tpu/tensor/math.py``; parity:
python/paddle/tensor/math.py).

Each function casts its inputs under the reference's op name
(``_helpers.cast``), then calls torch. Where torch's own function computes
another formula than the reference's JAX one (``lerp``, ``addmm``,
``softplus_op``), the reference's formula is written out.

The in-place ``*_`` functions are torch's in-place operations: on a leaf
that requires grad they raise, as torch does (the reference rebinds a
snapshot so the leaf still gets its gradient; ROADMAP.md, "Semantic
edges").
"""
from __future__ import annotations

import torch

from ._helpers import all_axes, axis as _axis, cast, default_float, ensure_tensor, operands, \
    scalar, to_torch_dtype

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder", "mod", "floor_mod",
    "pow", "maximum", "minimum", "fmax", "fmin", "atan2", "kron", "inner", "outer", "logaddexp",
    "heaviside", "copysign", "nextafter", "hypot", "gcd", "lcm", "sqrt", "rsqrt", "exp", "expm1",
    "log", "log2", "log10", "log1p", "abs", "neg", "sign", "floor", "ceil", "round", "trunc",
    "frac", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh", "acosh",
    "atanh", "reciprocal", "square", "erf", "erfinv", "lgamma", "digamma", "sigmoid", "logit",
    "isnan", "isinf", "isfinite", "nan_to_num", "clip", "scale", "increment", "stanh",
    "softplus_op", "angle", "conj", "real", "imag", "deg2rad", "rad2deg", "lerp", "sum", "mean",
    "max", "min", "amax", "amin", "prod", "nansum", "nanmean", "logsumexp", "all", "any",
    "count_nonzero", "cumsum", "cumprod", "cummax", "cummin", "trace", "diff", "add_n", "matmul",
    "dot", "bmm", "mv", "mm", "addmm", "einsum", "renorm", "tanh_", "add_", "subtract_", "ceil_",
    "floor_", "exp_", "sqrt_", "rsqrt_", "reciprocal_", "round_", "clip_", "scale_", "erfinv_",
    "lerp_"]


def _binary(fn, x, y, name, tensors_only=False):
    x, y = operands(x, y, tensors_only)
    if scalar(y):
        (x,) = cast(name, x)
    else:
        x, y = cast(name, x, y)
    return fn(x, y)


def _unary(fn, x, name):
    (x,) = cast(name, ensure_tensor(x))
    return fn(x)


def _float(x):
    """``x`` in the default float dtype if it is not floating (JAX's
    transcendentals and means take an int array to float)."""
    return x if x.is_floating_point() or x.is_complex() else x.to(default_float())


# ---- elementwise binary ---------------------------------------------------

def add(x, y, name=None):
    return _binary(torch.add, x, y, "add")


def subtract(x, y, name=None):
    return _binary(torch.sub, x, y, "subtract")


def multiply(x, y, name=None):
    return _binary(torch.mul, x, y, "multiply")


def divide(x, y, name=None):
    return _binary(torch.true_divide, x, y, "divide")


def floor_divide(x, y, name=None):
    return _binary(torch.floor_divide, x, y, "floor_divide")


def remainder(x, y, name=None):
    return _binary(torch.remainder, x, y, "remainder")


mod = remainder
floor_mod = remainder


def pow(x, y, name=None):  # noqa: A001
    return _binary(torch.pow, x, y, "pow")


def maximum(x, y, name=None):
    return _binary(torch.maximum, x, y, "maximum", True)


def minimum(x, y, name=None):
    return _binary(torch.minimum, x, y, "minimum", True)


def fmax(x, y, name=None):
    return _binary(torch.fmax, x, y, "fmax", True)


def fmin(x, y, name=None):
    return _binary(torch.fmin, x, y, "fmin", True)


def atan2(x, y, name=None):
    return _binary(lambda a, b: torch.atan2(_float(a), _float(b)), x, y, "atan2", True)


def kron(x, y, name=None):
    return _binary(torch.kron, x, y, "kron", True)


def inner(x, y, name=None):
    return _binary(torch.inner, x, y, "inner", True)


def outer(x, y, name=None):
    return _binary(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)), x, y, "outer", True)


def logaddexp(x, y, name=None):
    return _binary(lambda a, b: torch.logaddexp(_float(a), _float(b)), x, y, "logaddexp", True)


def heaviside(x, y, name=None):
    return _binary(lambda a, b: torch.heaviside(a, b.to(a.dtype)), x, y, "heaviside", True)


def copysign(x, y, name=None):
    return _binary(torch.copysign, x, y, "copysign", True)


def nextafter(x, y, name=None):
    return _binary(lambda a, b: torch.nextafter(a, b.to(a.dtype)), x, y, "nextafter", True)


def hypot(x, y, name=None):
    return _binary(torch.hypot, x, y, "hypot", True)


def gcd(x, y, name=None):
    return _binary(torch.gcd, x, y, "gcd", True)


def lcm(x, y, name=None):
    return _binary(torch.lcm, x, y, "lcm", True)


# ---- elementwise unary ----------------------------------------------------

def sqrt(x, name=None):
    return _unary(lambda v: torch.sqrt(_float(v)), x, "sqrt")


def rsqrt(x, name=None):
    return _unary(lambda v: torch.rsqrt(_float(v)), x, "rsqrt")


def exp(x, name=None):
    return _unary(lambda v: torch.exp(_float(v)), x, "exp")


def expm1(x, name=None):
    return _unary(lambda v: torch.expm1(_float(v)), x, "expm1")


def log(x, name=None):
    return _unary(lambda v: torch.log(_float(v)), x, "log")


def log2(x, name=None):
    return _unary(lambda v: torch.log2(_float(v)), x, "log2")


def log10(x, name=None):
    return _unary(lambda v: torch.log10(_float(v)), x, "log10")


def log1p(x, name=None):
    return _unary(lambda v: torch.log1p(_float(v)), x, "log1p")


def abs(x, name=None):  # noqa: A001
    return _unary(torch.abs, x, "abs")


def neg(x, name=None):
    return _unary(torch.neg, x, "neg")


def sign(x, name=None):
    return _unary(torch.sign, x, "sign")


def floor(x, name=None):
    return _unary(torch.floor, x, "floor")


def ceil(x, name=None):
    return _unary(torch.ceil, x, "ceil")


def round(x, name=None):  # noqa: A001
    return _unary(torch.round, x, "round")


def trunc(x, name=None):
    return _unary(torch.trunc, x, "trunc")


def frac(x, name=None):
    return _unary(lambda v: v - torch.trunc(v), x, "frac")


def sin(x, name=None):
    return _unary(lambda v: torch.sin(_float(v)), x, "sin")


def cos(x, name=None):
    return _unary(lambda v: torch.cos(_float(v)), x, "cos")


def tan(x, name=None):
    return _unary(lambda v: torch.tan(_float(v)), x, "tan")


def asin(x, name=None):
    return _unary(lambda v: torch.asin(_float(v)), x, "asin")


def acos(x, name=None):
    return _unary(lambda v: torch.acos(_float(v)), x, "acos")


def atan(x, name=None):
    return _unary(lambda v: torch.atan(_float(v)), x, "atan")


def sinh(x, name=None):
    return _unary(lambda v: torch.sinh(_float(v)), x, "sinh")


def cosh(x, name=None):
    return _unary(lambda v: torch.cosh(_float(v)), x, "cosh")


def tanh(x, name=None):
    return _unary(lambda v: torch.tanh(_float(v)), x, "tanh")


def asinh(x, name=None):
    return _unary(lambda v: torch.asinh(_float(v)), x, "asinh")


def acosh(x, name=None):
    return _unary(lambda v: torch.acosh(_float(v)), x, "acosh")


def atanh(x, name=None):
    return _unary(lambda v: torch.atanh(_float(v)), x, "atanh")


def reciprocal(x, name=None):
    return _unary(torch.reciprocal, x, "reciprocal")


def square(x, name=None):
    return _unary(torch.square, x, "square")


def erf(x, name=None):
    return _unary(lambda v: torch.erf(_float(v)), x, "erf")


def erfinv(x, name=None):
    return _unary(lambda v: torch.erfinv(_float(v)), x, "erfinv")


def lgamma(x, name=None):
    return _unary(lambda v: torch.lgamma(_float(v)), x, "lgamma")


def digamma(x, name=None):
    return _unary(lambda v: torch.digamma(_float(v)), x, "digamma")


def sigmoid(x, name=None):
    return _unary(lambda v: torch.sigmoid(_float(v)), x, "sigmoid")


def logit(x, eps=None, name=None):
    def fn(v):
        if eps is not None:
            v = torch.clamp(v, eps, 1.0 - eps)
        return torch.log(v / (1.0 - v))

    return _unary(fn, x, "logit")


def isnan(x, name=None):
    return _unary(torch.isnan, x, "isnan")


def isinf(x, name=None):
    return _unary(torch.isinf, x, "isinf")


def isfinite(x, name=None):
    return _unary(torch.isfinite, x, "isfinite")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return _unary(lambda v: torch.nan_to_num(v, nan=nan, posinf=posinf, neginf=neginf), x,
                  "nan_to_num")


def clip(x, min=None, max=None, name=None):  # noqa: A002
    (x,) = cast("clip", ensure_tensor(x))
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min, max)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    (x,) = cast("scale", ensure_tensor(x))
    return x * scale + bias if bias_after_scale else (x + bias) * scale


def increment(x, value=1.0, name=None):
    """``x += value`` in place (the reference's raw update, off its tape)."""
    return x.add_(value)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _unary(lambda v: scale_b * torch.tanh(scale_a * v), x, "stanh")


def softplus_op(x, beta=1, threshold=20, name=None):
    """``log(1 + exp(beta x)) / beta`` with no threshold, as the reference's
    ``jax.nn.softplus`` computes it."""
    return _unary(lambda v: torch.logaddexp(beta * v, torch.zeros((), dtype=v.dtype,
                                                                  device=v.device)) / beta,
                  x, "softplus")


def angle(x, name=None):
    return _unary(lambda v: torch.angle(_float(v)), x, "angle")


def conj(x, name=None):
    return _unary(torch.conj_physical, x, "conj")


def real(x, name=None):
    return _unary(lambda v: torch.real(v).clone() if v.is_complex() else v.clone(), x, "real")


def imag(x, name=None):
    return _unary(lambda v: torch.imag(v).clone() if v.is_complex() else torch.zeros_like(v),
                  x, "imag")


def deg2rad(x, name=None):
    return _unary(lambda v: torch.deg2rad(_float(v)), x, "deg2rad")


def rad2deg(x, name=None):
    return _unary(lambda v: torch.rad2deg(_float(v)), x, "rad2deg")


def lerp(x, y, weight, name=None):
    """``x + weight (y - x)``, the reference's formula (torch's ``lerp``
    takes another one above ``weight = 0.5``)."""
    if isinstance(weight, torch.Tensor):
        x, y, weight = cast("lerp", ensure_tensor(x), ensure_tensor(y), weight)
    else:
        x, y = cast("lerp", ensure_tensor(x), ensure_tensor(y))
    return x + weight * (y - x)


# ---- reductions -----------------------------------------------------------

def _keep_all(out, x, keepdim):
    return out.reshape((1,) * x.ndim) if keepdim else out


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    (x,) = cast("sum", ensure_tensor(x))
    dt = to_torch_dtype(dtype)
    return torch.sum(x, dim=all_axes(x, _axis(axis)), keepdim=keepdim, dtype=dt)


def mean(x, axis=None, keepdim=False, name=None):
    (x,) = cast("mean", ensure_tensor(x))
    return torch.mean(_float(x), dim=all_axes(x, _axis(axis)), keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    (x,) = cast("max", ensure_tensor(x))
    return torch.amax(x, dim=all_axes(x, _axis(axis)), keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    (x,) = cast("min", ensure_tensor(x))
    return torch.amin(x, dim=all_axes(x, _axis(axis)), keepdim=keepdim)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    (x,) = cast("prod", ensure_tensor(x))
    dt = to_torch_dtype(dtype)
    ax = _axis(axis)
    if ax is None:
        return _keep_all(torch.prod(x, dtype=dt), x, keepdim)
    out = x if dt is None else x.to(dt)
    for a in sorted((a % x.ndim for a in ((ax,) if isinstance(ax, int) else ax)), reverse=True):
        out = torch.prod(out, a, keepdim=keepdim)
    return out


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    (x,) = cast("nansum", ensure_tensor(x))
    return torch.nansum(x, dim=all_axes(x, _axis(axis)), keepdim=keepdim, dtype=to_torch_dtype(dtype))


def nanmean(x, axis=None, keepdim=False, name=None):
    (x,) = cast("nanmean", ensure_tensor(x))
    return torch.nanmean(_float(x), dim=all_axes(x, _axis(axis)), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    (x,) = cast("logsumexp", ensure_tensor(x))
    return torch.logsumexp(_float(x), dim=all_axes(x, _axis(axis)), keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    (x,) = cast("all", ensure_tensor(x))
    return torch.all(x, dim=all_axes(x, _axis(axis)), keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    (x,) = cast("any", ensure_tensor(x))
    return torch.any(x, dim=all_axes(x, _axis(axis)), keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    (x,) = cast("count_nonzero", ensure_tensor(x))
    ax = all_axes(x, _axis(axis))
    out = torch.count_nonzero(x, dim=ax)
    if keepdim:
        for a in sorted(a % x.ndim for a in ((ax,) if isinstance(ax, int) else ax)):
            out = out.unsqueeze(a)
    return out


def cumsum(x, axis=None, dtype=None, name=None):
    (x,) = cast("cumsum", ensure_tensor(x))
    dt = to_torch_dtype(dtype)
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=dt)
    return torch.cumsum(x, int(axis), dtype=dt)


def cumprod(x, dim=None, dtype=None, name=None):
    (x,) = cast("cumprod", ensure_tensor(x))
    dt = to_torch_dtype(dtype)
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0, dtype=dt)
    return torch.cumprod(x, int(dim), dtype=dt)


def _cum_extreme(x, axis, dtype, op_name):
    (x,) = cast(op_name, ensure_tensor(x))
    v = x.reshape(-1) if axis is None else x
    ax = 0 if axis is None else int(axis)
    # torch's cummax/cummin take the latest index of a tied extreme, as the
    # reference's running maximum of matching positions does
    vals, idx = (torch.cummax if op_name == "cummax" else torch.cummin)(v, ax)
    return vals, idx.to(to_torch_dtype(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    """(values, indices), as ``paddle.cummax``."""
    return _cum_extreme(x, axis, dtype, "cummax")


def cummin(x, axis=None, dtype="int64", name=None):
    """(values, indices), as ``paddle.cummin``."""
    return _cum_extreme(x, axis, dtype, "cummin")


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    (x,) = cast("trace", ensure_tensor(x))
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = ensure_tensor(x)
    edges = [e for e in (prepend, append) if isinstance(e, torch.Tensor)]
    x, *edges = cast("diff", x, *edges)
    it = iter(edges)

    def edge(e):
        """An array as it is (any width along ``axis``); a scalar as one
        slice along it, as ``jnp.diff`` takes them."""
        if e is None:
            return None
        e = next(it) if isinstance(e, torch.Tensor) else torch.as_tensor(e, dtype=x.dtype,
                                                                         device=x.device)
        if e.ndim:
            return e
        shape = list(x.shape)
        shape[axis] = 1
        return torch.broadcast_to(e, shape)

    pre, app = edge(prepend), edge(append)
    return torch.diff(x, n=n, dim=axis, prepend=pre, append=app)


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return inputs
    tensors = cast("add_n", *[ensure_tensor(t) for t in inputs])
    out = tensors[0]
    for v in tensors[1:]:
        out = out + v
    return out


# ---- the matmul family (parity: python/paddle/tensor/linalg.py:128) -------

def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = cast("matmul", ensure_tensor(x), ensure_tensor(y))
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def dot(x, y, name=None):
    x, y = cast("dot", ensure_tensor(x), ensure_tensor(y))
    return torch.sum(x * y, dim=-1)


def bmm(x, y, name=None):
    return torch.matmul(*cast("bmm", ensure_tensor(x), ensure_tensor(y)))


def mv(x, vec, name=None):
    return torch.matmul(*cast("mv", ensure_tensor(x), ensure_tensor(vec)))


def mm(x, y, name=None):
    return torch.matmul(*cast("mm", ensure_tensor(x), ensure_tensor(y)))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    """``beta input + alpha (x @ y)``, the reference's formula."""
    i, a, b = cast("addmm", ensure_tensor(input), ensure_tensor(x), ensure_tensor(y))
    return beta * i + alpha * torch.matmul(a, b)


def einsum(equation, *operands):
    return torch.einsum(equation, *cast("einsum", *[ensure_tensor(t) for t in operands]))


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` scaled to a ``p``-norm of at most
    ``max_norm`` (the reference's formula, with its 1e-7)."""
    (x,) = cast("renorm", ensure_tensor(x))
    axes = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    norms = torch.sum(torch.abs(x) ** p, dim=axes, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7), torch.ones_like(norms))
    return x * factor.to(x.dtype)


# ---- in place (reference paddle.Tensor.add_ etc.) -------------------------

def _operand(y):
    return y if scalar(y) or isinstance(y, torch.Tensor) else ensure_tensor(y)


def tanh_(x, name=None):
    return x.tanh_()


def add_(x, y, name=None):
    return x.add_(_operand(y))


def subtract_(x, y, name=None):
    return x.sub_(_operand(y))


def ceil_(x, name=None):
    return x.ceil_()


def floor_(x, name=None):
    return x.floor_()


def exp_(x, name=None):
    return x.exp_()


def sqrt_(x, name=None):
    return x.sqrt_()


def rsqrt_(x, name=None):
    return x.rsqrt_()


def reciprocal_(x, name=None):
    return x.reciprocal_()


def round_(x, name=None):
    return x.round_()


def clip_(x, min=None, max=None, name=None):  # noqa: A002
    return x if min is None and max is None else x.clamp_(min, max)


def scale_(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    if bias_after_scale:
        return x.mul_(scale).add_(bias)
    return x.add_(bias).mul_(scale)


def erfinv_(x, name=None):
    return x.erfinv_()


def lerp_(x, y, weight, name=None):
    return x.add_(weight * (_operand(y) - x))


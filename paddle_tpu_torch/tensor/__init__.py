"""Paddle-named tensor functions over torch tensors (``paddle_tpu/tensor``):
the matmul family and the reductions and transcendentals that the AMP
lists name (:mod:`paddle_tpu_torch.amp`).

Each takes and returns torch tensors with the reference's signature and
casts its inputs at entry under the reference's op name
(:func:`paddle_tpu_torch.amp.cast_inputs`): ``matmul``, ``bmm``, ``mm`` and
``einsum`` run in an ``auto_cast`` scope's dtype; ``sum``, ``mean``,
``exp``, ``log``, ``log2``, ``log10``, ``logsumexp``, ``cumsum`` and
``norm`` take that dtype up to f32. The rest of the reference's tensor API
is not ported (ROADMAP.md, Queue 1 item 27).
"""
from __future__ import annotations

import torch

from ..amp import cast_inputs

__all__ = ["matmul", "bmm", "mm", "einsum", "sum", "mean", "exp", "log", "log2", "log10",
           "logsumexp", "cumsum", "norm"]


def _axis(axis):
    if axis is None:
        return None
    return tuple(axis) if isinstance(axis, (list, tuple)) else int(axis)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = cast_inputs("matmul", x, y)
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def bmm(x, y, name=None):
    return torch.matmul(*cast_inputs("bmm", x, y))


def mm(x, y, name=None):
    return torch.matmul(*cast_inputs("mm", x, y))


def einsum(equation, *operands):
    return torch.einsum(equation, *cast_inputs("einsum", *operands))


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    (x,) = cast_inputs("sum", x)
    dt = getattr(torch, str(dtype).replace("torch.", "")) if dtype else None
    ax = _axis(axis)
    if ax is None:
        return torch.sum(x, dtype=dt) if not keepdim else \
            torch.sum(x, dim=tuple(range(x.ndim)), keepdim=True, dtype=dt)
    return torch.sum(x, dim=ax, keepdim=keepdim, dtype=dt)


def mean(x, axis=None, keepdim=False, name=None):
    (x,) = cast_inputs("mean", x)
    ax = _axis(axis)
    if ax is None:
        return torch.mean(x) if not keepdim else torch.mean(x, dim=tuple(range(x.ndim)),
                                                            keepdim=True)
    return torch.mean(x, dim=ax, keepdim=keepdim)


def exp(x, name=None):
    return torch.exp(*cast_inputs("exp", x))


def log(x, name=None):
    return torch.log(*cast_inputs("log", x))


def log2(x, name=None):
    return torch.log2(*cast_inputs("log2", x))


def log10(x, name=None):
    return torch.log10(*cast_inputs("log10", x))


def logsumexp(x, axis=None, keepdim=False, name=None):
    (x,) = cast_inputs("logsumexp", x)
    ax = _axis(axis)
    return torch.logsumexp(x, dim=tuple(range(x.ndim)) if ax is None else ax, keepdim=keepdim)


def cumsum(x, axis=None, dtype=None, name=None):
    (x,) = cast_inputs("cumsum", x)
    dt = getattr(torch, str(dtype).replace("torch.", "")) if dtype else None
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=dt)
    return torch.cumsum(x, int(axis), dtype=dt)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """The Frobenius norm over every entry, or the vector ``p``-norm over
    ``axis`` (the reference's common cases)."""
    (x,) = cast_inputs("norm", x)
    if axis is None:
        flat = x.reshape(-1)
        return torch.sqrt(torch.sum(flat * flat)) if p == "fro" else \
            torch.linalg.vector_norm(flat, ord=p)
    return torch.linalg.vector_norm(x, ord=2 if p == "fro" else p, dim=_axis(axis),
                                    keepdim=keepdim)

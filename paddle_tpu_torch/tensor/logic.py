"""Comparison and logical functions (``paddle_tpu/tensor/logic.py``;
parity: python/paddle/tensor/logic.py). ``equal_all`` and ``allclose``
return 0-d bool tensors on the inputs' device, as the reference's do (no
host read)."""
from __future__ import annotations

import torch

from ._helpers import cast, ensure_tensor

__all__ = ["equal", "not_equal", "less_than", "less_equal", "greater_than", "greater_equal",
           "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
           "bitwise_xor", "bitwise_not", "equal_all", "allclose", "isclose", "is_empty",
           "is_tensor", "is_floating_point", "is_integer", "is_complex"]

_INTEGER = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)


def _pair(x, y):
    x = ensure_tensor(x, device=y.device if isinstance(y, torch.Tensor) else None)
    return x, ensure_tensor(y, device=x.device)


def _cmp(fn, x, y, name):
    return fn(*cast(name, *_pair(x, y)))


def equal(x, y, name=None):
    return _cmp(torch.eq, x, y, "equal")


def not_equal(x, y, name=None):
    return _cmp(torch.ne, x, y, "not_equal")


def less_than(x, y, name=None):
    return _cmp(torch.lt, x, y, "less_than")


def less_equal(x, y, name=None):
    return _cmp(torch.le, x, y, "less_equal")


def greater_than(x, y, name=None):
    return _cmp(torch.gt, x, y, "greater_than")


def greater_equal(x, y, name=None):
    return _cmp(torch.ge, x, y, "greater_equal")


def logical_and(x, y, out=None, name=None):
    return _cmp(torch.logical_and, x, y, "logical_and")


def logical_or(x, y, out=None, name=None):
    return _cmp(torch.logical_or, x, y, "logical_or")


def logical_xor(x, y, out=None, name=None):
    return _cmp(torch.logical_xor, x, y, "logical_xor")


def logical_not(x, out=None, name=None):
    return torch.logical_not(*cast("logical_not", ensure_tensor(x)))


def bitwise_and(x, y, out=None, name=None):
    return _cmp(torch.bitwise_and, x, y, "bitwise_and")


def bitwise_or(x, y, out=None, name=None):
    return _cmp(torch.bitwise_or, x, y, "bitwise_or")


def bitwise_xor(x, y, out=None, name=None):
    return _cmp(torch.bitwise_xor, x, y, "bitwise_xor")


def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(*cast("bitwise_not", ensure_tensor(x)))


def equal_all(x, y, name=None):
    x, y = _pair(x, y)
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.all(x == y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _pair(x, y)
    return torch.all(isclose(x, y, rtol, atol, equal_nan))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = cast("isclose", *_pair(x, y))
    dt = torch.result_type(x, y)
    return torch.isclose(x.to(dt), y.to(dt), rtol=rtol, atol=atol, equal_nan=equal_nan)


def is_empty(x, name=None):
    x = ensure_tensor(x)
    return torch.full((), x.numel() == 0, dtype=torch.bool, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_floating_point(x):
    return ensure_tensor(x).is_floating_point()


def is_integer(x):
    return ensure_tensor(x).dtype in _INTEGER


def is_complex(x):
    return ensure_tensor(x).is_complex()

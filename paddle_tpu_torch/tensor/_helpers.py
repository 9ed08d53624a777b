"""Argument normalisation shared by the tensor functions
(``paddle_tpu/tensor/_helpers.py``).

The reference routes every op through its tape's ``primitive``, which
casts the inputs under the op's name when an ``auto_cast`` scope is open.
The port has no dispatcher: each function calls :func:`cast` under the
reference's op name itself, then torch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..amp import cast_inputs
from ..device import current_device
from ..framework.dtype import get_default_dtype, to_torch_dtype

__all__ = ["cast", "axis", "all_axes", "shape_list", "ensure_tensor", "from_numpy", "new_device",
           "scalar", "operands", "default_float", "to_torch_dtype"]

_SCALARS = (bool, int, float, np.bool_, np.integer, np.floating)


def cast(op_name, *vals):
    """The inputs of one call cast for the op ``op_name`` by the open
    ``auto_cast`` scope's lists (the inputs themselves outside a scope)."""
    return cast_inputs(op_name, *vals)


def axis(axis):
    """An axis argument as ``None``, an int or a tuple of ints."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def all_axes(x, ax):
    """``ax`` with ``None`` spelt out as every axis of ``x`` (torch reads an
    empty tuple as every axis, the reference as none)."""
    if ax is None:
        return tuple(range(x.ndim))
    return ax


def shape_list(shape):
    """A shape given as an int, a list of ints or 0-d tensors, or a 1-d
    tensor, as a list of ints."""
    if isinstance(shape, torch.Tensor):
        return [int(s) for s in shape.reshape(-1).tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s.item()) if isinstance(s, torch.Tensor) else int(s) for s in shape]


def new_device(place=None) -> torch.device:
    """Where a tensor made from no tensor input goes: ``place`` if given,
    else the device ``paddle.set_device`` named (the CUDA card by default)."""
    if place is None:
        return current_device()
    if isinstance(place, torch.device):
        return place
    if isinstance(place, str):
        from ..device import _parse

        return _parse(place)
    return place.device


def from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """A copy of ``arr`` on ``device``; a bfloat16 array (``ml_dtypes``) is
    moved bit for bit through its 16-bit view."""
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device) if device is not None else t


def default_float():
    return to_torch_dtype(get_default_dtype())


def ensure_tensor(x, dtype=None, device=None):
    """``x`` if it is a tensor, else a tensor made from it the way
    ``to_tensor`` makes one (Python floats in the default dtype, Python ints
    as int64) on ``device`` or the default device."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(to_torch_dtype(dtype))
    dev = device if device is not None else new_device()
    if isinstance(x, (np.ndarray, np.generic)):
        t = from_numpy(np.asarray(x), dev)
    else:
        arr = np.asarray(x)
        if arr.dtype == np.float64:  # Python floats: the default dtype
            t = torch.tensor(arr, dtype=default_float(), device=dev)
        elif arr.dtype == np.complex128:
            t = torch.tensor(arr, dtype=torch.complex128 if get_default_dtype() == "float64"
                             else torch.complex64, device=dev)
        else:
            t = torch.tensor(arr, device=dev)
    return t if dtype is None else t.to(to_torch_dtype(dtype))


def scalar(x):
    return isinstance(x, _SCALARS) and not isinstance(x, np.ndarray)


def _py(x):
    return x.item() if isinstance(x, np.generic) else x


def _scalar_like(v, other):
    """The scalar ``v`` as a 0-d tensor of the result's dtype on ``other``'s
    device."""
    return torch.full((), v, dtype=torch.result_type(other, v), device=other.device)


def operands(x, y, tensors_only=False):
    """The two operands of a binary function. A Python scalar stays one
    (torch weak-types it as the reference's JAX does: bf16 + 1.0 is bf16),
    unless the function takes tensors only (``tensors_only``) or it comes
    first: then it is a 0-d tensor of the result's dtype on the other
    operand's device."""
    x, y = _py(x), _py(y)
    if scalar(x) and scalar(y):
        x = ensure_tensor(x)
    if not scalar(x):
        x = ensure_tensor(x, device=y.device if isinstance(y, torch.Tensor) else None)
    if not scalar(y):
        y = ensure_tensor(y, device=x.device if isinstance(x, torch.Tensor) else None)
    if scalar(x):
        x = _scalar_like(x, y)
    if scalar(y) and tensors_only:
        y = _scalar_like(y, x)
    return x, y


def overwrite(x, dest, src):
    """``x`` with ``src[i]`` written at the flat position ``dest[i]`` (``dest``
    and ``src`` of one shape), the last of duplicate positions winning, as
    the reference's ``.at[].set`` does: only the write that lands gets a
    gradient, and the winner does not depend on a device's order of writes.
    No host sync."""
    dest = dest.reshape(-1)
    pos = torch.arange(dest.numel(), device=x.device)
    last = torch.full((x.numel(),), -1, dtype=torch.long, device=x.device)
    last.scatter_reduce_(0, dest, pos, "amax")
    out = torch.where(last >= 0, src.reshape(-1).to(x.dtype)[last.clamp(min=0)], x.reshape(-1))
    return out.view(x.shape)


def flat_positions(x):
    """The flat position of each element of ``x``, in its shape."""
    return torch.arange(x.numel(), device=x.device).view(x.shape)

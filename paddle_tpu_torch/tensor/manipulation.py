"""Shape and layout manipulation (``paddle_tpu/tensor/manipulation.py``;
parity: python/paddle/tensor/manipulation.py).

Index arguments may be any integer dtype (torch's indexing wants
``int64``; they are widened at entry). The in-place ``*_`` functions are
torch's in-place operations (``reshape_``/``flatten_`` restride a
contiguous tensor in place) and raise as torch does on a leaf that requires
grad.
"""
from __future__ import annotations

import builtins
import math as _math

import torch

from ._helpers import (axis as _axis, cast, ensure_tensor, flat_positions, overwrite as _overwrite,
                       shape_list, to_torch_dtype)

__all__ = ["cast", "reshape", "reshape_", "flatten", "transpose", "t", "moveaxis", "swapaxes",
           "squeeze", "unsqueeze", "concat", "stack", "split", "chunk", "unbind", "tile", "expand",
           "expand_as", "broadcast_to", "broadcast_tensors", "gather", "gather_nd",
           "take_along_axis", "put_along_axis", "scatter", "scatter_nd_add", "scatter_nd",
           "index_select", "index_sample", "masked_select", "masked_fill", "where", "roll", "flip",
           "rot90", "repeat_interleave", "unique", "unique_consecutive", "slice", "strided_slice",
           "shard_index", "crop", "as_complex", "as_real", "tensordot", "numel", "rank", "shape",
           "diagonal", "unstack", "reverse", "multiplex", "tolist", "broadcast_shape", "squeeze_",
           "unsqueeze_", "scatter_", "put_along_axis_", "flatten_"]

_cast_inputs = cast


def _long(idx):
    idx = ensure_tensor(idx)
    return idx if idx.dtype in (torch.int64, torch.bool) else idx.long()


def cast(x, dtype):  # noqa: F811
    (x,) = _cast_inputs("cast", ensure_tensor(x))
    return x.to(to_torch_dtype(dtype))


def _resolve_shape(shape, numel):
    shape = shape_list(shape)
    if -1 in shape:
        known = _math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = numel // known if known else 0
    return shape


def reshape(x, shape, name=None):
    (x,) = _cast_inputs("reshape", ensure_tensor(x))
    return torch.reshape(x, shape_list(shape))


def _restride_(x, shape):
    """``x`` given ``shape`` in place (a contiguous tensor's new view of its
    own storage)."""
    if not x.is_contiguous():
        raise ValueError("an in-place reshape needs a contiguous tensor")
    shape = _resolve_shape(shape, x.numel())
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * builtins.max(shape[i + 1], 1)
    return x.as_strided_(shape, strides, x.storage_offset())


def reshape_(x, shape, name=None):
    return _restride_(x, shape)


def _flat_shape(x, start_axis, stop_axis):
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    return list(x.shape[:s]) + [-1] + list(x.shape[e + 1:])


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    (x,) = _cast_inputs("flatten", ensure_tensor(x))
    return torch.reshape(x, _flat_shape(x, start_axis, stop_axis))


def transpose(x, perm=None, name=None):
    (x,) = _cast_inputs("transpose", ensure_tensor(x))
    return x.permute(*(perm if perm is not None else range(x.ndim - 1, -1, -1)))


def t(x, name=None):
    (x,) = _cast_inputs("t", ensure_tensor(x))
    return x.permute(*range(x.ndim - 1, -1, -1))


def moveaxis(x, source, destination, name=None):
    (x,) = _cast_inputs("moveaxis", ensure_tensor(x))
    return torch.movedim(x, source, destination)


def swapaxes(x, axis1, axis2, name=None):
    (x,) = _cast_inputs("swapaxes", ensure_tensor(x))
    return torch.swapaxes(x, axis1, axis2)


def _squeeze_axes(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return tuple(a % x.ndim for a in axes if x.shape[a % x.ndim] == 1)


def squeeze(x, axis=None, name=None):
    (x,) = _cast_inputs("squeeze", ensure_tensor(x))
    if axis is None:
        return torch.squeeze(x)
    axes = _squeeze_axes(x, axis)
    return torch.squeeze(x, axes) if axes else x


def _unsqueeze_axes(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    n = x.ndim + len(axes)
    return sorted(int(a) % n for a in axes)


def unsqueeze(x, axis, name=None):
    (x,) = _cast_inputs("unsqueeze", ensure_tensor(x))
    for a in _unsqueeze_axes(x, axis):
        x = x.unsqueeze(a)
    return x


def concat(x, axis=0, name=None):
    tensors = _cast_inputs("concat", *[ensure_tensor(t) for t in x])
    ax = int(axis.item() if isinstance(axis, torch.Tensor) else axis)
    return torch.cat(tensors, dim=ax)


def stack(x, axis=0, name=None):
    tensors = _cast_inputs("stack", *[ensure_tensor(t) for t in x])
    return torch.stack(tensors, dim=axis)


def split(x, num_or_sections, axis=0, name=None):
    (x,) = _cast_inputs("split", ensure_tensor(x))
    ax = int(axis.item() if isinstance(axis, torch.Tensor) else axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(f"split: dimension {ax} of size {dim} is not divisible by "
                             f"num_or_sections={num_or_sections}")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = shape_list(num_or_sections)
        neg = [i for i, s in enumerate(sections) if s < 0]
        if neg:
            sections[neg[0]] = dim - builtins.sum(s for s in sections if s >= 0)
    return list(torch.split(x, sections, dim=ax))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    (x,) = _cast_inputs("unbind", ensure_tensor(x))
    return list(torch.unbind(x, axis))


def tile(x, repeat_times, name=None):
    (x,) = _cast_inputs("tile", ensure_tensor(x))
    reps = shape_list(repeat_times)
    return torch.tile(x, tuple(reps))


def _expand_shape(x, shape):
    tgt = shape_list(shape)
    for i in range(len(tgt)):
        if tgt[i] == -1:
            j = i - len(tgt) + x.ndim
            tgt[i] = x.shape[j] if j >= 0 else 1
    return tgt


def expand(x, shape, name=None):
    (x,) = _cast_inputs("expand", ensure_tensor(x))
    return torch.broadcast_to(x, _expand_shape(x, shape))


def expand_as(x, y, name=None):
    return expand(x, list(ensure_tensor(y).shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    tensors = _cast_inputs("broadcast_tensors", *[ensure_tensor(t) for t in inputs])
    return list(torch.broadcast_tensors(*tensors))


def gather(x, index, axis=0, name=None):
    x, index = _cast_inputs("gather", ensure_tensor(x), _long(index))
    ax = int(axis.item() if isinstance(axis, torch.Tensor) else axis) % builtins.max(x.ndim, 1)
    out = torch.index_select(x, ax, index.reshape(-1))
    return out.reshape(tuple(x.shape[:ax]) + tuple(index.shape) + tuple(x.shape[ax + 1:]))


def gather_nd(x, index, name=None):
    x, index = _cast_inputs("gather_nd", ensure_tensor(x), _long(index))
    return x[tuple(torch.movedim(index, -1, 0))]


def take_along_axis(arr, indices, axis, name=None):
    arr, indices = _cast_inputs("take_along_axis", ensure_tensor(arr), _long(indices))
    return torch.take_along_dim(arr, indices, dim=axis)


def _along(x, indices, values, axis, reduce, inplace):
    values = ensure_tensor(values, device=x.device)
    idx = _long(indices)
    src = torch.broadcast_to(values, idx.shape).to(x.dtype)
    if reduce == "assign":  # duplicates: the last write lands, as in the reference
        out = _overwrite(x, flat_positions(x).gather(axis, idx), src)
        return x.copy_(out) if inplace else out
    if reduce == "add":
        return (x.scatter_add_ if inplace else x.scatter_add)(axis, idx, src)
    if reduce == "multiply":
        return (x.scatter_reduce_ if inplace else x.scatter_reduce)(axis, idx, src, "prod")
    raise ValueError(reduce)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    arr = ensure_tensor(arr)
    if isinstance(values, torch.Tensor):
        arr, values = _cast_inputs("put_along_axis", arr, values)
    else:
        (arr,) = _cast_inputs("put_along_axis", arr)
    return _along(arr, indices, values, axis, reduce, False)


def scatter(x, index, updates, overwrite=True, name=None):
    x, updates = _cast_inputs("scatter", ensure_tensor(x), ensure_tensor(updates))
    idx = _long(index).reshape(-1)
    if overwrite:  # duplicates: the last row lands, as in the reference
        return _overwrite(x, flat_positions(x).index_select(0, idx), updates)
    return x.index_add(0, idx, updates.to(x.dtype))


def scatter_nd_add(x, index, updates, name=None):
    x, updates = _cast_inputs("scatter_nd_add", ensure_tensor(x), ensure_tensor(updates))
    return x.index_put(tuple(torch.movedim(_long(index), -1, 0)), updates.to(x.dtype),
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    (updates,) = _cast_inputs("scatter_nd", ensure_tensor(updates))
    z = torch.zeros(shape_list(shape), dtype=updates.dtype, device=updates.device)
    return z.index_put(tuple(torch.movedim(_long(index), -1, 0)), updates, accumulate=True)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


def index_sample(x, index, name=None):
    (x,) = _cast_inputs("index_sample", ensure_tensor(x))
    return torch.take_along_dim(x, _long(index), dim=1)


def masked_select(x, mask, name=None):
    (x,) = _cast_inputs("masked_select", ensure_tensor(x))
    return torch.masked_select(x, ensure_tensor(mask, device=x.device))


def masked_fill(x, mask, value, name=None):
    (x,) = _cast_inputs("masked_fill", ensure_tensor(x))
    value = value.detach().to(x.dtype) if isinstance(value, torch.Tensor) else value
    return torch.where(ensure_tensor(mask, device=x.device),
                       value if isinstance(value, torch.Tensor) else
                       torch.full((), value, dtype=x.dtype, device=x.device), x)


def where(condition, x=None, y=None, name=None):
    cond = ensure_tensor(condition)
    if x is None and y is None:
        return tuple(torch.nonzero(cond, as_tuple=True))
    x, y = _cast_inputs("where", ensure_tensor(x, device=cond.device),
                        ensure_tensor(y, device=cond.device))
    return torch.where(cond.detach(), x, y)


def roll(x, shifts, axis=None, name=None):
    (x,) = _cast_inputs("roll", ensure_tensor(x))
    return torch.roll(x, shifts, axis)


def flip(x, axis, name=None):
    (x,) = _cast_inputs("flip", ensure_tensor(x))
    ax = _axis(axis)
    return torch.flip(x, tuple(range(x.ndim)) if ax is None else
                      ((ax,) if isinstance(ax, int) else ax))


def rot90(x, k=1, axes=(0, 1), name=None):
    (x,) = _cast_inputs("rot90", ensure_tensor(x))
    return torch.rot90(x, k, tuple(axes))


def repeat_interleave(x, repeats, axis=None, name=None):
    (x,) = _cast_inputs("repeat_interleave", ensure_tensor(x))
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None,
           dtype="int64", name=None):
    """Sorted unique values, and optionally the index of each one's first
    occurrence, the inverse and the counts (the reference's order); the
    indices in ``dtype``."""
    x = ensure_tensor(x).detach()
    v = x.reshape(-1) if axis is None else x
    out, inv, counts = torch.unique(v, sorted=True, return_inverse=True, return_counts=True,
                                    dim=axis)
    dt = to_torch_dtype(dtype)
    res = [out]
    if return_index:
        ax = 0 if axis is None else axis
        n = v.shape[ax]
        pos = torch.arange(n, device=v.device)
        first = torch.full((out.shape[ax],), n, dtype=torch.int64, device=v.device)
        res.append(first.scatter_reduce(0, inv.reshape(-1), pos, "amin").to(dt))
    if return_inverse:
        res.append(inv.to(dt))
    if return_counts:
        res.append(counts.to(dt))
    return tuple(res) if len(res) > 1 else res[0]


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None, dtype="int64",
                       name=None):
    x = ensure_tensor(x).detach()
    v = x.reshape(-1) if axis is None else x
    out, inv, counts = torch.unique_consecutive(v, return_inverse=True, return_counts=True,
                                                dim=axis)
    dt = to_torch_dtype(dtype)
    res = [out] + ([inv.to(dt)] if return_inverse else []) + ([counts.to(dt)] if return_counts else [])
    return tuple(res) if len(res) > 1 else res[0]


def slice(input, axes, starts, ends, name=None):  # noqa: A001,A002
    (x,) = _cast_inputs("slice", ensure_tensor(input))
    idx = [builtins.slice(None)] * x.ndim
    for ax, s, e in zip(axes, shape_list(starts), shape_list(ends)):
        dim = x.shape[ax]
        s2 = builtins.max(s + dim, 0) if s < 0 else builtins.min(s, dim)
        e2 = builtins.max(e + dim, 0) if e < 0 else builtins.min(e, dim)
        idx[ax] = builtins.slice(s2, e2)
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing per axis; a negative stride walks the flipped axis
    (torch's slicing takes positive steps only)."""
    (x,) = _cast_inputs("strided_slice", ensure_tensor(x))
    for ax, s, e, st in zip(axes, shape_list(starts), shape_list(ends), shape_list(strides)):
        dim = x.shape[ax]
        sel = [builtins.slice(None)] * x.ndim
        if st > 0:
            sel[ax] = builtins.slice(s, e, st)
            x = x[tuple(sel)]
            continue
        r = range(*builtins.slice(s, e, st).indices(dim))
        if not len(r):
            sel[ax] = builtins.slice(0, 0)
            x = x[tuple(sel)]
            continue
        sel[ax] = builtins.slice(dim - 1 - r[0], dim - r[-1], -st)
        x = torch.flip(x, (ax,))[tuple(sel)]
    return x


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):  # noqa: A002
    v = ensure_tensor(input)
    shard_size = (index_num + nshards - 1) // nshards
    return torch.where(torch.div(v, shard_size, rounding_mode="floor") == shard_id,
                       torch.remainder(v, shard_size),
                       torch.full((), ignore_value, dtype=v.dtype, device=v.device))


def crop(x, shape=None, offsets=None, name=None):
    (x,) = _cast_inputs("crop", ensure_tensor(x))
    shape = shape_list(shape)
    offsets = shape_list(offsets) if offsets is not None else [0] * len(shape)
    idx = tuple(builtins.slice(o, o + (s if s != -1 else x.shape[i] - o))
                for i, (o, s) in enumerate(zip(offsets, shape)))
    return x[idx]


def as_complex(x, name=None):
    (x,) = _cast_inputs("as_complex", ensure_tensor(x))
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    (x,) = _cast_inputs("as_real", ensure_tensor(x))
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


def tensordot(x, y, axes=2, name=None):
    x, y = _cast_inputs("tensordot", ensure_tensor(x), ensure_tensor(y))
    return torch.tensordot(x, y, dims=axes)


def numel(x, name=None):
    x = ensure_tensor(x)
    return torch.full((), x.numel(), dtype=torch.int64, device=x.device)


def rank(x):
    x = ensure_tensor(x)
    return torch.full((), x.ndim, dtype=torch.int64, device=x.device)


def shape(x):
    x = ensure_tensor(x)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    (x,) = _cast_inputs("diagonal", ensure_tensor(x))
    return torch.diagonal(x, offset, axis1, axis2)


def unstack(x, axis=0, num=None, name=None):
    """Split along ``axis`` into a list of tensors with that axis removed
    (reference fluid.layers.unstack)."""
    (x,) = _cast_inputs("unstack", ensure_tensor(x))
    if num is not None and num != x.shape[axis]:
        raise ValueError(f"unstack num={num} mismatches axis extent {x.shape[axis]}")
    return list(torch.unbind(x, axis))


def reverse(x, axis, name=None):
    """``flip``'s other name (the reference keeps both)."""
    return flip(x, axis)


def multiplex(inputs, index, name=None):
    """Row-wise select: ``out[i] = inputs[index[i, 0]][i]``."""
    idx, *ins = _cast_inputs("multiplex", ensure_tensor(index), *[ensure_tensor(t) for t in inputs])
    stacked = torch.stack(ins, dim=0)
    sel = idx.reshape(-1).long().reshape((1, -1) + (1,) * (stacked.ndim - 2))
    return torch.take_along_dim(stacked, sel, dim=0)[0]


def tolist(x):
    return ensure_tensor(x).tolist()


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def squeeze_(x, axis=None, name=None):
    if axis is None:
        return x.squeeze_()
    for a in sorted(_squeeze_axes(x, axis), reverse=True):
        x.squeeze_(a)
    return x


def unsqueeze_(x, axis, name=None):
    for a in _unsqueeze_axes(x, axis):
        x.unsqueeze_(a)
    return x


def scatter_(x, index, updates, overwrite=True, name=None):
    idx = _long(index).reshape(-1)
    updates = ensure_tensor(updates, device=x.device).to(x.dtype)
    if overwrite:
        return x.copy_(_overwrite(x, flat_positions(x).index_select(0, idx), updates))
    return x.index_add_(0, idx, updates)


def put_along_axis_(arr, indices, values, axis, reduce="assign", name=None):
    return _along(arr, indices, values, axis, reduce, True)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _restride_(x, _flat_shape(x, start_axis, stop_axis))

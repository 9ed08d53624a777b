"""Search and sort (``paddle_tpu/tensor/search.py``; parity:
python/paddle/tensor/search.py).

Orders follow the reference's JAX ones: ``argsort``/``sort`` are stable,
and ``topk`` and ``kthvalue`` take tied values lowest index first, so both
run a stable sort (torch's ``topk`` promises no order among ties on CUDA).
``mode`` returns (values, counts), as the reference's does (scipy's
``stats.mode`` on the host there; on the device here, smallest value among
ties), not Paddle's (values, indices): ROADMAP.md, "Faults in the
reference".
"""
from __future__ import annotations

import torch

from ._helpers import cast, ensure_tensor, flat_positions, overwrite, to_torch_dtype

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode", "nonzero",
           "searchsorted", "bucketize", "index_put"]


def _arg(fn, name, x, axis, keepdim, dtype):
    (x,) = cast(name, ensure_tensor(x))
    if axis is None:
        out = fn(x.reshape(-1), 0)
    else:
        out = fn(x, int(axis), keepdim=keepdim)
    return out.to(to_torch_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, "argmax", x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, "argmin", x, axis, keepdim, dtype)


def _stable_order(x, axis, descending):
    """The stable sorting permutation along ``axis``; descending sorts
    ``-x`` ascending for a float, as the reference does (NaNs last)."""
    if descending and x.is_floating_point():
        return torch.argsort(-x, dim=axis, stable=True)
    return torch.argsort(x, dim=axis, descending=descending, stable=True)


def argsort(x, axis=-1, descending=False, name=None):
    (x,) = cast("argsort", ensure_tensor(x))
    return _stable_order(x.detach(), axis, descending)


def sort(x, axis=-1, descending=False, name=None):
    (x,) = cast("sort", ensure_tensor(x))
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, (axis,)) if descending else out


def topk(x, k, axis=None, largest=True, sorted=True, name=None):  # noqa: A002
    (x,) = cast("topk", ensure_tensor(x))
    k = int(k.item() if isinstance(k, torch.Tensor) else k)
    ax = -1 if axis is None else int(axis)
    idx = _stable_order(x.detach(), ax, largest).narrow(ax, 0, k)
    return torch.take_along_dim(x, idx, dim=ax), idx


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    (x,) = cast("kthvalue", ensure_tensor(x))
    idx = torch.argsort(x.detach(), dim=axis, stable=True).narrow(axis, k - 1, 1)
    vals = torch.take_along_dim(x, idx, dim=axis)
    if not keepdim:
        vals, idx = vals.squeeze(axis), idx.squeeze(axis)
    return vals, idx


@torch.no_grad()
def mode(x, axis=-1, keepdim=False, name=None):
    """(the most frequent value, its count) along ``axis``; the smallest
    value among equally frequent ones."""
    (x,) = cast("mode", ensure_tensor(x))
    v = torch.movedim(x, axis, -1)
    lead, n = v.shape[:-1], v.shape[-1]
    s = torch.sort(v.reshape(-1, n), dim=-1).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    seg = torch.cumsum(new, -1) - 1
    counts = torch.zeros_like(seg).scatter_add_(1, seg, torch.ones_like(seg))
    best = torch.argmax(counts, -1, keepdim=True)  # the first, so the smallest value
    first = torch.argmax((seg == best).to(torch.int8), -1, keepdim=True)
    vals = s.gather(1, first).reshape(lead)
    cnt = counts.gather(1, best).reshape(lead)
    if keepdim:
        vals, cnt = vals.unsqueeze(axis), cnt.unsqueeze(axis)
    return vals, cnt


def nonzero(x, as_tuple=False):
    x = ensure_tensor(x)
    idx = torch.nonzero(x)
    if as_tuple:
        return tuple(idx[:, i:i + 1] for i in range(idx.shape[1]))
    return idx


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None):
    s, v = cast("searchsorted", ensure_tensor(sorted_sequence),
                ensure_tensor(values, device=getattr(sorted_sequence, "device", None)))
    return torch.searchsorted(s.detach(), v.detach(), out_int32=out_int32, right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def index_put(x, indices, value, accumulate=False, name=None):
    x, value = cast("index_put", ensure_tensor(x), ensure_tensor(value))
    idx = tuple(i if i.dtype in (torch.int64, torch.bool) else i.long()
                for i in (ensure_tensor(i, device=x.device) for i in indices))
    if accumulate:
        return x.index_put(idx, value.to(x.dtype), accumulate=True)
    dest = flat_positions(x)[idx]  # duplicates: the last write lands, as in the reference
    return overwrite(x, dest, torch.broadcast_to(value, dest.shape))

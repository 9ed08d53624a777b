"""Sequence ops of the port (``paddle_tpu/nn/functional/sequence.py``).

A variable-length batch is the pair the reference uses in place of a
LoDTensor: the padded dense ``[batch, maxlen, ...]`` tensor and the
lengths ``[batch]``, which :func:`sequence_pad` makes. The masks come from
the lengths by an ``arange`` compare. Output shapes that depend on the
data (``sequence_pad``, ``sequence_unpad``, ``sequence_expand``) read the
lengths on the host, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sequence_mask", "sequence_pad", "sequence_unpad", "sequence_pool",
           "sequence_softmax", "sequence_expand"]


def _torch_dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


def _valid(lengths, t, ndim):
    """``[b, t, 1, ...]``: True at the positions before each length."""
    mask = torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]
    return mask.reshape(mask.shape + (1,) * (ndim - 2))


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``[b]`` lengths -> the ``[b, maxlen]`` 0/1 mask in ``dtype``;
    ``maxlen`` None: the longest length."""
    if maxlen is None:
        maxlen = int(x.max())
    elif not isinstance(maxlen, int):
        maxlen = int(maxlen)
    return (torch.arange(maxlen, device=x.device)[None, :] < x[..., None]).to(_torch_dtype(dtype))


def sequence_pad(sequences, pad_value=0.0, maxlen=None, name=None):
    """A list of ``[len_i, ...]`` tensors -> ``(padded [b, maxlen, ...],
    lengths [b])``; ``maxlen`` below the longest raises."""
    if not sequences:
        raise ValueError("sequence_pad needs at least one sequence")
    lengths = [int(s.shape[0]) for s in sequences]
    m = int(maxlen) if maxlen is not None else max(lengths)
    if maxlen is not None and max(lengths) > m:
        raise ValueError(f"maxlen={m} < longest sequence {max(lengths)}")
    first = sequences[0]
    out = torch.full((len(sequences), m) + tuple(first.shape[1:]), pad_value, dtype=first.dtype,
                     device=first.device)
    for i, s in enumerate(sequences):
        out[i, :s.shape[0]] = s
    return out, torch.tensor(lengths, dtype=torch.int64, device=first.device)


def sequence_unpad(x, length, name=None):
    """``(padded, lengths)`` -> the list of ``[len_i, ...]`` slices (views:
    a gradient flows back into ``x``, zeros in the padding)."""
    return [x[i, :int(n)] for i, n in enumerate(np.asarray(length.detach().cpu(), np.int64))]


def sequence_pool(x, lengths, pool_type="average", name=None):
    """Pooling over the valid time steps of ``(padded [b, t, ...],
    lengths)``: ``sum``, ``average``, ``sqrt`` (the sum over the square root
    of the length), ``max`` (the dtype's lowest value in the padding),
    ``first`` or ``last``; a length 0 averages over 1."""
    pool_type = pool_type.lower()
    if pool_type not in ("sum", "average", "sqrt", "max", "first", "last"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    valid = _valid(lengths, x.shape[1], x.ndim)
    if pool_type in ("sum", "average", "sqrt"):
        s = torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device)).sum(dim=1)
        if pool_type == "sum":
            return s
        den = lengths.clamp(min=1).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 2))
        return s / (torch.sqrt(den) if pool_type == "sqrt" else den)
    if pool_type == "max":
        low = torch.finfo(x.dtype).min if x.is_floating_point() else torch.iinfo(x.dtype).min
        return torch.where(valid, x, torch.tensor(low, dtype=x.dtype, device=x.device)).amax(dim=1)
    if pool_type == "first":
        return x[:, 0]
    idx = (lengths - 1).clamp(min=0).reshape((-1, 1) + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand((-1, 1) + tuple(x.shape[2:])))[:, 0]


def sequence_softmax(x, lengths, name=None):
    """Softmax over each sequence's valid time steps; the padding gets 0."""
    valid = _valid(lengths, x.shape[1], x.ndim)
    z = torch.where(valid, x, torch.tensor(-torch.inf, dtype=x.dtype, device=x.device))
    z = z - z.amax(dim=1, keepdim=True)
    e = torch.where(valid, torch.exp(z), torch.zeros((), dtype=x.dtype, device=x.device))
    return e / e.sum(dim=1, keepdim=True).clamp(min=1e-30)


def sequence_expand(x, lengths, name=None):
    """Row i of ``x`` repeated ``lengths[i]`` times along dim 0 (the
    gradient sums back over each row's repeats)."""
    reps = torch.as_tensor(np.asarray(lengths.detach().cpu(), np.int64), device=x.device)
    return torch.repeat_interleave(x, reps, dim=0)

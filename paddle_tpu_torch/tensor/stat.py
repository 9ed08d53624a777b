"""Statistics (``paddle_tpu/tensor/stat.py``; parity:
python/paddle/tensor/stat.py).

``median``, ``nanmedian``, ``quantile`` and ``nanquantile`` are the
reference's ``jnp.quantile`` arithmetic over one stable sort: the
position ``q (n - 1)`` between its floor and ceiling, linear, or their
midpoint for the medians (an even count averages the two middle values;
``torch.median`` would return the lower one). ``n`` counts the non-NaN
entries for the ``nan*`` forms; otherwise a NaN makes the result NaN. One
sort has no size limit (``torch.quantile`` refuses inputs above 16M
entries).
"""
from __future__ import annotations

import torch

from ._helpers import axis as _axis, cast, default_float, ensure_tensor

__all__ = ["std", "var", "median", "nanmedian", "quantile", "nanquantile", "histogram", "bincount",
           "corrcoef", "cov"]


def _float(x):
    return x if x.is_floating_point() else x.to(default_float())


def _dims(x, axis):
    ax = _axis(axis)
    if ax is None:
        return tuple(range(x.ndim))
    return ax


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    (x,) = cast("std", ensure_tensor(x))
    return torch.std(_float(x), dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    (x,) = cast("var", ensure_tensor(x))
    return torch.var(_float(x), dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _quantile(x, q, axis, keepdim, midpoint, squash_nans):
    x = _float(x)
    nd = x.ndim
    ax = _axis(axis)
    red = list(range(nd)) if ax is None else sorted(
        a % nd for a in ((ax,) if isinstance(ax, int) else ax))
    keep = [i for i in range(nd) if i not in red]
    lead = [x.shape[i] for i in keep]
    v = x.permute(*keep, *red).reshape(*lead, -1)
    s = torch.sort(v, dim=-1, stable=True).values  # NaNs sort last
    nan = torch.isnan(s)
    # positions in float64, so an index above 2**24 stays exact
    if squash_nans:
        counts = (~nan).sum(-1, keepdim=True).to(torch.float64)
    else:
        s = torch.where(nan.any(-1, keepdim=True), torch.full((), float("nan"), dtype=s.dtype,
                                                                device=s.device), s)
        counts = torch.full((), s.shape[-1], dtype=torch.float64, device=s.device)
    vector = not isinstance(q, (int, float))
    if vector:  # a list or tensor of quantiles: one leading output axis
        qt = torch.as_tensor(q, dtype=torch.float64, device=s.device).reshape(-1)
        pos = qt.reshape((-1,) + (1,) * (len(lead) + 1)) * (counts - 1)
    else:
        pos = float(q) * (counts - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_weight = (pos - low).to(s.dtype)
    low_weight = 1 - high_weight
    top = counts - 1
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top)).long()
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, top)).long()
    src = s.expand((qt.shape[0],) + tuple(s.shape)) if vector else s
    low_value = torch.gather(src, -1, low.expand(src.shape[:-1] + (1,)))
    high_value = torch.gather(src, -1, high.expand(src.shape[:-1] + (1,)))
    if midpoint:
        out = (low_value + high_value) * 0.5
    else:
        out = low_value * low_weight + high_value * high_weight
    out = out.squeeze(-1)
    if keepdim:
        shape = [1 if i in red else x.shape[i] for i in range(nd)]
        out = out.reshape(((qt.shape[0],) if vector else ()) + tuple(shape))
    return out


def median(x, axis=None, keepdim=False, name=None):
    (x,) = cast("median", ensure_tensor(x))
    return _quantile(x, 0.5, axis, keepdim, True, False)


def nanmedian(x, axis=None, keepdim=False, name=None):
    (x,) = cast("nanmedian", ensure_tensor(x))
    return _quantile(x, 0.5, axis, keepdim, True, True)


def quantile(x, q, axis=None, keepdim=False, name=None):
    (x,) = cast("quantile", ensure_tensor(x))
    return _quantile(x, q, axis, keepdim, False, False)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    (x,) = cast("nanquantile", ensure_tensor(x))
    return _quantile(x, q, axis, keepdim, False, True)


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    """Counts in ``bins`` equal bins over ``[min, max]`` (the data's range
    when both are 0), as int64."""
    (x,) = cast("histogram", ensure_tensor(input))
    x = x.detach()
    x = x if x.is_floating_point() else x.to(torch.float32)
    return torch.histc(x, bins=bins, min=min, max=max).to(torch.int64)


def bincount(x, weights=None, minlength=0, name=None):
    x = ensure_tensor(x)
    if weights is not None:
        x, weights = cast("bincount", x, ensure_tensor(weights, device=x.device))
    return torch.bincount(x, weights=weights, minlength=int(minlength))


def corrcoef(x, rowvar=True, name=None):
    (x,) = cast("corrcoef", ensure_tensor(x))
    return torch.corrcoef(_float(x) if rowvar else _float(x).T)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """The covariance (the reference ignores ``fweights`` and ``aweights``;
    so does the port)."""
    (x,) = cast("cov", ensure_tensor(x))
    return torch.cov(_float(x) if rowvar else _float(x).T, correction=1 if ddof else 0)


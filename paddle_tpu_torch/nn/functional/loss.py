"""Loss functionals of the port (``paddle_tpu/nn/functional/loss.py``): the
softmax cross entropy, its two branches as in the reference.

A hard label with the softmax and no smoothing takes the fused branch: the
per-token CE with the fused softmax-CE backward, no f32 ``[.., V]``
log-prob tensor. Soft labels, label smoothing and ``use_softmax=False``
(the input already probabilities) take the reference's non-fused branch:
f32 log-probabilities (``log_softmax``, or ``log(max(p, 1e-30))``), the
soft or smoothed one-hot target, ``ignore_index``, ``weight`` and the
reduction in the reference's order. In an ``auto_cast`` scope the inputs
of its dtype go up to f32 (``cross_entropy`` is on the black list).
"""
from __future__ import annotations

import torch

from ...amp import cast_inputs


def _reduce(v, reduction):
    """``mean``, ``sum`` or ``none`` over ``v``; bf16/f16 values are
    accumulated in f32 (a bf16 mean over millions of terms loses digits)."""
    if v.dtype in (torch.bfloat16, torch.float16):
        v = v.float()
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


class _FusedSoftmaxCE(torch.autograd.Function):
    """Per-token hard-label CE. The forward keeps only row reductions (an f32
    logsumexp) and a label gather, no f32 ``[.., V]`` log-prob tensor; the
    backward rebuilds the softmax from the saved logits (bf16 under AMP) with
    the one-hot as an ``arange == label`` compare, not a scatter."""

    @staticmethod
    def forward(ctx, logits, label, axis):
        lse = _logsumexp(logits, axis)
        lab_logit = logits.gather(axis, label.unsqueeze(axis)).float()
        ctx.save_for_backward(logits, label, lse)
        ctx.axis = axis
        return (lse - lab_logit).squeeze(axis)

    @staticmethod
    def backward(ctx, g):
        logits, label, lse = ctx.saved_tensors
        ax = ctx.axis
        shape = [1] * logits.ndim
        shape[ax] = logits.shape[ax]
        iota = torch.arange(logits.shape[ax], device=logits.device).view(shape)
        onehot = (iota == label.unsqueeze(ax)).float()
        dlogits = (torch.exp(logits.float() - lse) - onehot) * g.unsqueeze(ax).float()
        return dlogits.to(logits.dtype), None, None


def _logsumexp(logits, ax):
    m = logits.amax(dim=ax, keepdim=True).float()
    return torch.log(torch.exp(logits.float() - m).sum(dim=ax, keepdim=True)) + m


def _fused_softmax_ce(logits, label, axis):
    """Per-token CE of ``logits`` against int ``label`` (the shape of
    ``logits`` without ``axis``), f32."""
    return _FusedSoftmaxCE.apply(logits, label, axis % logits.ndim)


def _hard_label(label, ndim, ax):
    """``label`` without a size-1 ``ax`` (int64)."""
    if label.ndim == ndim and label.shape[ax] == 1:
        label = label.squeeze(ax)
    return label.long()


def _weighted_mean(loss, valid, w_lab):
    """The mean over the valid rows (at least 1), or over their weights."""
    if w_lab is None:
        return loss.sum() / valid.to(loss.dtype).sum().clamp(min=1.0)
    return loss.sum() / torch.where(valid, w_lab, torch.zeros_like(w_lab)).sum()


def _unfused(logits, label, weight, ignore_index, reduction, soft_label, ax, use_softmax,
             label_smoothing):
    """The reference's non-fused branch (soft labels, smoothing, or
    probabilities in ``logits``)."""
    if logits.dtype in (torch.bfloat16, torch.float16):
        logits = logits.float()
    logp = (torch.log_softmax(logits, dim=ax) if use_softmax
            else torch.log(torch.clamp(logits, min=1e-30)))
    if soft_label:
        return _reduce(-(label * logp).sum(dim=ax), reduction)
    lab = _hard_label(label, logits.ndim, ax)
    n = logits.shape[ax]
    shape = [1] * logits.ndim
    shape[ax] = n
    iota = torch.arange(n, device=logits.device).view(shape)
    onehot = (iota == lab.unsqueeze(ax)).to(logp.dtype)  # an out-of-range label: all zero
    smoothed = onehot * (1.0 - label_smoothing) + label_smoothing / n
    loss = -(smoothed * logp).sum(dim=ax)
    valid = lab != ignore_index
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    w_lab = None if weight is None else weight[lab.clamp(min=0)]
    if w_lab is not None:
        loss = loss * w_lab
    if reduction == "mean":
        return _weighted_mean(loss, valid, w_lab)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy with the reference's arguments. ``label``: int
    labels of ``input``'s shape without ``axis`` (or with a size-1
    ``axis``), or with ``soft_label`` a distribution of ``input``'s shape.
    For hard labels, ``ignore_index`` rows count 0, ``weight`` [C] scales
    each row by its label's weight, and ``mean`` divides by the number of
    valid rows (at least 1), or by the sum of their weights; soft labels
    take neither. ``label_smoothing`` mixes the one-hot with the uniform
    distribution; ``use_softmax=False`` reads ``input`` as probabilities."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: reduction must be 'mean', 'sum' or 'none', got {reduction!r}")
    input, label, weight = cast_inputs("cross_entropy", input, label, weight)
    ax = axis % input.ndim
    if soft_label or not use_softmax or label_smoothing != 0.0:
        return _unfused(input, label, weight, ignore_index, reduction, soft_label, ax, use_softmax,
                        label_smoothing)
    lab = _hard_label(label, input.ndim, ax)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    loss = _fused_softmax_ce(input, safe, ax)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    w_lab = None if weight is None else weight[safe]
    if w_lab is not None:
        loss = loss * w_lab
    if reduction == "mean":
        return _weighted_mean(loss, valid, w_lab)
    return _reduce(loss, reduction)

"""Loss functionals of the port (``paddle_tpu/nn/functional/loss.py``): the
hard-label cross entropy with the fused softmax-CE backward.

Only the fused branch of the reference's ``cross_entropy`` is ported; soft
labels, label smoothing and ``use_softmax=False`` take its non-fused branch
and raise here (``ROADMAP.md``, Queue 1 item 6).
"""
from __future__ import annotations

import torch

_NOT_PORTED = ("cross_entropy: {} takes the reference's non-fused branch, which is not ported "
               "yet (ROADMAP.md, Queue 1 item 6)")


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


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0):
    """Hard-label softmax cross entropy as the reference's fused branch:
    ``label`` of ``input``'s shape without ``axis`` (or with a size-1
    ``axis``), ``ignore_index`` rows count 0, ``weight`` [C] scales each row
    by its label's weight, and ``mean`` divides by the number of valid rows
    (at least 1), or by the sum of their weights."""
    if soft_label:
        raise NotImplementedError(_NOT_PORTED.format("soft_label=True"))
    if label_smoothing != 0.0:
        raise NotImplementedError(_NOT_PORTED.format("label_smoothing"))
    if not use_softmax:
        raise NotImplementedError(_NOT_PORTED.format("use_softmax=False"))
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: reduction must be 'mean', 'sum' or 'none', got {reduction!r}")
    ax = axis % input.ndim
    lab = label
    if lab.ndim == input.ndim and lab.shape[ax] == 1:
        lab = lab.squeeze(ax)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    loss = _fused_softmax_ce(input, safe, ax)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        w_lab = weight[safe]
        loss = loss * w_lab
    if reduction == "mean":
        if weight is None:
            denom = valid.to(loss.dtype).sum().clamp(min=1.0)
        else:
            denom = torch.where(valid, w_lab, torch.zeros_like(w_lab)).sum()
        return loss.sum() / denom
    return _reduce(loss, reduction)

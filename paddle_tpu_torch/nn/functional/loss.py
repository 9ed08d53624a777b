"""Loss functionals of the port (``paddle_tpu/nn/functional/loss.py``): the
softmax cross entropy, its two branches as in the reference, and the
reference's other losses (regression, ranking, embedding, focal, dice,
n-pair, CTC, hierarchical sigmoid, ArcFace's margin softmax), each its
composition in plain tensor ops.

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

import math

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


# -- the rest of the reference's losses -----------------------------------------------
def _f32(x):
    """bf16/f16 values go up to f32 for the loss's arithmetic."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100, axis=-1,
                               return_softmax=False):
    """The per-row :func:`cross_entropy` (``reduction="none"``: the shape
    of ``logits`` without ``axis``, where Paddle keeps a size-1 axis), and
    with ``return_softmax`` the softmax too."""
    out = cross_entropy(logits, label, soft_label=soft_label, ignore_index=ignore_index,
                        reduction="none", axis=axis)
    if return_softmax:
        return out, torch.softmax(logits, dim=axis)
    return out


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.square(_f32(input) - _f32(label)), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(_f32(input) - _f32(label)), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """Huber: ``0.5 d^2 / delta`` below ``delta``, ``|d| - 0.5 delta`` above."""
    d = _f32(input) - _f32(label)
    absd = torch.abs(d)
    return _reduce(torch.where(absd < delta, 0.5 * d * d / delta, absd - 0.5 * delta), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean", name=None):
    """The negative log-probability of each row's label, the classes along
    dim 1 (``[N, C]`` or ``[N, C, d1, ...]``); ``ignore_index`` rows count
    0; ``mean`` over the valid rows (at least 1), or their weights."""
    lbl = label.long()
    loss = -torch.gather(input, 1, lbl.clamp(min=0).unsqueeze(1)).squeeze(1)
    valid = lbl != ignore_index
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    w_lab = None if weight is None else weight[lbl.clamp(min=0)]
    if w_lab is not None:
        loss = loss * w_lab
    if reduction == "mean":
        return _weighted_mean(loss, valid, w_lab)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean", name=None):
    """BCE of probabilities, clipped to ``[1e-12, 1 - 1e-7]``."""
    p = torch.clamp(_f32(input), 1e-12, 1.0 - 1e-7)
    loss = -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def _softplus_neg_abs(z):
    return torch.logaddexp(torch.zeros((), dtype=z.dtype, device=z.device), -torch.abs(z))


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean", pos_weight=None,
                                     name=None):
    """BCE of logits in the stable form; ``pos_weight`` scales the positive
    term."""
    z = _f32(logit)
    if pos_weight is not None:
        loss = ((1 - label) * z + (1 + (pos_weight - 1) * label)
                * (_softplus_neg_abs(z) + torch.clamp(-z, min=0)))
    else:
        loss = torch.clamp(z, min=0) - z * label + _softplus_neg_abs(z)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """``label * (log(label) - input)`` (``input`` log-probabilities; the
    log floored at 1e-30); ``batchmean`` divides the sum by the batch."""
    loss = label * (torch.log(torch.clamp(label, min=1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean", name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean", name=None):
    return _reduce(torch.where(label == 1.0, input, torch.clamp(margin - input, min=0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0, reduction="mean", name=None):
    """``1 - cos`` for label 1, ``max(0, cos - margin)`` otherwise (the
    norms' product floored at 1e-12)."""
    norms = torch.linalg.vector_norm(input1, dim=-1) * torch.linalg.vector_norm(input2, dim=-1)
    cos = (input1 * input2).sum(dim=-1) / torch.clamp(norms, min=1e-12)
    return _reduce(torch.where(label == 1, 1.0 - cos, torch.clamp(cos - margin, min=0.0)),
                   reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                        reduction="mean", name=None):
    """``max(d(a, pos) - d(a, neg) + margin, 0)``, ``d`` the p-norm of the
    difference plus ``epsilon``; ``swap`` takes the smaller of the two
    negative distances."""
    def dist(a, b):
        return torch.linalg.vector_norm(a - b + epsilon, ord=p, dim=-1)

    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dist(input, positive) - dn + margin, min=0.0), reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) - (1.0 - label) * torch.log(1.0 - input + epsilon)


def square_error_cost(input, label):
    return torch.square(input - label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0, reduction="sum",
                       name=None):
    """The focal loss of logits: the BCE weighted ``alpha_t (1 - p_t)^gamma``,
    divided by ``normalizer`` where given."""
    p = torch.sigmoid(logit)
    ce = torch.clamp(logit, min=0) - logit * label + _softplus_neg_abs(logit)
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - (2 |X n Y| + eps) / (|X| + |Y| + eps)`` over all but the batch
    dim, ``label`` the class indices ``[.., 1]``; the batch mean."""
    onehot = torch.nn.functional.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(input.dtype)
    red = tuple(range(1, input.ndim))
    inter = (input * onehot).sum(dim=red)
    union = input.sum(dim=red) + onehot.sum(dim=red)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """N-pair loss: the cross entropy of ``anchor @ positive.T`` against the
    rows' same-label distribution, plus ``l2_reg / 4`` times the mean
    squared norms of both embeddings."""
    lv = labels.reshape(-1, 1)
    tgt = (lv == lv.T).float()
    tgt = tgt / tgt.sum(dim=1, keepdim=True)
    a, p = anchor.float(), positive.float()
    ce = -(tgt * torch.log_softmax(a @ p.T, dim=1)).sum(dim=1).mean()
    reg = l2_reg * 0.25 * ((a ** 2).sum(1).mean() + (p ** 2).sum(1).mean())
    return ce + reg


_CTC_FLOOR = -1e30


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0, reduction="mean",
             name=None):
    """CTC by the forward algorithm in log space, the reference's way:
    ``log_probs`` is ``[T, B, C]`` LOGITS despite its name (the function
    applies ``log_softmax`` itself), labels ``[B, L]``, and an impossible
    path is floored at -1e30, not -inf, so an infeasible alignment gives a
    finite loss near 1e30 where ``torch.nn.functional.ctc_loss`` gives inf
    (ROADMAP.md, "Faults in the reference"). ``mean`` divides each loss by
    its label length (at least 1), then averages."""
    T, B, _ = log_probs.shape
    logp = torch.log_softmax(log_probs.float(), dim=-1)
    lv, ilv, llv = labels.long(), input_lengths.long(), label_lengths.long()
    S = 2 * lv.shape[1] + 1
    dev = logp.device
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lv
    neg = torch.tensor(_CTC_FLOOR, dtype=torch.float32, device=dev)
    rows = torch.arange(B, device=dev)
    alpha = torch.full((B, S), _CTC_FLOOR, dtype=torch.float32, device=dev)
    alpha = torch.cat([logp[0, rows, blank][:, None],
                       torch.where(llv > 0, logp[0, rows, ext[:, 1]], neg)[:, None],
                       alpha[:, 2:]], dim=1)
    allow_skip = torch.cat([torch.zeros((B, 2), dtype=torch.bool, device=dev),
                            (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])], dim=1)
    pad1, pad2 = neg.expand(B, 1), neg.expand(B, 2)
    for t in range(1, T):
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.where(allow_skip, torch.cat([pad2, alpha[:, :-2]], dim=1), neg)
        new = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + torch.gather(logp[t], 1, ext)
        alpha = torch.where((t < ilv)[:, None], new, alpha)
    sidx = 2 * llv
    last_blank = torch.gather(alpha, 1, sidx[:, None])[:, 0]
    last_label = torch.gather(alpha, 1, (sidx - 1).clamp(min=0)[:, None])[:, 0]
    loss = -torch.logaddexp(last_blank, torch.where(llv > 0, last_label, neg))
    if reduction == "mean":
        return (loss / torch.clamp(llv.float(), min=1.0)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def hsigmoid_loss(input, label, num_classes, weight, bias=None, path_table=None, path_code=None,
                  is_sparse=False, name=None):
    """Hierarchical sigmoid over the reference's default tree: the classes
    are the leaves ``num_classes + label`` of an implicit heap, node ``n``'s
    weight is row ``n - 1`` of ``weight`` ``[num_classes - 1, feature]``
    (``bias`` ``[num_classes - 1, 1]``), a right child scores
    ``log sigmoid(logit)`` and a left one ``log sigmoid(-logit)``, for
    ``ceil(log2(num_classes))`` levels; the batch mean. Custom trees
    (``path_table``/``path_code``) are not there, as in the reference."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError("custom trees not supported; use the default tree")
    depth = max(1, int(math.ceil(math.log2(max(num_classes, 2)))))
    x = input.float()
    code = label.reshape(-1).long() + num_classes
    loss = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for _ in range(depth):
        parent = code // 2
        node = (parent - 1).clamp(0, weight.shape[0] - 1)
        logit = (x * weight[node].float()).sum(dim=1)
        if bias is not None:
            logit = logit + bias.reshape(-1)[node].float()
        ll = torch.nn.functional.logsigmoid(torch.where(code % 2 > 0, logit, -logit))
        loss = loss - torch.where(parent >= 1, ll, torch.zeros_like(ll))
        code = parent
    return loss.mean()


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0, scale=64.0,
                         group=None, return_softmax=False, reduction="mean", name=None):
    """ArcFace's margin softmax: the target's cosine (``logits`` clipped to
    [-1, 1]) becomes ``cos(margin1 theta + margin2) - margin3``, all scaled,
    then the cross entropy. A model-parallel ``group`` raises, as in the
    reference (a per-shard softmax would be wrong)."""
    if group is not None:
        raise NotImplementedError(
            "margin_cross_entropy over a model-parallel group: use the vocab/class-sharded "
            "ParallelCrossEntropy path (distributed mp_layers); a per-shard softmax would be wrong")
    y = label.reshape(-1).long()
    cos = torch.clamp(logits.float(), -1.0, 1.0)
    tgt = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    onehot = torch.nn.functional.one_hot(y, logits.shape[-1]) > 0
    logp = torch.log_softmax(torch.where(onehot, tgt, cos) * scale, dim=-1)
    loss = -torch.gather(logp, 1, y[:, None])[:, 0]
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


__all__ = ["cross_entropy", "softmax_with_cross_entropy", "mse_loss", "l1_loss", "smooth_l1_loss",
           "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss", "cosine_embedding_loss",
           "triplet_margin_loss", "log_loss", "square_error_cost", "sigmoid_focal_loss",
           "dice_loss", "npair_loss", "ctc_loss", "hsigmoid_loss", "margin_cross_entropy"]

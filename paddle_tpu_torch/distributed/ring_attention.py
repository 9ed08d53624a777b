"""Sequence parallelism of the port (``paddle_tpu/distributed/ring_attention.py``):
ring attention and Ulysses attention over a ``sep`` group.

The reference maps each function over a mesh axis with ``shard_map``; the
port runs one process per rank, so each function takes this rank's block
of the sequence, ``[b, s / n, h, d]`` with rank r holding positions
``[r * s / n, (r + 1) * s / n)``, and returns the output of those
positions. Both differentiate: the collectives they run are wrapped so
their backward runs the reverse exchange.

- :func:`ring_attention`: the online-softmax ring. K/V and their owner's
  index go round the ring by :func:`~.collective.ppermute` while each rank
  accumulates its queries' attention; causal masking uses global
  positions. Plain PyTorch, as the reference's is jnp: the reference has no
  Pallas kernel here, and K1 takes no query offset.
- :func:`ulysses_attention`: one all-to-all from sequence blocks to head
  blocks (each rank then holds ``h / n`` heads over the whole sequence),
  attention there through the ``sdpa`` registry kernel (K1 and K2 on the
  card; the reference calls its plain ``_sdpa_reference``, which computes
  the same function), and the all-to-all back. GPT's stacked trunk runs
  the same exchange on its packed ``[b, s, 3, h, d]`` projection
  (:func:`seq_to_heads`, :func:`heads_to_seq`).
"""
from __future__ import annotations

import math

import torch

from . import collective

__all__ = ["ring_attention", "ulysses_attention", "seq_to_heads", "heads_to_seq"]


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all: ``x``'s ``n`` blocks along ``split_axis`` one
    to each rank, the blocks received concatenated along ``concat_axis``;
    its backward is the all-to-all with the two axes swapped."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return collective.alltoall(x, group=group, split_axis=split_axis, concat_axis=concat_axis)

    @staticmethod
    def backward(ctx, dy):
        group, split_axis, concat_axis = ctx.args
        dx = collective.alltoall(dy.contiguous(), group=group, split_axis=concat_axis,
                                 concat_axis=split_axis)
        return dx, None, None, None


class _PPermute(torch.autograd.Function):
    """``collective.ppermute``; its backward sends the gradient back along
    the reversed pairs."""

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.args = (perm, group)
        return collective.ppermute(x, perm, group=group)

    @staticmethod
    def backward(ctx, dy):
        perm, group = ctx.args
        return collective.ppermute(dy.contiguous(), [(d, s) for s, d in perm], group=group), \
            None, None


def _heads_divide(h, g, what):
    if h % g.nranks:
        raise ValueError(f"{what}: {h} heads do not split over a sep group of {g.nranks} ranks")


def seq_to_heads(x, group, head_axis=2):
    """``[b, s / n, ..., h, ...]`` (this rank's sequence block, heads at
    ``head_axis``) -> ``[b, s, ..., h / n, ...]`` (the whole sequence, this
    rank's block of heads); contiguous."""
    g = collective._group(group)
    _heads_divide(x.shape[head_axis], g, "seq_to_heads")
    return _AllToAll.apply(x, g, head_axis, 1)


def heads_to_seq(x, group, head_axis=2):
    """:func:`seq_to_heads`'s inverse."""
    g = collective._group(group)
    if x.shape[1] % g.nranks:
        raise ValueError(f"heads_to_seq: a sequence of {x.shape[1]} does not split over a sep "
                         f"group of {g.nranks} ranks")
    return _AllToAll.apply(x, g, 1, head_axis)


def _block_attn(q, k, v, q_off, k_off, causal, scale):
    """One block's contribution with its running-softmax pieces: q
    ``[B, H, Sq, D]``, k/v ``[B, H, Sk, D]``; returns ``(o, l, m)``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        qpos = q_off + torch.arange(s.shape[2], device=s.device)[:, None]
        kpos = k_off + torch.arange(s.shape[3], device=s.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, -math.inf))
    m = s.amax(dim=-1)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o, p.sum(dim=-1), torch.where(finite, m, torch.full_like(m, -math.inf))


def ring_attention(q, k, v, group="sep", causal=True):
    """Attention of this rank's queries over the whole sequence, q/k/v this
    rank's block ``[b, s / n, h, d]`` of the ``n`` ranks of ``group`` (a
    :class:`~.collective.Group` or an axis name); returns the block's output
    in q's dtype. K/V rotate round the ring (rank i to i + 1) n - 1 times."""
    g = collective._group(group)
    n = g.nranks
    scale = 1.0 / math.sqrt(q.shape[-1])
    ql, kb, vb = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S/n, D]
    seq_local = ql.shape[2]
    q_off = g.rank * seq_local
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc = torch.zeros(ql.shape, dtype=torch.float32, device=q.device)
    denom = torch.zeros(ql.shape[:3], dtype=torch.float32, device=q.device)
    m_run = torch.full(ql.shape[:3], -math.inf, dtype=torch.float32, device=q.device)
    owner = torch.tensor(g.rank, device=q.device)
    for i in range(n):
        o, l, m = _block_attn(ql, kb, vb, q_off, owner * seq_local, causal, scale)
        m_new = torch.maximum(m_run, m)
        m_new_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        alpha = torch.where(torch.isfinite(m_run), torch.exp(m_run - m_new_safe),
                            torch.zeros_like(m_run))
        beta = torch.where(torch.isfinite(m), torch.exp(m - m_new_safe), torch.zeros_like(m))
        acc = acc * alpha[..., None] + o * beta[..., None]
        denom = denom * alpha + l * beta
        m_run = m_new
        if i < n - 1:  # the next block and its owner from the previous rank
            kb = _PPermute.apply(kb.contiguous(), perm, g)
            vb = _PPermute.apply(vb.contiguous(), perm, g)
            owner = collective.ppermute(owner, perm, group=g)
    out = acc / denom.clamp(min=1e-30)[..., None]
    return out.to(q.dtype).transpose(1, 2)


def ulysses_attention(q, k, v, group="sep", causal=True):
    """DeepSpeed-Ulysses: q/k/v this rank's block ``[b, s / n, h, d]``; an
    all-to-all gives each rank ``h / n`` heads over the whole sequence,
    ``scaled_dot_product_attention`` (the ``sdpa`` kernel) runs there, and
    an all-to-all brings the output back to ``[b, s / n, h, d]``. Raises
    unless h divides by n."""
    from ..nn.functional.attention import scaled_dot_product_attention

    g = collective._group(group)
    _heads_divide(q.shape[2], g, "ulysses_attention")
    qh, kh, vh = (seq_to_heads(t, g) for t in (q, k, v))
    out = scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    return heads_to_seq(out, g)

"""Attention functionals of the port (``paddle_tpu/nn/functional/attention.py``).

Kernel selection goes through :mod:`paddle_tpu_torch.ops.registry`; two
kernels are defined here, with the reference's implementations in its
order:

- ``sdpa``: the scaled-dot-product entry point. Impls: ``flash`` (kernels
  K1 forward and K2 backward: no mask, no dropout, self-attention),
  ``flash_flat_gqa`` (kernels K3 and K3b, behind ``FLAGS_flash_flat``: an
  additive or bool ``[b|1, 1, s, s]`` mask, K/V with ``h_kv | h`` heads, no
  dropout) and the ``xla`` fallback, the plain composite, named as in the
  reference.
- ``attention_core``: GPT's packed-qkv causal core. Impls: ``flash_packed``
  (K3 and K3b over strided views of the packed projection, behind
  ``FLAGS_flash_flat``), ``flash`` (K1 and K2 over the same views) and the
  ``xla`` fallback. Both kernel impls write the gradient into one packed
  tensor.
"""
from __future__ import annotations

import math

import torch

from ...amp import cast_inputs
from ...framework import random as _random
from ...framework.flags import flag
from ...ops import flash_attention_flat as _flat
from ...ops import registry as _registry
from ...ops.flash_attention import (flash_attention_available, flash_attention_bwd,
                                   flash_attention_fwd)
from . import common as _common


def scaled_dot_product_attention(query, key, value, attn_mask=None, dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """q/k/v: ``[batch, seq, heads, head_dim]`` (paddle layout). Dispatches
    through the ``sdpa`` registry kernel; ``generator`` draws the dropout
    mask (default: the current random stream's next key, drawn only when
    dropping, as the reference draws its key). In an ``auto_cast`` scope q,
    k, v run in its dtype (the ``sdpa`` op is on the white list); a float
    mask keeps its own (the scores it is added to are f32 in every impl).
    This departs from the reference, whose AMP casts the mask too: there a
    0 / -1e30 padding mask becomes -inf under float16 and about -1e30 in
    bf16, here it keeps its dtype. A float16 mask that reaches the flat kernels
    (K3/K3b) is turned into f32 with -inf at -1e30 first, since they need
    a finite bias."""
    p = dropout_p if training else 0.0
    if p > 0.0 and generator is None:
        generator = _random.next_generator(query.device)
    query, key, value = cast_inputs("sdpa", query, key, value)
    return _registry.dispatch("sdpa", query, key, value, attn_mask, is_causal, p, generator)


def _dropout(probs, p, generator):
    """The reference's attention dropout: the kept probabilities times
    ``1 / (1 - p)`` in their dtype, the mask drawn by
    :func:`~paddle_tpu_torch.framework.random.site_mask` (``generator`` may
    be a :class:`~paddle_tpu_torch.framework.random.Shard`: this rank's
    heads of the global mask)."""
    keep = _random.site_mask(probs.shape, p, generator, probs.device)
    scale = torch.tensor(1.0 / (1.0 - p), dtype=probs.dtype, device=probs.device)
    return torch.where(keep, probs * scale, torch.zeros((), dtype=probs.dtype, device=probs.device))


def _sdpa_reference(q, k, v, mask=None, causal=False, dropout_p=0.0, generator=None):
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, D]
    logits = (qh @ kh.transpose(-1, -2)).float() * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~cm, -1e30)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, -1e30)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    if dropout_p > 0.0:
        probs = _dropout(probs, dropout_p, generator)
    return (probs @ vh).transpose(1, 2)


def _sdpa_flash_available(q, k, v, mask, causal, dropout_p, generator):
    return (mask is None and dropout_p == 0.0 and flag("FLAGS_use_flash_attention")
            and q.dtype == k.dtype == v.dtype and tuple(v.shape) == tuple(q.shape)
            and q.device.type == k.device.type == v.device.type
            and flash_attention_available(tuple(q.shape), tuple(k.shape), q.dtype, q.device.type))


def _sdpa_flash(q, k, v, mask, causal, dropout_p, generator):
    return flash_attention_fwd(q, k, v, causal)[0]


def _sdpa_flat_available(q, k, v, mask, causal, dropout_p, generator):
    # masked / GQA envelope: additive or bool [b|1, 1, s, s] masks and
    # h_kv | h grouped K/V run through K3/K3b when FLAGS_flash_flat is on
    if mask is None or dropout_p != 0.0 or not flag("FLAGS_use_flash_attention"):
        return False
    b, s, h, d = q.shape
    kv_ok = tuple(k.shape) == tuple(q.shape) or (
        k.shape[0] == b and k.shape[1] == s and h % k.shape[2] == 0 and k.shape[3] == d)
    return (_flat.enabled((b, s, 3, h, d), q.dtype, q.device.type) and kv_ok
            and tuple(v.shape) == tuple(k.shape) and q.dtype == k.dtype == v.dtype
            and q.device.type == k.device.type == v.device.type == mask.device.type
            and (mask.dtype == torch.bool or mask.dtype in _flat.BIAS_DTYPES)
            and _flat.mask_supported(b, s, h, d, tuple(mask.shape)))


def _sdpa_flat(q, k, v, mask, causal, dropout_p, generator):
    if mask.dtype == torch.bool:
        mask = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device).masked_fill(
            ~mask, -1e30)
    elif mask.dtype == torch.float16 or not _flat.bias_dtype_ok(mask.dtype, q.dtype):
        # a float16 mask holds -inf where its maker cast -1e30 or -1e9 down
        # (bf16 keeps them finite); the kernels need a finite bias, so one
        # pass makes it f32 with -inf at -1e30, as it does a 16-bit mask of
        # the operands' other type
        mask = mask.float().clamp_min(-1e30)
    return _flat.flash_flat_gqa(q, k, v, causal=causal, mask=mask)


_registry.define_kernel("sdpa", flags=("FLAGS_use_flash_attention", "FLAGS_flash_flat"))
_registry.register("sdpa", "flash", _sdpa_flash, available=_sdpa_flash_available,
                   doc="CUDA flash attention K1 + K2 (self-attn, no mask/dropout, d in 64/128)")
_registry.register("sdpa", "flash_flat_gqa", _sdpa_flat, available=_sdpa_flat_available,
                   doc="CUDA flat flash attention K3 + K3b (additive or bool [b|1,1,s,s] mask, "
                       "h_kv | h grouped K/V)")
_registry.register("sdpa", "xla", _sdpa_reference, fallback=True,
                   doc="plain PyTorch composite (any mask/dropout/shape)")


def _core_flat_available(qkv, dropout_p, generator):
    return (dropout_p == 0.0 and flag("FLAGS_use_flash_attention")
            and _flat.enabled(tuple(qkv.shape), qkv.dtype, qkv.device.type))


def _core_flat(qkv, dropout_p, generator):
    return _flat.flash_packed(qkv, causal=True)


def _core_flash_available(qkv, dropout_p, generator):
    b, s, _, h, d = qkv.shape
    return (dropout_p == 0.0 and flag("FLAGS_use_flash_attention")
            and flash_attention_available((b, s, h, d), None, qkv.dtype, qkv.device.type))


class _PackedCausalFlash(torch.autograd.Function):
    """Causal K1 over the q, k, v views of one packed ``[b, s, 3, h, d]``
    projection, whose backward has K2 write dq, dk and dv through strides
    into slices of ONE packed gradient (three ``select`` backwards would each
    zero-fill a qkv-sized buffer and add them)."""

    @staticmethod
    def forward(ctx, qkv):
        # strided views: the kernels take any strides with a unit head-dim
        # stride, so no .contiguous() copy is made
        out, lse = flash_attention_fwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True)
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = torch.empty_like(qkv)
        flash_attention_bwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], out, lse, dout, True,
                            grads=(dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2]))
        return dqkv


def _core_flash(qkv, dropout_p, generator):
    return _PackedCausalFlash.apply(qkv)


def _core_xla(qkv, dropout_p, generator):
    return _sdpa_reference(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], None, True, dropout_p, generator)


_registry.define_kernel("attention_core", flags=("FLAGS_use_flash_attention", "FLAGS_flash_flat"))
_registry.register("attention_core", "flash_packed", _core_flat, available=_core_flat_available,
                   doc="CUDA flat flash attention K3 + K3b over packed-qkv views, one packed "
                       "gradient")
_registry.register("attention_core", "flash", _core_flash, available=_core_flash_available,
                   doc="CUDA flash attention K1 + K2 over packed-qkv views, one packed gradient")
_registry.register("attention_core", "xla", _core_xla, fallback=True,
                   doc="plain PyTorch composite over packed-qkv slices (handles attention dropout)")

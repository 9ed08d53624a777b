"""Transformer layers of the port (``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention`` with its four caches, the encoder and decoder layers
and stacks, ``Transformer`` and ``generate_square_subsequent_mask``.

Attention goes through :func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention`,
so the ``sdpa`` registry picks the kernel as the reference's registry does:
with no mask and no dropout the flash kernels K1/K2, with a
``[b|1, 1, s, s]`` mask (``FLAGS_flash_flat`` on) K3/K3b, and the plain
composite for attention dropout in training, a 2-D mask or a cache's mask.

The caches, with the reference's names and fields:

- ``Cache(k, v)``: self-attention K/V ``[b, t, h, d]`` grown by
  concatenation (a new shape every step); ``attn_mask`` is the caller's,
  over all ``t`` keys, as in the reference (a decoder passes its
  ``tgt_mask``);
- ``StaticCache(k, v)``: cross-attention K/V projected once from the
  encoder's memory;
- ``FixedCache(k, v, pos)``: preallocated ``[b, max_seq, h, d]`` K/V and
  the write position (an int). The new K/V are written IN PLACE at
  ``pos`` (the reference returns new arrays from
  ``dynamic_update_slice``): the returned cache holds the same buffers and
  ``pos + s``; every step attends over the whole buffer under the
  position mask;
- ``QuantizedFixedCache(qk, sk, qv, sv, pos)``: the same with int8
  payloads and f32 ``[b, max_seq, h]`` abs-max scale planes, quantised on
  write and dequantised on read, as the reference's.

Weights are drawn from ``generator`` (None: the current random stream) on
``device`` (None: the CUDA card). An encoder or decoder stack deep-copies
its layer, as the reference's does, so all its layers start equal.
"""
from __future__ import annotations

import collections
import copy

import torch
from torch import nn

from ...framework.device import resolve_device
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm


def _fixed_cache_write(buf, new, pos):
    """``new`` ``[b, s, ...]`` written into ``buf`` ``[b, max_seq, ...]`` at
    positions ``pos ..`` in place; returns ``buf``."""
    buf[:, pos:pos + new.shape[1]] = new.to(buf.dtype)
    return buf


def _quant_scales(u):
    return torch.clamp(u.float().abs().amax(dim=-1), min=1e-8) / 127.0


def _quant_cache_write(qbuf, sbuf, u, pos):
    """``u`` ``[b, s, h, d]`` quantised to int8 with per-``(b, s, h)``
    abs-max scales, both planes written at ``pos`` in place."""
    s = _quant_scales(u)
    q = torch.clamp(torch.round(u.float() / s[..., None]), -127, 127).to(torch.int8)
    return _fixed_cache_write(qbuf, q, pos), _fixed_cache_write(sbuf, s, pos)


def _quant_cache_read(qbuf, sbuf, dtype):
    """The dequantised ``[b, max_seq, h, d]`` K or V in ``dtype``."""
    return (qbuf.float() * sbuf[..., None]).to(dtype)


def _fixed_cache_mask(pos, s, max_seq, device):
    """Bool ``[s, max_seq]``: query row i (position ``pos + i``) sees the
    keys at positions ``<= pos + i``; positions past the write frontier stay
    hidden."""
    k_pos = torch.arange(max_seq, device=device)[None, :]
    q_pos = pos + torch.arange(s, device=device)[:, None]
    return k_pos <= q_pos


class MultiHeadAttention(nn.Module):
    """``paddle.nn.MultiHeadAttention``: q, k, v and output projections
    (``[in, out]`` weights) around the ``sdpa`` kernel; ``dropout`` is the
    attention probabilities' dropout in training."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])
    FixedCache = collections.namedtuple("FixedCache", ["k", "v", "pos"])
    QuantizedFixedCache = collections.namedtuple("QuantizedFixedCache",
                                                 ["qk", "sk", "qv", "sv", "pos"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None, *, device=None,
                 generator=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        device = resolve_device(device)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, **kw)

    def _heads(self, x):
        return x.reshape(x.shape[0], -1, self.num_heads, self.head_dim)

    def _proj_kv(self, key, value):
        return self._heads(self.k_proj(key)), self._heads(self.v_proj(value))

    def gen_cache(self, key, value=None, type=None, static=False, max_seq=None, kv_dtype=None):
        """``type=StaticCache``: the cross-attention K/V of ``key``/``value``;
        ``type=Cache`` (default): an empty self-attention cache.
        ``static=True``: a :class:`FixedCache` of ``max_seq`` positions (in
        ``key``'s dtype), or with ``kv_dtype="int8"`` a
        :class:`QuantizedFixedCache`."""
        b, dev = key.shape[0], key.device
        if static:
            if max_seq is None:
                raise ValueError("gen_cache(static=True) needs max_seq=")
            shape = (b, int(max_seq), self.num_heads, self.head_dim)
            if kv_dtype is not None:
                if str(kv_dtype).replace("torch.", "") != "int8":
                    raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
                q = lambda: torch.zeros(shape, dtype=torch.int8, device=dev)  # noqa: E731
                sc = lambda: torch.zeros(shape[:3], dtype=torch.float32, device=dev)  # noqa: E731
                return self.QuantizedFixedCache(q(), sc(), q(), sc(), 0)
            return self.FixedCache(torch.zeros(shape, dtype=key.dtype, device=dev),
                                   torch.zeros(shape, dtype=key.dtype, device=dev), 0)
        type = type or self.Cache
        if type is self.StaticCache:
            k, v = self._proj_kv(key, value if value is not None else key)
            return self.StaticCache(k, v)
        empty = lambda: torch.zeros((b, 0, self.num_heads, self.head_dim), dtype=key.dtype,  # noqa: E731
                                    device=dev)
        return self.Cache(empty(), empty())

    def _attend(self, q, k, v, mask):
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=self.dropout,
                                             training=self.training)
        return self.out_proj(out.reshape(out.shape[0], -1, self.embed_dim))

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._heads(self.q_proj(query))
        s = q.shape[1]
        if isinstance(cache, self.StaticCache):
            return self._attend(q, cache.k, cache.v, attn_mask), cache
        if isinstance(cache, self.FixedCache):
            # attn_mask is not used here: the position mask is the causal structure
            k_new, v_new = self._proj_kv(key, value)
            k = _fixed_cache_write(cache.k, k_new, cache.pos)
            v = _fixed_cache_write(cache.v, v_new, cache.pos)
            mask = _fixed_cache_mask(cache.pos, s, k.shape[1], q.device)
            return self._attend(q, k, v, mask), self.FixedCache(k, v, cache.pos + s)
        if isinstance(cache, self.QuantizedFixedCache):
            k_new, v_new = self._proj_kv(key, value)
            qk, sk = _quant_cache_write(cache.qk, cache.sk, k_new, cache.pos)
            qv, sv = _quant_cache_write(cache.qv, cache.sv, v_new, cache.pos)
            k, v = _quant_cache_read(qk, sk, q.dtype), _quant_cache_read(qv, sv, q.dtype)
            mask = _fixed_cache_mask(cache.pos, s, k.shape[1], q.device)
            return (self._attend(q, k, v, mask),
                    self.QuantizedFixedCache(qk, sk, qv, sv, cache.pos + s))
        k, v = self._proj_kv(key, value)
        if isinstance(cache, self.Cache):
            if cache.k.shape[1] > 0:
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
            cache = self.Cache(k, v)
        out = self._attend(q, k, v, attn_mask)
        return out if cache is None else (out, cache)


def _activation(name):
    return getattr(F, name)


class TransformerEncoderLayer(nn.Module):
    """Self-attention and a feed-forward block, each with a residual and a
    LayerNorm (after, or with ``normalize_before`` before). ``dropout`` on
    both residual branches; ``attn_dropout`` (default: ``dropout``) on the
    attention probabilities; ``act_dropout`` (default: ``dropout``) after
    the activation."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout if attn_dropout is not None else dropout,
            weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None else dropout)
        self.activation = activation

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, attn_mask=src_mask)
        else:
            src, cache = self.self_attn(src, src, src, attn_mask=src_mask, cache=cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout_act(_activation(self.activation)(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (deep copies: equal
    initial weights) and an optional final ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [copy.deepcopy(encoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]

    def forward(self, src, src_mask=None, cache=None):
        out, new_caches = src, []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, src_mask=src_mask)
            else:
                out, c = layer(out, src_mask=src_mask, cache=cache[i])
                new_caches.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention over the encoder's memory and a
    feed-forward block, each with a residual and a LayerNorm; the dropouts
    as in :class:`TransformerEncoderLayer`."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        p_attn = attn_dropout if attn_dropout is not None else dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=p_attn, weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=p_attn,
                                             weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None else dropout)
        self.activation = activation

    def gen_cache(self, memory):
        """``(incremental self-attention Cache, StaticCache of the memory)``."""
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(memory, memory, type=MultiHeadAttention.StaticCache))

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        inc_cache, static_cache = cache if cache is not None else (None, None)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if inc_cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask)
        else:
            tgt, inc_cache = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask, cache=inc_cache)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if static_cache is None:
            tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        else:
            tgt, _ = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask, cache=static_cache)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout_act(_activation(self.activation)(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (inc_cache, static_cache))


class TransformerDecoder(nn.Module):
    """``num_layers`` copies of ``decoder_layer`` and an optional final
    ``norm``."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [copy.deepcopy(decoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def gen_cache(self, memory, do_zip=False):
        """Each layer's ``(incremental, static)`` pair; ``do_zip`` transposes
        them into the two lists."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        out, new_caches = tgt, []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, memory, tgt_mask=tgt_mask, memory_mask=memory_mask)
            else:
                out, c = layer(out, memory, tgt_mask=tgt_mask, memory_mask=memory_mask,
                               cache=cache[i])
                new_caches.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)


class Transformer(nn.Module):
    """``paddle.nn.Transformer``: an encoder and a decoder stack; the
    defaults are Transformer-base (d 512, 8 heads, 6 + 6 layers, FFN 2048,
    dropout 0.1, ReLU). With ``normalize_before`` each stack ends in a
    LayerNorm."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, dropout=0.1, activation="relu", attn_dropout=None,
                 act_dropout=None, normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation, attn_dropout, act_dropout,
                normalize_before, weight_attr, bias_attr)
        self.d_model, self.nhead = d_model, nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                LayerNorm(d_model, device=device) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                LayerNorm(d_model, device=device) if normalize_before else None)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask, memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """The f32 ``[length, length]`` causal mask: 0 on and below the
        diagonal, -1e9 above."""
        visible = torch.ones((length, length), dtype=torch.bool, device=device).tril()
        return torch.where(visible, 0.0, -1e9)


generate_square_subsequent_mask = Transformer.generate_square_subsequent_mask

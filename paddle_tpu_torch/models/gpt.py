"""GPT decoder-only language model of the port (``paddle_tpu/models/gpt.py``).

Two trunks, as in the reference. The default is :class:`GPTBlockStack`: all
L blocks as ``[L, ...]``-stacked parameters with the reference's names and
its ``[in, out]`` weight layout, so a ``paddle_tpu`` state_dict loads by name
with no transposes (:func:`paddle_tpu_torch.utils.convert.state_dict_from_paddle_tpu`).
Its full-sequence forward runs each block's attention through the
``attention_core`` registry kernel (the CUDA flash kernel K1 on the card).
``GPTConfig(stacked=False)`` builds the per-layer trunk of :class:`GPTBlock`
modules instead, which GPT-MoE needs (``GPTConfig(moe=E)``): every
``moe_every``-th block swaps its dense FFN for a
:class:`~paddle_tpu_torch.distributed.moe.MoELayer` (the grouped-FFN CUDA
kernels K4/K4b on the card), its attention goes through ``sdpa``, and
:class:`GPTForPretraining` returns ``(logits, aux)``.

Training differentiates either trunk: attention's gradient runs the CUDA
kernel K2, LayerNorm's is closed-form, the expert FFN's runs K4b, and
:class:`GPTPretrainingCriterion` is the fused softmax cross entropy (plus
the MoE aux loss).

The cache half serves decoding on the stacked trunk: a static
``[L, b, H, S, dh]`` KV cache that is updated IN PLACE (the reference
returns new arrays from ``dynamic_update_slice``; here the writes land in
the caller's tensors and the functions return only what is new). Prefill and
decode attend over the cache in plain PyTorch, as the reference's jnp does.
As in the reference, ``generate()`` and serving need the stacked trunk.

Not ported yet: recompute, dropout in training, the int8 KV packs, chunked
prefill and export; see ``ROADMAP.md``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.moe import MoELayer
from ..framework.device import resolve_device
from ..ops import registry
from ..ops.layer_norm import layer_norm_fused
from ..nn.functional.attention import scaled_dot_product_attention
from ..nn.functional.loss import cross_entropy


class GPTConfig:
    """Hyperparameters with the reference's names. ``use_flash`` is kept for
    parity only: the registry picks the attention kernel.

    GPT-MoE: ``moe=E`` is the one-knob spelling, as in the reference: it
    sets ``moe_num_experts = E`` and the per-layer trunk (``stacked=False``),
    and every ``moe_every``-th block (blocks ``moe_every - 1``,
    ``2*moe_every - 1``, ...) swaps its dense FFN for a top-``moe_top_k``
    GShard MoE layer at capacity factor ``moe_capacity_factor``."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12, num_heads=12,
                 ffn_hidden_size=None, max_seq_len=1024, dropout=0.0, attn_dropout=0.0,
                 initializer_range=0.02, use_flash=True, stacked=True, recompute=False,
                 moe=0, moe_num_experts=0, moe_every=2, moe_top_k=2, moe_capacity_factor=1.25):
        if moe:
            moe_num_experts = moe_num_experts or int(moe)
            stacked = False
        if moe_num_experts and stacked:
            raise ValueError("GPT-MoE needs stacked=False (heterogeneous layers)")
        if moe_num_experts and moe_every < 1:
            raise ValueError(f"moe_every must be >= 1, got {moe_every}")
        if recompute:
            raise NotImplementedError("recompute is not ported yet (ROADMAP.md, Queue 1 item 5)")
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple of num_heads {num_heads}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.initializer_range = initializer_range
        self.use_flash = use_flash
        self.stacked = stacked
        self.recompute = recompute
        self.moe_num_experts = moe_num_experts
        self.moe_every = moe_every
        self.moe_top_k = moe_top_k
        self.moe_capacity_factor = moe_capacity_factor

    def to_dict(self):
        """Constructor kwargs. Unlike the reference's, they include the MoE
        knobs, so ``GPTConfig(**cfg.to_dict())`` rebuilds a GPT-MoE config
        (ROADMAP.md, Queue 3)."""
        return dict(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            ffn_hidden_size=self.ffn_hidden_size, max_seq_len=self.max_seq_len,
            dropout=self.dropout, attn_dropout=self.attn_dropout,
            initializer_range=self.initializer_range, use_flash=self.use_flash,
            stacked=self.stacked, recompute=self.recompute,
            moe_num_experts=self.moe_num_experts, moe_every=self.moe_every,
            moe_top_k=self.moe_top_k, moe_capacity_factor=self.moe_capacity_factor,
        )

    @staticmethod
    def gpt3_1p3b(**kw):
        cfg = dict(vocab_size=50304, hidden_size=2048, num_layers=24, num_heads=16, max_seq_len=2048)
        cfg.update(kw)
        return GPTConfig(**cfg)

    @staticmethod
    def tiny(**kw):
        cfg = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=128)
        cfg.update(kw)
        return GPTConfig(**cfg)


def _normal(shape, std, generator, device):
    return torch.empty(shape, device=device).normal_(0.0, std, generator=generator)


class GPTEmbeddings(nn.Module):
    def __init__(self, cfg: GPTConfig, device, generator):
        super().__init__()
        # the single-device case of the reference's VocabParallelEmbedding
        self.word_embeddings = nn.Embedding.from_pretrained(
            _normal((cfg.vocab_size, cfg.hidden_size), 0.02, generator, device), freeze=False)
        self.position_embeddings = nn.Embedding.from_pretrained(
            _normal((cfg.max_seq_len, cfg.hidden_size), cfg.initializer_range, generator, device),
            freeze=False)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.word_embeddings(input_ids) + self.position_embeddings(position_ids)


def _attn_core_packed(qkv, attn_dropout=0.0, generator=None):
    """Causal self-attention over the packed ``[b, s, 3, h, d]`` projection
    through the ``attention_core`` registry kernel."""
    return registry.dispatch("attention_core", qkv, attn_dropout, generator)


def _block_apply(lp, h, *, num_heads, attn_dropout=0.0, generator=None, epsilon=1e-5):
    """One pre-LN decoder block; ``lp`` holds the 12 parameter slices of one
    layer in ``GPTBlockStack._order``."""
    n1w, n1b, qkvw, qkvb, ow, ob, n2w, n2b, f1w, f1b, f2w, f2b = lp
    b, s, d = h.shape
    x1 = layer_norm_fused(h, n1w, n1b, epsilon)
    qkv = (x1 @ qkvw + qkvb).reshape(b, s, 3, num_heads, d // num_heads)
    att = _attn_core_packed(qkv, attn_dropout, generator).reshape(b, s, d)
    h = h + att @ ow + ob
    x2 = layer_norm_fused(h, n2w, n2b, epsilon)
    y = F.gelu(x2 @ f1w + f1b, approximate="tanh")
    return h + y @ f2w + f2b


def _stack_forward(x, params, *, num_heads, attn_dropout=0.0, generator=None):
    """Whole-trunk forward: the layer loop of the reference at pp = 1, no
    recompute. The stacked parameters are unbound once, so their gradient is
    one ``stack`` of the per-layer gradients, not L zero-filled ``[L, ...]``
    buffers added up."""
    h = x
    for lp in zip(*(p.unbind(0) for p in params)):
        h = _block_apply(lp, h, num_heads=num_heads, attn_dropout=attn_dropout,
                         generator=generator)
    return h


class GPTBlockStack(nn.Module):
    """All decoder blocks as ``[L, ...]``-stacked parameters, named and laid
    out (``[in, out]``) as in the reference."""

    _order = ["norm1_w", "norm1_b", "qkv_w", "qkv_b", "out_w", "out_b",
              "norm2_w", "norm2_b", "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b"]

    def __init__(self, cfg: GPTConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        L, D, Ff = cfg.num_layers, cfg.hidden_size, cfg.ffn_hidden_size
        std = cfg.initializer_range
        shapes = {
            "norm1_w": (L, D), "norm1_b": (L, D), "qkv_w": (L, D, 3 * D), "qkv_b": (L, 3 * D),
            "out_w": (L, D, D), "out_b": (L, D), "norm2_w": (L, D), "norm2_b": (L, D),
            "ffn1_w": (L, D, Ff), "ffn1_b": (L, Ff), "ffn2_w": (L, Ff, D), "ffn2_b": (L, D),
        }
        for name in self._order:
            shape = shapes[name]
            if name.startswith("norm") and name.endswith("_w"):
                value = torch.ones(shape, device=device)
            elif name.endswith("_b"):
                value = torch.zeros(shape, device=device)
            else:
                value = _normal(shape, std, generator, device)
            self.register_parameter(name, nn.Parameter(value))

    def forward(self, x):
        cfg = self.cfg
        _no_training_dropout(self, cfg)
        return _stack_forward(x, [getattr(self, n) for n in self._order], num_heads=cfg.num_heads)


def _no_training_dropout(module, cfg):
    if module.training and (cfg.dropout > 0.0 or cfg.attn_dropout > 0.0):
        raise NotImplementedError(
            "dropout in training is not ported yet (ROADMAP.md, Queue 1 item 5): "
            "set dropout and attn_dropout to 0, or call eval()")


class _Linear(nn.Module):
    """``x @ weight + bias`` with the reference's ``[in, out]`` weight (the
    single-device case of its Column/RowParallelLinear)."""

    def __init__(self, d_in, d_out, std, device, generator):
        super().__init__()
        self.weight = nn.Parameter(_normal((d_in, d_out), std, generator, device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x):
        return x @ self.weight + self.bias


class GPTAttention(nn.Module):
    """Causal self-attention of the per-layer trunk: the qkv projection, the
    ``sdpa`` registry kernel (K1 forward and K2 backward on the card, over
    strided views of the projection) and the output projection. The
    reference's cache branches serve its decoder, which needs the stacked
    trunk; they are not carried."""

    def __init__(self, cfg: GPTConfig, device, generator):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        std = cfg.initializer_range
        self.qkv_proj = _Linear(cfg.hidden_size, 3 * cfg.hidden_size, std, device, generator)
        self.out_proj = _Linear(cfg.hidden_size, cfg.hidden_size, std, device, generator)
        self.attn_dropout = cfg.attn_dropout

    def forward(self, x):
        b, s, d = x.shape
        q, k, v = self.qkv_proj(x).reshape(b, s, 3, self.num_heads, self.head_dim).unbind(2)
        out = scaled_dot_product_attention(q, k, v, is_causal=True, dropout_p=self.attn_dropout,
                                           training=self.training)
        return self.out_proj(out.reshape(b, s, d))


class GPTBlock(nn.Module):
    """Pre-LN decoder block of the per-layer trunk: attention, then the
    dense GELU FFN or, with ``use_moe``, a GShard :class:`MoELayer` whose
    routing generator is seeded ``seed``."""

    def __init__(self, cfg: GPTConfig, device, generator, use_moe=False, seed=0):
        super().__init__()
        std = cfg.initializer_range
        D, Ff = cfg.hidden_size, cfg.ffn_hidden_size
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(D, device=device)
        self.attn = GPTAttention(cfg, device, generator)
        self.norm2 = nn.LayerNorm(D, device=device)
        self.moe = None
        if use_moe:
            self.moe = MoELayer(D, Ff, num_experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
                                capacity_factor=cfg.moe_capacity_factor, device=device,
                                generator=generator, seed=seed)
        else:
            self.ffn1 = _Linear(D, Ff, std, device, generator)
            self.ffn2 = _Linear(Ff, D, std, device, generator)

    def forward(self, x):
        _no_training_dropout(self, self.cfg)
        n1, n2 = self.norm1, self.norm2
        x = x + self.attn(layer_norm_fused(x, n1.weight, n1.bias, n1.eps))
        x2 = layer_norm_fused(x, n2.weight, n2.bias, n2.eps)
        if self.moe is not None:
            return x + self.moe(x2)
        return x + self.ffn2(F.gelu(self.ffn1(x2), approximate="tanh"))


class GPTModel(nn.Module):
    """Embedding + N decoder blocks + final LN -> hidden states. The blocks
    are a :class:`GPTBlockStack` (``cfg.stacked``) or a ``ModuleList`` of
    :class:`GPTBlock`; the MoE blocks' routing generators are seeded
    ``seed + 1 + layer``."""

    def __init__(self, cfg: GPTConfig, device, generator, seed=0):
        super().__init__()
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg, device, generator)
        if cfg.stacked:
            self.layers = GPTBlockStack(cfg, device, generator)
        else:
            self.layers = nn.ModuleList([
                GPTBlock(cfg, device, generator,
                         use_moe=bool(cfg.moe_num_experts) and (i + 1) % cfg.moe_every == 0,
                         seed=seed + 1 + i)
                for i in range(cfg.num_layers)])
        self.final_norm = nn.LayerNorm(cfg.hidden_size, device=device)

    def forward(self, input_ids, position_ids=None):
        h = self.embeddings(input_ids, position_ids)
        if isinstance(self.layers, GPTBlockStack):
            h = self.layers(h)
        else:
            for blk in self.layers:
                h = blk(h)
        return layer_norm_fused(h, self.final_norm.weight, self.final_norm.bias, self.final_norm.eps)

    @property
    def moe_aux_loss(self):
        """Sum of the MoE gates' load-balancing losses from the last forward
        (None without MoE blocks)."""
        total = None
        if not isinstance(self.layers, GPTBlockStack):
            for blk in self.layers:
                if blk.moe is not None:
                    total = blk.moe.aux_loss if total is None else total + blk.moe.aux_loss
        return total


class GPTForPretraining(nn.Module):
    """GPT with the LM head tied to the word embedding. Runs on ``cuda``
    unless ``device`` says otherwise (no CUDA and no device raises); the
    random weights are drawn from a ``torch.Generator`` seeded ``seed``."""

    def __init__(self, cfg: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(int(seed))
        self.gpt = GPTModel(cfg, device, generator, seed=int(seed))

    def forward(self, input_ids, position_ids=None):
        """Logits ``[b, s, V]``; for GPT-MoE ``(logits, aux)``, the gates'
        summed balancing loss riding the outputs as in the reference."""
        h = self.gpt(input_ids, position_ids)
        logits = h @ self.gpt.embeddings.word_embeddings.weight.T
        if self.gpt.cfg.moe_num_experts:
            return logits, self.gpt.moe_aux_loss
        return logits

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False, temperature=1.0, top_k=0,
                 top_p=1.0, seed=0, eos_token_id=None):
        """Autoregressive decoding over a static KV cache of
        ``s0 + max_new_tokens`` rows: one prefill, then one token per step
        (the reference's ``lax.scan`` as a loop). Greedy by default;
        ``do_sample`` samples with temperature / top-k / top-p, drawing the
        token after position p from a generator seeded by ``(seed, p)``.
        Returns ``[b, s0 + max_new_tokens]`` token ids (int64)."""
        cfg = self.gpt.cfg
        params, wte, wpe, fnw, fnb = self._decode_params()
        device = wte.device
        ids = torch.as_tensor(input_ids, device=device).long()
        if ids.ndim == 1:
            ids = ids[None]
        b, s0 = ids.shape
        if s0 + max_new_tokens > cfg.max_seq_len:
            raise ValueError(f"prompt {s0} + max_new_tokens {max_new_tokens} exceeds "
                             f"max_seq_len {cfg.max_seq_len}")
        H, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        shape = (cfg.num_layers, b, H, s0 + max_new_tokens, dh)
        cache_k = _kv_zeros(shape, wte.dtype, device)
        cache_v = _kv_zeros(shape, wte.dtype, device)
        sample = (do_sample, temperature, top_k, top_p)

        def pick(logits, position):
            gen = _position_generator(seed, position, device) if do_sample else None
            return _select_token(logits.float(), gen, *sample)

        logits = _cache_forward(params, wte, wpe, fnw, fnb, ids, cache_k, cache_v, 0, num_heads=H)
        tok = pick(logits[:, -1], s0 - 1)
        done = torch.zeros(b, dtype=torch.bool, device=device) if eos_token_id is None \
            else tok == eos_token_id
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits = _cache_forward(params, wte, wpe, fnw, fnb, tok[:, None], cache_k, cache_v,
                                    s0 + i, num_heads=H)
            nxt = pick(logits[:, -1], s0 + i)
            if eos_token_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
                done = done | (nxt == eos_token_id)
            tok = nxt
            out.append(tok)
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)

    def _decode_params(self):
        """The decode-path parameter pack ``(stack, wte, wpe, fnw, fnb)``,
        ``stack`` in ``GPTBlockStack._order``; detached views of the
        parameters. Decoding needs the stacked trunk, as in the reference."""
        g = self.gpt
        if not isinstance(g.layers, GPTBlockStack):
            raise NotImplementedError(
                "generate() requires the stacked trunk (GPTConfig(stacked=True))")
        stack = tuple(getattr(g.layers, n).detach() for n in g.layers._order)
        return (stack, g.embeddings.word_embeddings.weight.detach(),
                g.embeddings.position_embeddings.weight.detach(),
                g.final_norm.weight.detach(), g.final_norm.bias.detach())


class GPTPretrainingCriterion(nn.Module):
    """Next-token cross entropy: per-token CE with ``ignore_index=-100`` (the
    single-device ``ParallelCrossEntropy``), then the mean over tokens, or
    the mean under ``loss_mask``. For GPT-MoE outputs ``(logits, aux)`` the
    GShard balancing loss is added with weight ``moe_aux_coef``."""

    def __init__(self, moe_aux_coef=0.01):
        super().__init__()
        self.moe_aux_coef = moe_aux_coef

    def forward(self, logits, labels, loss_mask=None):
        aux = None
        if isinstance(logits, (tuple, list)):
            logits, aux = logits
        per_tok = cross_entropy(logits, labels, reduction="none", ignore_index=-100)
        if loss_mask is not None:
            m = loss_mask.reshape(per_tok.shape).to(per_tok.dtype)
            loss = (per_tok * m).sum() / m.sum()
        else:
            loss = per_tok.mean()
        return loss if aux is None else loss + aux * self.moe_aux_coef


# ------------------------------------------------------------------ KV cache
# A cache is a plain tensor in the compute dtype. These helpers are the one
# place that knows its representation (the reference's int8 packs plug in
# here when they are ported).

def _kv_zeros(shape, dt, device):
    """A fresh cache buffer ``[..., S, dh]``."""
    return torch.zeros(shape, dtype=dt, device=device)


def _kvc_update(c, u, idx):
    """Write the compute-dtype update ``u`` into cache ``c`` in place at the
    start indices ``idx`` (one per dim)."""
    c[tuple(slice(i, i + n) for i, n in zip(idx, u.shape))] = u


def _kvc_read(c, dt):
    """Attend view of a cache in dtype ``dt``."""
    return c.to(dt)


def _kvc_copy(c, seg, idx):
    """Copy an already-stored segment (same representation as ``c``) into the
    cache in place at ``idx``."""
    c[tuple(slice(i, i + n) for i, n in zip(idx, seg.shape))] = seg


def _ln(v, w, b, epsilon=1e-5):
    mean = v.mean(dim=-1, keepdim=True)
    var = v.var(dim=-1, unbiased=False, keepdim=True)
    return (v - mean) / torch.sqrt(var + epsilon) * w + b


def _attend(q, rk, rv, visible, out_dtype):
    """Scores in f32 over the whole cache, masked to ``visible`` (broadcast
    over heads), softmax, and the weighted sum: ``[b, H, W, dh]``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = (q * scale).float() @ rk.float().transpose(-1, -2)
    scores = scores.masked_fill(~visible, float("-inf"))
    p = torch.softmax(scores, dim=-1).to(rv.dtype)
    return (p.float() @ rv.float()).to(out_dtype)


def _cache_block(lp, h, ck, cv, start_pos, *, num_heads, epsilon=1e-5):
    """One decoder block over a fixed-size cache. ``h`` [b, s, d]; ``ck``/
    ``cv`` [b, H, S, dh] hold keys/values of positions < ``start_pos`` and are
    written in place at [start_pos, start_pos + s); row j attends cache
    positions <= start_pos + j. Returns the new ``h``."""
    n1w, n1b, qkvw, qkvb, ow, ob, n2w, n2b, f1w, f1b, f2w, f2b = lp
    b, s, d = h.shape
    S = ck.shape[2]
    x1 = _ln(h, n1w, n1b, epsilon)
    qkv = (x1 @ qkvw + qkvb).reshape(b, s, 3, num_heads, d // num_heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [b, H, s, dh]
    _kvc_update(ck, k, (0, 0, start_pos, 0))
    _kvc_update(cv, v, (0, 0, start_pos, 0))
    q_pos = start_pos + torch.arange(s, device=h.device)[:, None]
    visible = torch.arange(S, device=h.device)[None] <= q_pos  # [s, S]
    att = _attend(q, _kvc_read(ck, h.dtype), _kvc_read(cv, h.dtype), visible, h.dtype)
    h = h + att.transpose(1, 2).reshape(b, s, d) @ ow + ob
    y = F.gelu(_ln(h, n2w, n2b, epsilon) @ f1w + f1b, approximate="tanh")
    return h + y @ f2w + f2b


def _logits(h, wte, fnw, fnb):
    return _ln(h, fnw, fnb) @ wte.T


def _cache_forward(params, wte, wpe, fnw, fnb, ids, cache_k, cache_v, start_pos, *, num_heads):
    """Trunk forward over a fixed cache: ``ids`` [b, s] at positions from
    ``start_pos``; ``cache_k``/``cache_v`` [L, b, H, S, dh] are written in
    place. Returns logits [b, s, V]."""
    s = ids.shape[1]
    pos = torch.arange(start_pos, start_pos + s, device=ids.device)
    h = (wte[ids] + wpe[pos][None]).to(wte.dtype)
    for i in range(params[0].shape[0]):
        h = _cache_block(tuple(p[i] for p in params), h, cache_k[i], cache_v[i], start_pos,
                         num_heads=num_heads)
    return _logits(h, wte, fnw, fnb)


def _slot_cache_block(lp, h, ck, cv, pos, *, num_heads, epsilon=1e-5, active=None):
    """One decoder block over PER-SLOT cache positions (continuous-batching
    decode). ``h`` [b, W, d] holds a W-token window per slot; ``pos`` [b]
    (int64) is each slot's write index for window row 0. The window's K/V
    are written in place at ``pos[b]`` before attending, and row j attends
    keys up to ``pos[b] + j``. ``active`` [b] bool gates the write per slot:
    an inactive slot's cache stays untouched. Same per-row math as
    :func:`_cache_block` at s = 1."""
    n1w, n1b, qkvw, qkvb, ow, ob, n2w, n2b, f1w, f1b, f2w, f2b = lp
    b, W, d = h.shape
    S = ck.shape[2]
    x1 = _ln(h, n1w, n1b, epsilon)
    qkv = (x1 @ qkvw + qkvb).reshape(b, W, 3, num_heads, d // num_heads)
    q = qkv[:, :, 0].transpose(1, 2)  # [b, H, W, dh]
    rows = pos[:, None] + torch.arange(W, device=h.device)  # [b, W]
    slots = torch.arange(b, device=h.device)[:, None]
    for c, new in ((ck, qkv[:, :, 1]), (cv, qkv[:, :, 2])):  # new: [b, W, H, dh]
        if active is not None:
            new = torch.where(active[:, None, None, None], new, c[slots, :, rows])
        c[slots, :, rows] = new
    visible = torch.arange(S, device=h.device) <= rows[:, :, None]  # [b, W, S]
    att = _attend(q, _kvc_read(ck, h.dtype), _kvc_read(cv, h.dtype), visible[:, None], h.dtype)
    h = h + att.transpose(1, 2).reshape(b, W, d) @ ow + ob
    y = F.gelu(_ln(h, n2w, n2b, epsilon) @ f1w + f1b, approximate="tanh")
    return h + y @ f2w + f2b


def _slot_window_forward(params, wte, wpe, fnw, fnb, toks, cache_k, cache_v, pos, *, num_heads,
                         active=None):
    """W-token trunk forward with per-slot start positions: row j of ``toks``
    [b, W] runs at position ``pos[b] + j`` against the engine's cache
    (written in place). Returns logits [b, W, V]."""
    W = toks.shape[1]
    rows = pos[:, None] + torch.arange(W, device=toks.device)
    # a window near the sequence limit can index past the positional table;
    # clamp (those rows are never emitted)
    rows = rows.clamp(max=wpe.shape[0] - 1)
    h = (wte[toks] + wpe[rows]).to(wte.dtype)
    for i in range(params[0].shape[0]):
        h = _slot_cache_block(tuple(p[i] for p in params), h, cache_k[i], cache_v[i], pos,
                              num_heads=num_heads, active=active)
    return _logits(h, wte, fnw, fnb)


def _slot_decode_forward(params, wte, wpe, fnw, fnb, tok, cache_k, cache_v, pos, *, num_heads,
                         active=None):
    """One-token trunk forward with per-slot positions: the serving engine's
    decode step. ``tok`` [b], ``pos`` [b], ``active`` [b] bool. Returns
    logits [b, V]; the W = 1 case of :func:`_slot_window_forward`."""
    return _slot_window_forward(params, wte, wpe, fnw, fnb, tok[:, None], cache_k, cache_v, pos,
                                num_heads=num_heads, active=active)[:, 0]


# ------------------------------------------------------------ token choice

def _position_generator(seed, position, device):
    """The generator that draws the token following ``position`` of a
    request seeded ``seed``: a request's samples depend only on its own
    (seed, position), never on its slot or its batch neighbours."""
    mixed = ((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF)
    return torch.Generator(device=device).manual_seed(mixed)


def _filtered_logits(logits, temperature, top_k, top_p):
    """Temperature / top-k / top-p filtered f32 logits over [b, V]."""
    logits = logits.float() / max(float(temperature), 1e-6)
    if top_k and top_k > 0:
        k_eff = min(int(top_k), logits.shape[-1])  # top_k > vocab keeps all
        kth = logits.topk(k_eff, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sl = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(sl, dim=-1)
        keep = probs.cumsum(dim=-1) - probs < top_p  # always keeps the top-1
        threshold = torch.where(keep, sl, torch.full_like(sl, float("inf"))).min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    return logits


def _select_token(logits, generator, do_sample, temperature, top_k, top_p):
    """Greedy or temperature / top-k / top-p sampling over [b, V] logits
    (one generator for all rows)."""
    if not do_sample:
        return logits.argmax(dim=-1)
    probs = torch.softmax(_filtered_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _select_token_rows(logits, generators, do_sample, temperature, top_k, top_p):
    """Per-row :func:`_select_token`: ``generators`` holds one generator per
    row (``None`` for a row whose token is not used)."""
    if not do_sample:
        return logits.argmax(dim=-1)
    out = logits.argmax(dim=-1)
    for i, gen in enumerate(generators):
        if gen is not None:
            out[i] = _select_token(logits[i:i + 1], gen, True, temperature, top_k, top_p)[0]
    return out

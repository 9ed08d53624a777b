"""BERT encoder family of the port (``paddle_tpu/models/bert.py``): the
post-LN bidirectional encoder, its MLM + NSP pretraining heads and
criterion, with the reference's parameter names and ``[in, out]`` weight
layout, so a ``paddle_tpu`` state_dict loads by name
(:func:`paddle_tpu_torch.utils.convert.state_dict_from_paddle_tpu`).

Attention goes through the ``sdpa`` registry kernel over strided views of
the ``[b, s, 3, h, d]`` qkv projection (no copy). With an additive or bool
padding mask ``[b|1, 1, s, s]`` and ``FLAGS_flash_flat`` on, that is the
``flash_flat_gqa`` impl (the CUDA kernels K3 forward and K3b backward on
the card), as in the reference; without a mask it is ``flash`` (K1/K2).

Initialisation follows what the reference does, not what its source
suggests: its ``weight_attr=I.Normal(0, initializer_range)`` arguments are
ignored by ``create_parameter`` (an initializer object has no
``.initializer``), so the projections are XavierNormal and the position
and token-type tables Normal(0, 1); the word table is Normal(0, 0.02)
(ROADMAP.md, Queue 3). So ``BertConfig`` takes no ``initializer_range``:
no weight of the reference depends on its value. Dropout in training is
not ported (ROADMAP.md, Queue 1 item 5): a training forward with
``dropout > 0`` raises.
"""
from __future__ import annotations

import torch
from torch import nn

from ..distributed.mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                                     RowParallelLinear, VocabParallelEmbedding)
from ..framework.device import resolve_device
from ..nn.functional.activation import gelu
from ..nn.functional.attention import scaled_dot_product_attention
from ..nn.functional.loss import cross_entropy
from ..nn.layer import Embedding, LayerNorm, Linear


class BertConfig:
    """Hyperparameters with the reference's names; ``BertConfig()`` is
    BERT-base (vocab 30522, h 768, 12 layers, 12 heads, FFN 3072, max_seq
    512)."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12,
                 ffn_hidden_size=None, max_seq_len=512, type_vocab_size=2, dropout=0.0):
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple of num_heads {num_heads}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout

    # classmethods so subclasses (the reference's ErnieConfig) inherit the family shapes
    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def large(cls, **kw):
        cfg = dict(hidden_size=1024, num_layers=24, num_heads=16)
        cfg.update(kw)
        return cls(**cfg)

    @classmethod
    def tiny(cls, **kw):
        cfg = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=128)
        cfg.update(kw)
        return cls(**cfg)


def _no_training_dropout(module, cfg):
    if module.training and cfg.dropout > 0.0:
        raise NotImplementedError(
            "dropout in training is not ported yet (ROADMAP.md, Queue 1 item 5): set dropout "
            "to 0, or call eval()")


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device, generator):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        H = cfg.hidden_size
        self.qkv_proj = ColumnParallelLinear(H, 3 * H, device=device, generator=generator)
        self.out_proj = RowParallelLinear(H, H, device=device, generator=generator)

    def forward(self, x, attn_mask=None):
        b, s = x.shape[0], x.shape[1]
        # strided views of the projection: the kernels take them as they are
        q, k, v = self.qkv_proj(x).reshape(b, s, 3, self.num_heads, self.head_dim).unbind(2)
        out = scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, training=self.training)
        return self.out_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class BertLayer(nn.Module):
    """Post-LN encoder block (original BERT ordering)."""

    def __init__(self, cfg: BertConfig, device, generator):
        super().__init__()
        H, Ff = cfg.hidden_size, cfg.ffn_hidden_size
        self.cfg = cfg
        self.attn = BertSelfAttention(cfg, device, generator)
        self.norm1 = LayerNorm(H, device=device)
        self.ffn1 = ColumnParallelLinear(H, Ff, device=device, generator=generator)
        self.ffn2 = RowParallelLinear(Ff, H, device=device, generator=generator)
        self.norm2 = LayerNorm(H, device=device)

    def forward(self, x, attn_mask=None):
        _no_training_dropout(self, self.cfg)
        x = self.norm1(x + self.attn(x, attn_mask))
        return self.norm2(x + self.ffn2(gelu(self.ffn1(x), approximate=True)))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device, generator):
        super().__init__()
        H = cfg.hidden_size
        self.word_embeddings = VocabParallelEmbedding(cfg.vocab_size, H, device=device,
                                                      generator=generator)
        self.position_embeddings = Embedding(cfg.max_seq_len, H, device=device, generator=generator)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, H, device=device,
                                               generator=generator)
        self.norm = LayerNorm(H, device=device)

    def embed(self, input_ids, token_type_ids=None, position_ids=None):
        """The sum of the word, position and token-type embeddings, before
        the LayerNorm (a subclass adds its own tables to it)."""
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        return (self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
                + self.token_type_embeddings(token_type_ids))

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        return self.norm(self.embed(input_ids, token_type_ids, position_ids))


class BertModel(nn.Module):
    """Embeddings + N encoder blocks -> ``(hidden [b, s, H], pooled [b, H])``."""

    def __init__(self, cfg: BertConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, device, generator)
        self.layers = nn.ModuleList([BertLayer(cfg, device, generator)
                                     for _ in range(cfg.num_layers)])
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, device=device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attn_mask=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.layers:
            h = layer(h, attn_mask)
        return h, torch.tanh(self.pooler(h[:, 0]))


class BertForPretraining(nn.Module):
    """MLM head (tied to the word embedding) + NSP head. Runs on ``cuda``
    unless ``device`` says otherwise (no CUDA and no device raises); the
    random weights are drawn from a ``torch.Generator`` seeded ``seed``.
    ``attn_mask`` is the reference's: additive (0 / -1e30) or bool
    ``[b|1, 1, s, s]``, broadcast over heads."""

    def __init__(self, cfg: BertConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(int(seed))
        H = cfg.hidden_size
        self.bert = BertModel(cfg, device, generator)
        self.transform = Linear(H, H, device=device, generator=generator)
        self.transform_norm = LayerNorm(H, device=device)
        self.nsp = Linear(H, 2, device=device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attn_mask=None):
        """``(mlm_logits [b, s, V], nsp_logits [b, 2])``."""
        h, pooled = self.bert(input_ids, token_type_ids, position_ids, attn_mask)
        h = self.transform_norm(gelu(self.transform(h), approximate=True))
        mlm_logits = h @ self.bert.embeddings.word_embeddings.weight.T
        return mlm_logits, self.nsp(pooled)


class BertPretrainingCriterion(nn.Module):
    """Masked-LM cross entropy averaged over the labelled tokens
    (``ignore_index=-100`` marks the rest) plus, given ``nsp_labels``, the
    mean NSP cross entropy. The loss is f32."""

    def __init__(self):
        super().__init__()
        self.mlm_ce = ParallelCrossEntropy(ignore_index=-100)

    def forward(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels=None):
        per_tok = self.mlm_ce(mlm_logits, mlm_labels)
        mask = (mlm_labels != -100).to(torch.float32).reshape(per_tok.shape)
        loss = (per_tok * mask).sum() / (mask.sum() + 1e-6)
        if nsp_labels is not None:
            loss = loss + cross_entropy(nsp_logits, nsp_labels, reduction="none").mean()
        return loss

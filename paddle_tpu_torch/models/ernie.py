"""ERNIE 3.0 pre-training of the port (``paddle_tpu/models/ernie.py``): the
BERT encoder of :mod:`paddle_tpu_torch.models.bert` with an extra task-type
embedding table, a masked-LM head tied to the word table and a
sentence-order-prediction (SOP) head. Parameter names and the ``[in, out]``
weight layout are the reference's (``ernie.embeddings.*``,
``ernie.layers.N.*``, ``ernie.pooler.*``, ``transform.*``,
``transform_norm.*``, ``sop.*``), so a ``paddle_tpu`` state_dict loads by
name (:func:`paddle_tpu_torch.utils.convert.state_dict_from_paddle_tpu`).

Without an attention mask, attention goes through the ``sdpa`` kernel's
``flash`` impl: K1 forward and K2 backward on the card.

Initialisation follows what the reference does: its task-type table's
``weight_attr=I.Normal(0, initializer_range)`` is ignored as BERT's are
(ROADMAP.md, Queue 3), so the table is drawn Normal(0, 1) like the other
``Embedding`` tables, and ``ErnieConfig``, like ``BertConfig``, takes no
``initializer_range``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..framework.device import resolve_device
from ..nn.functional.activation import gelu
from ..nn.layer import Embedding, LayerNorm, Linear
from .bert import BertConfig, BertEmbeddings, BertLayer, BertPretrainingCriterion


class ErnieConfig(BertConfig):
    """``BertConfig`` with the vocab of ERNIE 1.0 (18000) by default, the
    task-type table's size and whether it is used."""

    def __init__(self, task_type_vocab_size=3, use_task_id=True, **kw):
        kw.setdefault("vocab_size", 18000)
        super().__init__(**kw)
        self.task_type_vocab_size = task_type_vocab_size
        self.use_task_id = use_task_id

    @classmethod
    def ernie3_xbase(cls, **kw):
        """ERNIE 3.0's hybrid-benchmark shape (BASELINE config #5's dense
        trunk): h 3072, 12 layers, 24 heads, FFN 12288, max_seq 512."""
        cfg = dict(hidden_size=3072, num_layers=12, num_heads=24, max_seq_len=512)
        cfg.update(kw)
        return cls(**cfg)


class ErnieEmbeddings(BertEmbeddings):
    """BERT's embeddings plus the task-type table."""

    def __init__(self, cfg: ErnieConfig, device, generator):
        super().__init__(cfg, device, generator)
        self.task_type_embeddings = None
        if cfg.use_task_id:
            self.task_type_embeddings = Embedding(cfg.task_type_vocab_size, cfg.hidden_size,
                                                  device=device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, task_type_ids=None):
        h = self.embed(input_ids, token_type_ids, position_ids)
        if self.task_type_embeddings is not None:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            h = h + self.task_type_embeddings(task_type_ids)
        return self.norm(h)


class ErnieModel(nn.Module):
    """Embeddings + N post-LN encoder blocks -> ``(hidden [b, s, H],
    pooled [b, H])``, the pooler a tanh over the first token."""

    def __init__(self, cfg: ErnieConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        self.embeddings = ErnieEmbeddings(cfg, device, generator)
        self.layers = nn.ModuleList([BertLayer(cfg, device, generator)
                                     for _ in range(cfg.num_layers)])
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, device=device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attn_mask=None,
                task_type_ids=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids, task_type_ids)
        for layer in self.layers:
            h = layer(h, attn_mask)
        return h, torch.tanh(self.pooler(h[:, 0]))


class ErnieForPretraining(nn.Module):
    """Masked-LM head (GELU(tanh) transform, LayerNorm, decoder tied to the
    word table) + SOP head. Runs on ``cuda`` unless ``device`` says
    otherwise (no CUDA and no device raises); the random weights are drawn
    from a ``torch.Generator`` seeded ``seed``."""

    def __init__(self, cfg: ErnieConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(int(seed))
        H = cfg.hidden_size
        self.ernie = ErnieModel(cfg, device, generator)
        self.transform = Linear(H, H, device=device, generator=generator)
        self.transform_norm = LayerNorm(H, device=device)
        self.sop = Linear(H, 2, device=device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attn_mask=None,
                task_type_ids=None):
        """``(mlm_logits [b, s, V], sop_logits [b, 2])``."""
        h, pooled = self.ernie(input_ids, token_type_ids, position_ids, attn_mask, task_type_ids)
        h = self.transform_norm(gelu(self.transform(h), approximate=True))
        mlm_logits = h @ self.ernie.embeddings.word_embeddings.weight.T
        return mlm_logits, self.sop(pooled)


class ErniePretrainingCriterion(BertPretrainingCriterion):
    """Masked-LM cross entropy plus the mean SOP cross entropy: BERT's
    criterion, with the SOP labels in place of NSP's."""

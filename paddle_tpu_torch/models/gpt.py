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
the MoE aux loss). ``GPTConfig(recompute=True)`` recomputes each block's
activations in the backward (:mod:`paddle_tpu_torch.distributed.recompute`)
on either trunk: ``recompute_granularity="full"`` saves nothing inside a
block, ``"selective"`` saves its matmul outputs, as the reference's
``nothing_saveable`` and ``dots_saveable`` policies do.

The cache half serves decoding on the stacked trunk: a static
``[L, b, H, S, dh]`` KV cache (or its int8 pack) that is updated IN PLACE
(the reference returns new arrays from ``dynamic_update_slice``; here the
writes land in the caller's tensors and the functions return only what is
new): bucketed and chunked prefill, per-slot decode windows of W tokens.
They attend over the cache in plain PyTorch, as the reference's jnp does.
As in the reference, ``generate()`` and serving need the stacked trunk.

Under a fleet grid the stacked trunk runs as the reference's sharded
GPT does under GSPMD (``paddle_tpu/models/gpt.py:393-412``): at model
parallelism mp > 1 each rank holds ``num_heads / mp`` heads (its
``qkv_w``/``qkv_b`` columns hold the q, k and v of those heads: each of the
three blocks split on its own), ``out_w`` and ``ffn2_w`` split on their
input dim and ``ffn1_w``/``ffn1_b`` on their output (Megatron's column and
row layers, with the copy and reduce regions), the word table split over
the vocabulary (``VocabParallelEmbedding``) and the tied head giving
vocab-sharded logits for ``ParallelCrossEntropy``. At pipeline degree
pp > 1 each stage holds the ``L / pp`` layers of its segment of the
``[L, ...]`` stack; the first stage also the embeddings, the last the
final LayerNorm and a copy of the tied word table, whose gradient the two
sum (:meth:`GPTForPretraining.allreduce_shared_weight_gradients`). A
stage's forward takes the ids on the first stage and the activation
received on the others, and gives the logits on the last stage and the
activation to send on the others; ``TrainStep`` runs the schedule. A
model built from a seed holds exactly its part of the one-rank model
(every rank draws every weight and keeps its part; ``device="meta"``
draws nothing, for a model whose weights are loaded after
``to_empty``). At a sequence degree sep > 1 (the stacked trunk, pp = 1)
each ``sep`` rank holds a block of the sequence: the position embeddings
read its global positions, each block exchanges its packed qkv by
Ulysses (:func:`~paddle_tpu_torch.distributed.ring_attention.seq_to_heads`)
so attention (K1/K2 on the card) runs over the whole sequence on
``num_heads / sep`` heads, and exchanges the output back before the output
projection; the criterion's mean is over the global tokens. GPT-MoE (the
per-layer trunk) runs at dp > 1 with its experts sharded over ``dp``
(:mod:`paddle_tpu_torch.distributed.moe`). ``generate()`` decodes at
mp > 1 (each rank its heads, its cache and its vocabulary shard); the
serving engine and the per-layer trunk need mp = pp = sep = 1.

Not ported yet: dropout in training and export; see ``ROADMAP.md``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import collective as C
from ..distributed.moe import MoELayer
from ..distributed.recompute import recompute as _recompute
from ..distributed.ring_attention import heads_to_seq, seq_to_heads
from ..distributed.mp_layers import (ParallelCrossEntropy, VocabParallelEmbedding, _mark,
                                     _mp_group, _shard, copy_to_model_parallel,
                                     reduce_from_model_parallel)
from ..distributed.sharding import gather_param, regather_on_backward
from ..framework.device import resolve_device
from ..ops import registry
from ..ops.layer_norm import layer_norm_fused
from ..nn.functional.attention import scaled_dot_product_attention


class GPTConfig:
    """Hyperparameters with the reference's names. ``use_flash`` is kept for
    parity only: the registry picks the attention kernel.

    GPT-MoE: ``moe=E`` is the one-knob spelling, as in the reference: it
    sets ``moe_num_experts = E`` and the per-layer trunk (``stacked=False``),
    and every ``moe_every``-th block (blocks ``moe_every - 1``,
    ``2*moe_every - 1``, ...) swaps its dense FFN for a top-``moe_top_k``
    GShard MoE layer at capacity factor ``moe_capacity_factor``.

    ``recompute``: recompute each block in the backward, at
    ``recompute_granularity`` ``"full"`` or ``"selective"``."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12, num_heads=12,
                 ffn_hidden_size=None, max_seq_len=1024, dropout=0.0, attn_dropout=0.0,
                 initializer_range=0.02, use_flash=True, stacked=True, recompute=False,
                 recompute_granularity="full", moe=0, moe_num_experts=0, moe_every=2,
                 moe_top_k=2, moe_capacity_factor=1.25):
        if moe:
            moe_num_experts = moe_num_experts or int(moe)
            stacked = False
        if moe_num_experts and stacked:
            raise ValueError("GPT-MoE needs stacked=False (heterogeneous layers)")
        if moe_num_experts and moe_every < 1:
            raise ValueError(f"moe_every must be >= 1, got {moe_every}")
        if recompute_granularity not in _REMAT_POLICY:
            raise ValueError(f"recompute_granularity must be 'full' or 'selective', "
                             f"got {recompute_granularity!r}")
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
        self.recompute_granularity = recompute_granularity
        self.moe_num_experts = moe_num_experts
        self.moe_every = moe_every
        self.moe_top_k = moe_top_k
        self.moe_capacity_factor = moe_capacity_factor

    def to_dict(self):
        """Constructor kwargs. Unlike the reference's, they include
        ``recompute_granularity`` and the MoE knobs, so
        ``GPTConfig(**cfg.to_dict())`` rebuilds any config (ROADMAP.md,
        Queue 3)."""
        return dict(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            ffn_hidden_size=self.ffn_hidden_size, max_seq_len=self.max_seq_len,
            dropout=self.dropout, attn_dropout=self.attn_dropout,
            initializer_range=self.initializer_range, use_flash=self.use_flash,
            stacked=self.stacked, recompute=self.recompute,
            recompute_granularity=self.recompute_granularity,
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


def _sep_group():
    """The active fleet's ``sep`` group, or None at sep 1 (or no fleet)."""
    from ..distributed.fleet import fleet

    hcg = fleet.get_hybrid_communicate_group()
    if hcg is None or hcg.get_sep_parallel_world_size() == 1:
        return None
    return hcg.get_sep_parallel_group()


def _normal(shape, std, generator, device):
    return torch.empty(shape, device=device).normal_(0.0, std, generator=generator)


class _Grid:
    """Where a GPT sits on the fleet's grid: its model-parallel group (None
    at mp 1), its pipeline stage and the pipeline's groups, its sequence
    group (None at sep 1)."""

    def __init__(self):
        from ..distributed.fleet import fleet

        self.mp = _mp_group(None)
        hcg = fleet.get_hybrid_communicate_group()
        self.sep = _sep_group()
        self.pp = 1 if hcg is None else hcg.get_pipe_parallel_world_size()
        self.stage = 0 if hcg is None else hcg.get_pipe_parallel_rank()
        self.pp_group = hcg.get_pipe_parallel_group() if self.pp > 1 else None
        self.ends_group = hcg.get_pp_ends_group() if self.pp > 1 else None
        self.first, self.last = self.stage == 0, self.stage == self.pp - 1


class GPTEmbeddings(nn.Module):
    """The word and position tables. At mp 1 the word table is the
    single-device case of the reference's ``VocabParallelEmbedding``, at
    mp > 1 it is one; a pipeline's last stage holds the word table only
    (for the tied head), the middle stages neither."""

    def __init__(self, cfg: GPTConfig, device, generator, grid=None):
        super().__init__()
        grid = grid or _Grid()
        self.sep_group = grid.sep
        table = _normal((cfg.vocab_size, cfg.hidden_size), 0.02, generator, device)
        pos = _normal((cfg.max_seq_len, cfg.hidden_size), cfg.initializer_range, generator, device)
        self.word_embeddings = self.position_embeddings = None
        if grid.first or grid.last:
            if grid.mp is None:
                self.word_embeddings = nn.Embedding.from_pretrained(table, freeze=False)
            else:
                self.word_embeddings = VocabParallelEmbedding(
                    cfg.vocab_size, cfg.hidden_size, device="meta", mp_group=grid.mp)
                self.word_embeddings.weight = nn.Parameter(_shard(table, 0, grid.mp))
        if grid.first:
            self.position_embeddings = nn.Embedding.from_pretrained(pos, freeze=False)

    def forward(self, input_ids, position_ids=None):
        """At sep > 1 ``input_ids`` is this rank's block of the sequence, and
        the default positions are its global ones."""
        if position_ids is None:
            s = input_ids.shape[1]
            first = 0 if self.sep_group is None else self.sep_group.rank * s
            position_ids = torch.arange(first, first + s, device=input_ids.device)
        return self.word_embeddings(input_ids) + self.position_embeddings(position_ids)


def _attn_core_packed(qkv, attn_dropout=0.0, generator=None):
    """Causal self-attention over the packed ``[b, s, 3, h, d]`` projection
    through the ``attention_core`` registry kernel."""
    return registry.dispatch("attention_core", qkv, attn_dropout, generator)


def _block_apply(lp, h, *, num_heads, attn_dropout=0.0, generator=None, epsilon=1e-5,
                 mp_group=None, sep_group=None):
    """One pre-LN decoder block; ``lp`` holds the 12 parameter slices of one
    layer in ``GPTBlockStack._order``. With ``mp_group`` they are this
    rank's shards and ``num_heads`` its heads: the column layers' input
    goes through the copy region, the row layers' partial products through
    the reduce region before their bias. With ``sep_group`` ``h`` is this
    rank's block of the sequence: the packed qkv goes by Ulysses to
    ``[b, s, 3, num_heads / sep, dh]`` for the attention core, and its
    output back to this block."""
    n1w, n1b, qkvw, qkvb, ow, ob, n2w, n2b, f1w, f1b, f2w, f2b = lp
    b, s, d = h.shape
    dh = qkvw.shape[1] // (3 * num_heads)
    x1 = layer_norm_fused(h, n1w, n1b, epsilon)
    if mp_group is not None:
        x1 = copy_to_model_parallel(x1, mp_group)
    qkv = (x1 @ qkvw + qkvb).reshape(b, s, 3, num_heads, dh)
    if sep_group is None:
        att = _attn_core_packed(qkv, attn_dropout, generator)
    else:
        att = heads_to_seq(_attn_core_packed(seq_to_heads(qkv, sep_group, head_axis=3),
                                             attn_dropout, generator), sep_group)
    att = att.reshape(b, s, num_heads * dh)
    if mp_group is None:
        h = h + att @ ow + ob
    else:
        h = h + reduce_from_model_parallel(att @ ow, mp_group) + ob
    x2 = layer_norm_fused(h, n2w, n2b, epsilon)
    if mp_group is not None:
        x2 = copy_to_model_parallel(x2, mp_group)
    y = F.gelu(x2 @ f1w + f1b, approximate="tanh")
    if mp_group is None:
        return h + y @ f2w + f2b
    return h + reduce_from_model_parallel(y @ f2w, mp_group) + f2b


# recompute_granularity -> the recompute policy of each block, as in the
# reference (full: nothing_saveable; selective: dots_saveable, the matmul
# outputs saved)
_REMAT_POLICY = {"full": "nothing_saveable", "selective": "dots_saveable"}


def _stack_forward(x, params, *, num_heads, attn_dropout=0.0, generator=None, recompute=None,
                   mp_group=None, gathers=None, sep_group=None):
    """Whole-trunk forward: the layer loop of the reference at pp = 1 (or
    this stage's layers), each block recomputed in the backward under the
    policy named by ``recompute`` (a granularity, or None for no
    recompute). The stacked parameters are unbound once, so their gradient
    is one ``stack`` of the per-layer gradients, not L zero-filled
    ``[L, ...]`` buffers added up. ``gathers`` (ZeRO stage 3): for each
    parameter, None or ``(dim, group)`` of its blocks in the stack; each
    layer's blocks are gathered as the layer runs, and again in its
    backward (by the recompute, or by :func:`regather_on_backward`)."""
    block = functools.partial(_block_apply, num_heads=num_heads, attn_dropout=attn_dropout,
                              generator=generator, mp_group=mp_group, sep_group=sep_group)
    gathers = gathers or [None] * len(params)

    def gathered(lp):
        return tuple(t if g is None else gather_param(t, g[0] - 1, g[1])
                     for t, g in zip(lp, gathers))

    def layer(lp, h):
        return block(gathered(lp), h)

    h = x
    for lp in zip(*(p.unbind(0) for p in params)):
        if recompute:
            h = _recompute(layer, lp, h, policy=_REMAT_POLICY[recompute])
        elif any(gathers):
            whole = gathered(lp)
            with regather_on_backward([(w, t, g[0] - 1, g[1]) for w, t, g in zip(whole, lp, gathers)
                                       if g is not None]):
                h = block(whole, h)
        else:
            h = block(lp, h)
    return h


# the stacked trunk's tensor-parallel layout (reference gpt.py:393-412):
# (split dim, column blocks) of each sharded parameter; the rest replicated
STACK_MP_SPLITS = {"qkv_w": (2, 3), "qkv_b": (1, 3), "out_w": (1, 1), "ffn1_w": (2, 1),
                   "ffn1_b": (1, 1), "ffn2_w": (1, 1)}


def stage_layers(num_layers, pp, stage):
    """The ``[lo, hi)`` layers of pipeline stage ``stage`` of ``pp``."""
    if num_layers % pp:
        raise ValueError(f"{num_layers} layers do not split over pp degree {pp}")
    n = num_layers // pp
    return stage * n, (stage + 1) * n


class GPTBlockStack(nn.Module):
    """All decoder blocks as ``[L, ...]``-stacked parameters, named and laid
    out (``[in, out]``) as in the reference: on a fleet grid, this rank's
    ``mp`` shards of its stage's layers. At ZeRO stage 3 it gathers its own
    parameters' blocks, layer by layer (``zero_gathers_own``)."""

    _order = ["norm1_w", "norm1_b", "qkv_w", "qkv_b", "out_w", "out_b",
              "norm2_w", "norm2_b", "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b"]
    zero_gathers_own = True

    def __init__(self, cfg: GPTConfig, device, generator, grid=None):
        super().__init__()
        grid = grid or _Grid()
        self.cfg = cfg
        self.mp_group = grid.mp
        self.sep_group = grid.sep
        mp = 1 if grid.mp is None else grid.mp.nranks
        if cfg.num_heads % mp:
            raise ValueError(f"num_heads {cfg.num_heads} does not split over mp degree {mp}")
        self.num_heads = cfg.num_heads // mp  # this rank's heads
        sep = 1 if grid.sep is None else grid.sep.nranks
        if self.num_heads % sep:
            raise ValueError(f"{self.num_heads} heads a rank do not split over sep degree {sep}")
        L, D, Ff = cfg.num_layers, cfg.hidden_size, cfg.ffn_hidden_size
        lo, hi = stage_layers(L, grid.pp, grid.stage)
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
            if grid.pp > 1:
                value = value[lo:hi].contiguous()
            split = STACK_MP_SPLITS.get(name) if grid.mp is not None else None
            if split is not None:
                value = _shard(value, split[0], grid.mp, blocks=split[1])
            self.register_parameter(name, nn.Parameter(value))

    def forward(self, x):
        cfg = self.cfg
        _no_training_dropout(self, cfg)
        parts = getattr(self, "_zero_parts", None) or {}
        return _stack_forward(x, [getattr(self, n) for n in self._order], num_heads=self.num_heads,
                              recompute=cfg.recompute_granularity if cfg.recompute else None,
                              mp_group=self.mp_group, gathers=[parts.get(n) for n in self._order],
                              sep_group=self.sep_group)


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
    ``seed + 1 + layer``. On a pipeline stage, the stage's part (see the
    module's docstring)."""

    def __init__(self, cfg: GPTConfig, device, generator, seed=0, grid=None):
        super().__init__()
        grid = grid or _Grid()
        if (grid.mp is not None or grid.pp > 1 or grid.sep is not None) and not cfg.stacked:
            raise NotImplementedError(
                "GPT's per-layer trunk (and GPT-MoE) under model, pipeline or sequence "
                "parallelism is not ported yet (ROADMAP.md, Queue 1 item 13c): it runs at dp > 1 "
                "(GPT-MoE's experts over dp); use the stacked trunk for mp, pp and sep")
        if grid.sep is not None and grid.pp > 1:
            raise NotImplementedError("GPT under sequence and pipeline parallelism together is "
                                      "not ported yet (ROADMAP.md, Queue 1 item 13c)")
        self.cfg = cfg
        self._first, self._last = grid.first, grid.last
        self.embeddings = GPTEmbeddings(cfg, device, generator, grid)
        if cfg.stacked:
            self.layers = GPTBlockStack(cfg, device, generator, grid)
        else:
            self.layers = nn.ModuleList([
                GPTBlock(cfg, device, generator,
                         use_moe=bool(cfg.moe_num_experts) and (i + 1) % cfg.moe_every == 0,
                         seed=seed + 1 + i)
                for i in range(cfg.num_layers)])
        self.final_norm = nn.LayerNorm(cfg.hidden_size, device=device) if grid.last else None

    def forward(self, input_ids, position_ids=None):
        """The ids' hidden states; on a pipeline stage after the first,
        ``input_ids`` is the activation received."""
        h = self.embeddings(input_ids, position_ids) if self._first else input_ids
        if isinstance(self.layers, GPTBlockStack):
            h = self.layers(h)
        else:
            for blk in self.layers:
                h = self._block_maybe_remat(blk, h)
        if not self._last:
            return h
        return layer_norm_fused(h, self.final_norm.weight, self.final_norm.bias, self.final_norm.eps)

    def _block_maybe_remat(self, blk, h):
        """One per-layer block, recomputed in the backward when
        ``cfg.recompute`` is on (a MoE block replays its routing)."""
        if not self.cfg.recompute:
            return blk(h)
        return _recompute(blk, h, policy=_REMAT_POLICY[self.cfg.recompute_granularity])

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
    random weights are drawn from a ``torch.Generator`` seeded ``seed``
    (none on the ``meta`` device). On a fleet grid it is this rank's part
    of the model (see the module's docstring)."""

    def __init__(self, cfg: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        generator = (None if device.type == "meta"
                     else torch.Generator(device=device).manual_seed(int(seed)))
        grid = _Grid()
        self._grid = grid
        self.gpt = GPTModel(cfg, device, generator, seed=int(seed), grid=grid)
        # the step's reducer sums the gradients over sep; shard_batch cuts the sequence
        self.sequence_parallel = grid.sep is not None
        self._mark_params()

    def _mark_params(self):
        """The attributes the distributed layer reads off the parameters:
        the tensor-parallel shards' (``mp_group``, ``split_axis``), the dim
        each layout splits at any degree (``mp_axis``), the stacked trunk's
        (``stacked_layers``), a pipeline stage's (``pp_group``) and the
        tied table's second copy (``pp_tied_copy``, counted once in a
        norm)."""
        grid, g = self._grid, self.gpt
        if isinstance(g.layers, GPTBlockStack):
            for name in g.layers._order:
                p = getattr(g.layers, name)
                p.stacked_layers = True
                if name in STACK_MP_SPLITS:
                    p.mp_axis = STACK_MP_SPLITS[name][0]
                    if grid.mp is not None:
                        _mark(p, grid.mp, p.mp_axis)
        table = g.embeddings.word_embeddings
        if table is not None:
            table.weight.mp_axis = 0
            if grid.mp is not None:
                _mark(table.weight, grid.mp, 0)
        if grid.pp > 1:
            for p in self.parameters():
                p.pp_group = grid.pp_group  # each stage holds its own layers
            if grid.last and not grid.first:  # the tied table's second copy counts once
                table.weight.pp_tied_copy = True
        for m in self.modules():
            if isinstance(m, MoELayer):
                m.mark_experts()

    def to_empty(self, *, device, recurse=True):
        """``nn.Module.to_empty``, keeping the parameters' distributed
        attributes (a model built on the ``meta`` device, then loaded)."""
        out = super().to_empty(device=device, recurse=recurse)
        self._mark_params()
        return out

    def forward(self, input_ids, position_ids=None):
        """Logits ``[b, s, V]`` (at mp > 1 this rank's vocabulary shard
        ``[b, s, V / mp]``); for GPT-MoE ``(logits, aux)``, the gates'
        summed balancing loss riding the outputs as in the reference. On a
        pipeline stage before the last, the activation to send on."""
        h = self.gpt(input_ids, position_ids)
        if not self._grid.last:
            return h
        if self._grid.mp is not None:  # vocab-sharded logits, for ParallelCrossEntropy
            h = copy_to_model_parallel(h, self._grid.mp)
        logits = h @ self.gpt.embeddings.word_embeddings.weight.T
        if self.gpt.cfg.moe_num_experts:
            return logits, self.gpt.moe_aux_loss
        return logits

    def allreduce_shared_weight_gradients(self):
        """Sum the tied word table's gradient over the first and the last
        pipeline stage, which both hold it (``SharedLayerDesc``'s role);
        ``TrainStep`` calls this after the schedule. Nothing at pp 1."""
        g = self._grid.ends_group
        if g is None or g.nranks == 1:
            return
        w = self.gpt.embeddings.word_embeddings.weight
        if w.grad is not None:
            C.all_reduce(w.grad, group=g)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False, temperature=1.0, top_k=0,
                 top_p=1.0, seed=0, eos_token_id=None):
        """Autoregressive decoding over a static KV cache of
        ``s0 + max_new_tokens`` rows: one prefill, then one token per step
        (the reference's ``lax.scan`` as a loop). Greedy by default;
        ``do_sample`` samples with temperature / top-k / top-p, drawing the
        token after position p from a generator seeded by ``(seed, p)``.
        Returns ``[b, s0 + max_new_tokens]`` token ids (int64).

        Under a fleet with mp > 1 (and pp = sep = 1) every rank of the
        model-parallel group calls this with the same ids: each decodes
        with its own heads (its slice of the fused qkv, its
        ``[L, b, H / mp, S, dh]`` cache, its FFN rows and vocabulary rows),
        the row-parallel products are summed over the group and the
        vocabulary shards' logits gathered before the pick, so every rank
        returns the same tokens (the reference's mp-sharded decode)."""
        cfg = self.gpt.cfg
        params, wte, wpe, fnw, fnb = self._decode_params(tensor_parallel=True)
        mp = self._grid.mp
        device = wte.device
        ids = torch.as_tensor(input_ids, device=device).long()
        if ids.ndim == 1:
            ids = ids[None]
        b, s0 = ids.shape
        if s0 + max_new_tokens > cfg.max_seq_len:
            raise ValueError(f"prompt {s0} + max_new_tokens {max_new_tokens} exceeds "
                             f"max_seq_len {cfg.max_seq_len}")
        H, dh = self.gpt.layers.num_heads, cfg.hidden_size // cfg.num_heads  # this rank's heads
        shape = (cfg.num_layers, b, H, s0 + max_new_tokens, dh)
        cache_k = _kv_zeros(shape, wte.dtype, device)
        cache_v = _kv_zeros(shape, wte.dtype, device)
        sample = (do_sample, temperature, top_k, top_p)

        def pick(logits, position):
            gen = _position_generator(seed, position, device) if do_sample else None
            return _select_token(logits.float(), gen, *sample)

        logits = _cache_forward(params, wte, wpe, fnw, fnb, ids, cache_k, cache_v, 0, num_heads=H,
                                mp_group=mp)
        tok = pick(logits[:, -1], s0 - 1)
        done = torch.zeros(b, dtype=torch.bool, device=device) if eos_token_id is None \
            else tok == eos_token_id
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits = _cache_forward(params, wte, wpe, fnw, fnb, tok[:, None], cache_k, cache_v,
                                    s0 + i, num_heads=H, mp_group=mp)
            nxt = pick(logits[:, -1], s0 + i)
            if eos_token_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
                done = done | (nxt == eos_token_id)
            tok = nxt
            out.append(tok)
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)

    def _decode_params(self, tensor_parallel=False):
        """The decode-path parameter pack ``(stack, wte, wpe, fnw, fnb)``,
        ``stack`` in ``GPTBlockStack._order``; detached views of the
        parameters (at mp > 1, with ``tensor_parallel``, this rank's
        shards). Decoding needs the stacked trunk, as in the reference; the
        serving engine never meshes."""
        g = self.gpt
        if not isinstance(g.layers, GPTBlockStack):
            raise NotImplementedError(
                "generate() requires the stacked trunk (GPTConfig(stacked=True))")
        if self._grid.pp > 1 or self._grid.sep is not None:
            raise NotImplementedError("decoding a GPT under pipeline or sequence parallelism is "
                                      "not ported yet (ROADMAP.md, Queue 1 item 13c)")
        if self._grid.mp is not None and not tensor_parallel:
            raise ValueError("the serving engine decodes an unmeshed model (as the reference's "
                             "never meshes): build the serving model without a fleet; "
                             "generate() decodes at mp > 1")
        stack = tuple(getattr(g.layers, n).detach() for n in g.layers._order)
        return (stack, g.embeddings.word_embeddings.weight.detach(),
                g.embeddings.position_embeddings.weight.detach(),
                g.final_norm.weight.detach(), g.final_norm.bias.detach())


class GPTPretrainingCriterion(nn.Module):
    """Next-token cross entropy: per-token CE with ``ignore_index=-100``
    (``ParallelCrossEntropy``: vocab-parallel under a fleet of mp > 1),
    then the mean over tokens, or the mean under ``loss_mask``. For GPT-MoE
    outputs ``(logits, aux)`` the GShard balancing loss is added with
    weight ``moe_aux_coef``. Under a fleet of sequence degree above 1 each
    rank holds a block of the sequence: the mean is over the global tokens
    (the sums and counts all-reduced over ``sep``), and its gradient is this
    rank's terms', which the step sums over ``sep``."""

    def __init__(self, moe_aux_coef=0.01):
        super().__init__()
        self.moe_aux_coef = moe_aux_coef
        self.parallel_ce = ParallelCrossEntropy(ignore_index=-100)

    @staticmethod
    def token_count(labels, loss_mask=None):
        """How many terms the loss averages: the mask's sum, or every
        token (a pipeline weighs its micro-batches' losses by it)."""
        return loss_mask.sum() if loss_mask is not None else labels.numel()

    def forward(self, logits, labels, loss_mask=None):
        aux = None
        if isinstance(logits, (tuple, list)):
            logits, aux = logits
        per_tok = self.parallel_ce(logits, labels)
        sep = _sep_group()
        if sep is not None:
            m = (torch.ones_like(per_tok) if loss_mask is None
                 else loss_mask.reshape(per_tok.shape).to(per_tok.dtype))
            part = (per_tok * m).sum()
            total = torch.stack([part.detach(), m.sum()])
            C.all_reduce(total, group=sep)
            loss = (part + (total[0] - part.detach())) / total[1]
        elif loss_mask is not None:
            m = loss_mask.reshape(per_tok.shape).to(per_tok.dtype)
            loss = (per_tok * m).sum() / m.sum()
        else:
            loss = per_tok.mean()
        return loss if aux is None else loss + aux * self.moe_aux_coef


# ------------------------------------------------------------------ KV cache
# A cache is a plain tensor in the compute dtype or, under the engine's
# kv_dtype="int8", an int8 pack ``{"q": int8 [..., S, dh], "s": f32 [..., S]}``
# with one abs_max scale per (layer, slot, head, position) row, as in the
# reference. These helpers are the one place that knows the representation:
# writes quantize, attends read a dequantized copy. Writes land in place.

def _kv_quantize(u):
    """``u [..., dh]`` -> ``(q int8 [..., dh], s f32 [...])``: per-row abs_max
    scales with a 1e-8 floor, rounded half to even."""
    f = u.float()
    s = f.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(f / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def _kv_dequant(pack, dt):
    """The values an int8 pack stands for, in dtype ``dt``."""
    return (pack["q"].float() * pack["s"][..., None]).to(dt)


def _kv_zeros(shape, dt, device, kv_dtype=None):
    """A fresh cache buffer; ``shape`` is the payload shape ``[..., S, dh]``.
    ``kv_dtype="int8"`` allocates the int8 pack instead of ``dt``."""
    if kv_dtype == "int8":
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return torch.zeros(shape, dtype=dt, device=device)


def _kv_payload(c):
    """The tensor that carries a cache's ``[..., S, dh]`` shape."""
    return c["q"] if isinstance(c, dict) else c


def _kv_layer(c, i):
    """Index ``i`` of a cache's first dim (a layer, or a slot of one layer's
    cache): a view, array or pack."""
    if isinstance(c, dict):
        return {"q": c["q"][i], "s": c["s"][i]}
    return c[i]


def _kv_bytes(c):
    """Bytes a cache holds as stored (an int8 pack: payload plus scales)."""
    leaves = c.values() if isinstance(c, dict) else (c,)
    return sum(t.numel() * t.element_size() for t in leaves)


def _box(idx, shape):
    return tuple(slice(i, i + n) for i, n in zip(idx, shape))


def _kvc_update(c, u, idx):
    """Write the compute-dtype update ``u`` into cache ``c`` in place at the
    start indices ``idx`` (one per dim; the scale plane takes ``idx[:-1]``);
    quantizes iff ``c`` is a pack."""
    if isinstance(c, dict):
        q, s = _kv_quantize(u)
        c["q"][_box(idx, q.shape)] = q
        c["s"][_box(idx[:-1], s.shape)] = s
    else:
        c[_box(idx, u.shape)] = u


def _kvc_read(c, dt):
    """Attend copy of a cache in dtype ``dt`` (a pack dequantizes)."""
    return _kv_dequant(c, dt) if isinstance(c, dict) else c.to(dt)


def _kvc_copy(c, seg, idx):
    """Copy an already-stored segment (same representation as ``c``) into the
    cache in place at ``idx``: a pack moves payload and scales verbatim."""
    if isinstance(c, dict):
        c["q"][_box(idx, seg["q"].shape)] = seg["q"]
        c["s"][_box(idx[:-1], seg["s"].shape)] = seg["s"]
    else:
        c[_box(idx, seg.shape)] = seg


def _kvc_slice(c, idx, size):
    """A COPY of the segment at ``idx`` of ``size`` in its stored
    representation (the prefix-cache extract; :func:`_kvc_copy` re-inserts
    it). Never a view: the slot it came from is reused by later requests."""
    if isinstance(c, dict):
        return {"q": c["q"][_box(idx, size)].clone(),
                "s": c["s"][_box(idx[:-1], size[:-1])].clone()}
    return c[_box(idx, size)].clone()


def _layer_params(params, i, dt):
    """Layer ``i``'s slices of the stacked decode parameters; an int8 weight
    pack ``{"q": int8 [L, in, out], "s": f32 [L, 1, out]}`` dequantizes into
    ``dt`` here, one layer at a time, right before its matmuls."""
    return tuple((p["q"][i].float() * p["s"][i]).to(dt) if isinstance(p, dict) else p[i]
                 for p in params)


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


def _mp_sum(x, mp_group):
    """``x`` summed over the model-parallel group (``x`` itself at mp 1):
    a row-parallel layer's partial product, before its bias."""
    return x if mp_group is None else C.all_reduce(x.contiguous(), group=mp_group)


def _cache_block(lp, h, ck, cv, start_pos, *, num_heads, epsilon=1e-5, mp_group=None):
    """One decoder block over a fixed-size cache. ``h`` [b, s, d]; ``ck``/
    ``cv`` [b, H, S, dh] (or int8 packs) hold keys/values of positions <
    ``start_pos`` and are written in place at [start_pos, start_pos + s); row
    j attends cache positions <= start_pos + j. Returns the new ``h``. With
    ``mp_group`` the parameters are this rank's shards, ``num_heads`` (and
    the cache's H) its heads, and the output and second FFN products are
    summed over the group before their biases."""
    n1w, n1b, qkvw, qkvb, ow, ob, n2w, n2b, f1w, f1b, f2w, f2b = lp
    b, s, d = h.shape
    S = _kv_payload(ck).shape[2]
    dh = qkvw.shape[-1] // (3 * num_heads)
    x1 = _ln(h, n1w, n1b, epsilon)
    qkv = (x1 @ qkvw + qkvb).reshape(b, s, 3, num_heads, dh)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [b, H, s, dh]
    _kvc_update(ck, k, (0, 0, start_pos, 0))
    _kvc_update(cv, v, (0, 0, start_pos, 0))
    q_pos = start_pos + torch.arange(s, device=h.device)[:, None]
    visible = torch.arange(S, device=h.device)[None] <= q_pos  # [s, S]
    att = _attend(q, _kvc_read(ck, h.dtype), _kvc_read(cv, h.dtype), visible, h.dtype)
    h = h + _mp_sum(att.transpose(1, 2).reshape(b, s, num_heads * dh) @ ow, mp_group) + ob
    y = F.gelu(_ln(h, n2w, n2b, epsilon) @ f1w + f1b, approximate="tanh")
    return h + _mp_sum(y @ f2w, mp_group) + f2b


def _logits(h, wte, fnw, fnb, mp_group=None):
    """The tied head's logits ``[.., V]``; with ``mp_group`` ``wte`` is this
    rank's vocabulary rows, and the shards' logits are gathered."""
    logits = _ln(h, fnw, fnb) @ wte.T
    if mp_group is None:
        return logits
    return C.all_gather_concat(logits.contiguous(), group=mp_group, concat_axis=-1)


def _embed(wte, ids, mp_group=None):
    """The word rows of ``ids``; with ``mp_group`` ``wte`` is this rank's
    vocabulary rows and each id's row comes from the rank holding it (the
    others add zeros: the sum is that row, bit for bit)."""
    if mp_group is None:
        return wte[ids]
    lo = mp_group.rank * wte.shape[0]
    mine = (ids >= lo) & (ids < lo + wte.shape[0])
    rows = wte[(ids - lo).clamp(0, wte.shape[0] - 1)] * mine[..., None].to(wte.dtype)
    return C.all_reduce(rows, group=mp_group)


def _cache_forward(params, wte, wpe, fnw, fnb, ids, cache_k, cache_v, start_pos, *, num_heads,
                   mp_group=None):
    """Trunk forward over a fixed cache: ``ids`` [b, s] at positions from
    ``start_pos``; ``cache_k``/``cache_v`` [L, b, H, S, dh] (or packs) are
    written in place. Returns logits [b, s, V]. With ``mp_group``, this
    rank's part of the tensor-parallel decode (:meth:`GPTForPretraining.generate`):
    its shards, its heads' cache, and the whole logits on every rank."""
    s = ids.shape[1]
    pos = torch.arange(start_pos, start_pos + s, device=ids.device)
    h = (_embed(wte, ids, mp_group) + wpe[pos][None]).to(wte.dtype)
    for i in range(_kv_payload(cache_k).shape[0]):
        h = _cache_block(_layer_params(params, i, wte.dtype), h, _kv_layer(cache_k, i),
                         _kv_layer(cache_v, i), start_pos, num_heads=num_heads,
                         mp_group=mp_group)
    return _logits(h, wte, fnw, fnb, mp_group)


def _slot_write(c, new, slots, rows, active):
    """Write ``new`` [b, W, H, dh] at rows ``rows`` [b, W] of each slot of one
    layer's cache ``c`` [b, H, S, dh] (or pack), in place; a slot that is not
    ``active`` keeps what it held."""
    if isinstance(c, dict):
        q, s = _kv_quantize(new)
        if active is not None:
            q = torch.where(active[:, None, None, None], q, c["q"][slots, :, rows])
            s = torch.where(active[:, None, None], s, c["s"][slots, :, rows])
        c["q"][slots, :, rows] = q
        c["s"][slots, :, rows] = s
        return
    if active is not None:
        new = torch.where(active[:, None, None, None], new, c[slots, :, rows])
    c[slots, :, rows] = new


def _slot_cache_block(lp, h, ck, cv, pos, *, num_heads, epsilon=1e-5, active=None):
    """One decoder block over PER-SLOT cache positions (continuous-batching
    decode). ``h`` [b, W, d] holds a W-token window per slot (W = 1 for plain
    decode, W = K + 1 for speculative verification); ``pos`` [b] (int64) is
    each slot's write index for window row 0. The window's K/V are written in
    place at ``pos[b]`` before attending (so a stale row, a rejected
    speculative tail among them, is overwritten before it is visible), and
    row j attends keys up to ``pos[b] + j``. ``active`` [b] bool gates the
    write per slot: an inactive slot's cache stays untouched. Same per-row
    math as :func:`_cache_block` at s = 1."""
    n1w, n1b, qkvw, qkvb, ow, ob, n2w, n2b, f1w, f1b, f2w, f2b = lp
    b, W, d = h.shape
    S = _kv_payload(ck).shape[2]
    x1 = _ln(h, n1w, n1b, epsilon)
    qkv = (x1 @ qkvw + qkvb).reshape(b, W, 3, num_heads, d // num_heads)
    q = qkv[:, :, 0].transpose(1, 2)  # [b, H, W, dh]
    rows = pos[:, None] + torch.arange(W, device=h.device)  # [b, W]
    slots = torch.arange(b, device=h.device)[:, None]
    _slot_write(ck, qkv[:, :, 1], slots, rows, active)
    _slot_write(cv, qkv[:, :, 2], slots, rows, active)
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
    for i in range(_kv_payload(cache_k).shape[0]):
        h = _slot_cache_block(_layer_params(params, i, wte.dtype), h, _kv_layer(cache_k, i),
                              _kv_layer(cache_v, i), pos, num_heads=num_heads, active=active)
    return _logits(h, wte, fnw, fnb)


def _slot_decode_forward(params, wte, wpe, fnw, fnb, tok, cache_k, cache_v, pos, *, num_heads,
                         active=None):
    """One-token trunk forward with per-slot positions: the serving engine's
    decode step. ``tok`` [b], ``pos`` [b], ``active`` [b] bool. Returns
    logits [b, V]; the W = 1 case of :func:`_slot_window_forward`."""
    return _slot_window_forward(params, wte, wpe, fnw, fnb, tok[:, None], cache_k, cache_v, pos,
                                num_heads=num_heads, active=active)[:, 0]


def _chunk_prefill_block(lp, h, ck, cv, slot, start, *, num_heads, epsilon=1e-5):
    """One decoder block over a CHUNK of one slot's prompt (chunked prefill).
    ``h`` [1, C, d] holds C consecutive prompt tokens of batch slot ``slot``;
    ``ck``/``cv`` [B, H, S, dh] (or packs) are one layer of the engine's
    cache. The chunk's K/V are written in place at ``(slot, start)``, and
    attention reads the slot's whole cache row, masked to each row's own
    prefix, so the chunk sees what earlier chunks (or a prefix-cache insert)
    wrote. Same per-row math as :func:`_cache_block`."""
    n1w, n1b, qkvw, qkvb, ow, ob, n2w, n2b, f1w, f1b, f2w, f2b = lp
    _, C, d = h.shape
    S = _kv_payload(ck).shape[2]
    x1 = _ln(h, n1w, n1b, epsilon)
    qkv = (x1 @ qkvw + qkvb).reshape(1, C, 3, num_heads, d // num_heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [1, H, C, dh]
    _kvc_update(ck, k, (slot, 0, start, 0))
    _kvc_update(cv, v, (slot, 0, start, 0))
    rk = _kvc_read(_kv_layer(ck, slot), h.dtype)[None]  # [1, H, S, dh]
    rv = _kvc_read(_kv_layer(cv, slot), h.dtype)[None]
    q_pos = start + torch.arange(C, device=h.device)[:, None]
    visible = torch.arange(S, device=h.device)[None] <= q_pos  # [C, S]
    att = _attend(q, rk, rv, visible, h.dtype)
    h = h + att.transpose(1, 2).reshape(1, C, d) @ ow + ob
    y = F.gelu(_ln(h, n2w, n2b, epsilon) @ f1w + f1b, approximate="tanh")
    return h + y @ f2w + f2b


def _chunk_prefill_forward(params, wte, wpe, fnw, fnb, ids, cache_k, cache_v, slot, start, *,
                           num_heads, last_row=None):
    """Trunk forward over one prompt chunk of one slot, directly against the
    engine's [L, B, H, S, dh] cache (written in place). ``ids`` [1, C];
    ``start`` is the chunk's first position. With ``last_row``, returns the
    logits [1, V] of that row (the sampling row of a prompt's last chunk);
    intermediate chunks skip the logits and return None."""
    C = ids.shape[1]
    pos = torch.arange(start, start + C, device=ids.device)
    h = (wte[ids] + wpe[pos][None]).to(wte.dtype)
    for i in range(_kv_payload(cache_k).shape[0]):
        h = _chunk_prefill_block(_layer_params(params, i, wte.dtype), h, _kv_layer(cache_k, i),
                                 _kv_layer(cache_v, i), slot, start, num_heads=num_heads)
    if last_row is None:
        return None
    return _logits(h[:, last_row], wte, fnw, fnb)


# ------------------------------------------------------------ token choice
# A sampled token is drawn from a generator seeded by (request seed,
# position, purpose): a request's samples depend only on its own seed and
# positions, never on its slot, its batch neighbours or how many decode
# steps one dispatch runs. The draw is the exponential race (argmax of
# p / E, E ~ Exp(1) per token), which is what torch.multinomial does for one
# sample, without its host-side validity check: no sampling step waits for
# the device. Purposes: 0 the token itself (decode, prefill, a speculative
# window's bonus row), and for speculative decoding 1 the acceptance
# uniform, 2 the residual draw, 3 the draft's proposal, as the reference
# folds them.

def _position_generator(seed, position, device, purpose=0):
    """The generator of the draw of ``purpose`` for the token following
    ``position`` (< 2**24) of a request seeded ``seed``. The three are packed
    into 64 bits and mixed by splitmix64's finaliser: the CPU generator
    (mt19937) keeps only the low 32 bits of its seed, so every bit of the
    input must reach them."""
    mask = 0xFFFFFFFFFFFFFFFF
    x = (((int(seed) & 0xFFFFFFFF) << 32) | ((int(purpose) & 0xFF) << 24)
         | (int(position) & 0xFFFFFF))
    x = (x + 0x9E3779B97F4A7C15) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    return torch.Generator(device=device).manual_seed(x ^ (x >> 31))


def _sample(probs, generator):
    """One token per row of ``probs`` [b, V] by the exponential race."""
    race = torch.empty_like(probs).exponential_(generator=generator)
    return torch.where(probs > 0, probs / race, torch.full_like(probs, -1.0)).argmax(dim=-1)


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
    return _sample(torch.softmax(_filtered_logits(logits, temperature, top_k, top_p), dim=-1),
                   generator)


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

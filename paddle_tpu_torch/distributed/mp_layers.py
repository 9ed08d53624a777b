"""Tensor-parallel layers of the port (``paddle_tpu/distributed/mp_layers.py``;
parity: python/paddle/distributed/fleet/meta_parallel/parallel_layers/
mp_layers.py, VocabParallelEmbedding:30, ColumnParallelLinear:95,
RowParallelLinear:171, ParallelCrossEntropy:251).

The reference's layers carry ``mp`` sharding annotations and XLA's
partitioner inserts the collectives. The port's hold their shard and run
Megatron's collectives themselves over the model-parallel group (the
active fleet's ``mp`` group, or ``mp_group``):

- ``ColumnParallelLinear`` holds ``W[:, out-shard]`` and ``b[out-shard]``;
  its input goes through the *copy* region (identity forward, all-reduce
  backward) and, with ``gather_output``, its output through the *gather*
  region (all-gather forward, slice backward). ``blocks=k`` splits each of
  ``k`` equal column blocks on its own (a fused ``[q | k | v]``
  projection keeps its heads together);
- ``RowParallelLinear`` holds ``W[in-shard, :]``; a full input is first
  sliced (the *scatter* region); the partial products go through the
  *reduce* region (all-reduce forward, identity backward), and the
  replicated bias is added once, after it;
- ``VocabParallelEmbedding`` holds ``W[vocab-shard, :]``, looks up the ids
  of its shard (the others at row 0, their rows zeroed) and all-reduces;
- ``ParallelCrossEntropy`` is the vocab-parallel softmax cross entropy: an
  all-reduce of the row max, of the sum of exponentials and of the target
  logit, with its own backward.

A model built from a seed at mp > 1 draws each full weight as at one rank
and keeps its own shard, so it holds exactly the shards of the one-rank
model. The sharded parameters carry ``is_distributed = True``, their shard
axis (``split_axis``) and group (``mp_group``); a shard is told by its
``mp_group``, since every tensor has a legacy ``is_distributed`` method.
With one rank the layers are the plain ``Linear``, ``Embedding`` and cross
entropy, with the reference's default initialisers (XavierNormal weights,
zero biases, a Normal(0, 0.02) vocabulary table).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..framework.device import resolve_device
from ..framework.selected_rows import in_compiled_step
from ..nn import initializer as I
from ..nn.layer import _attr
from ..nn.functional.common import embedding, linear
from ..nn.functional.loss import cross_entropy
from . import collective as C


def _mp_group(mp_group):
    """The model-parallel group of more than one rank, or None."""
    if mp_group is None:
        from .fleet import fleet

        hcg = fleet.get_hybrid_communicate_group()
        if hcg is None:
            return None
        mp_group = hcg.get_model_parallel_group()
    return mp_group if mp_group.nranks > 1 else None


def model_parallel_degree(mp_group=None):
    """The size of the model-parallel group (1 without one)."""
    g = _mp_group(mp_group)
    return 1 if g is None else g.nranks


def _shard(full, axis, group, blocks=1):
    """This rank's shard of ``full`` along ``axis``: each of the ``blocks``
    equal blocks split in ``group.nranks`` pieces, the rank's piece of each
    in block order."""
    n, r = group.nranks, group.rank
    size = full.shape[axis]
    if size % (blocks * n):
        raise ValueError(f"a dim of size {size} ({blocks} blocks) does not split over "
                         f"{n} model-parallel ranks")
    parts = full.unflatten(axis, (blocks, n, size // (blocks * n))).select(axis + 1, r)
    return parts.flatten(axis, axis + 1).contiguous()


def _mark(p, group, axis):
    p.is_distributed = True
    p.split_axis = p.mp_axis = axis
    p.mp_group = group
    return p


# -- the mp-region collectives ------------------------------------------------
class _CopyToMP(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce(g.clone(), group=ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    """All-reduce forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return C.all_reduce(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMP(torch.autograd.Function):
    """All-gather of the last dim forward (each of ``blocks`` column blocks
    gathered on its own); this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, group, blocks):
        ctx.group, ctx.blocks = group, blocks
        parts = C.all_gather([], x.contiguous(), group=group)
        stacked = torch.stack([p.unflatten(-1, (blocks, -1)) for p in parts], dim=-2)
        return stacked.flatten(-3)

    @staticmethod
    def backward(ctx, g):
        n, k = ctx.group.nranks, ctx.blocks
        mine = g.unflatten(-1, (k, n, g.shape[-1] // (k * n))).select(-2, ctx.group.rank)
        return mine.flatten(-2).contiguous(), None, None


class _ScatterToMP(torch.autograd.Function):
    """This rank's slice of the last dim forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shard(x, x.ndim - 1, group)

    @staticmethod
    def backward(ctx, g):
        return C.all_gather_concat(g.contiguous(), group=ctx.group, concat_axis=-1), None


def copy_to_model_parallel(x, group):
    return _CopyToMP.apply(x, group)


def reduce_from_model_parallel(x, group):
    return _ReduceFromMP.apply(x, group)


def gather_from_model_parallel(x, group, blocks=1):
    return _GatherFromMP.apply(x, group, blocks)


def _XAVIER(shape, dtype, generator, device):
    """The layers' default, ``XavierNormal()``, from ``generator`` (None:
    torch's default generator)."""
    return I.xavier_normal(shape, generator, device)


# -- layers -------------------------------------------------------------------
class ColumnParallelLinear(nn.Module):
    """``y = x @ W + b``, ``W`` ``[in, out]`` sharded on ``out``."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 gather_output=True, fuse_matmul_bias=False, mp_group=None, name=None, *,
                 blocks=1, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output, self.blocks = gather_output, blocks
        self.group = _mp_group(mp_group)
        w = _attr.value((in_features, out_features), weight_attr, _XAVIER, generator, device,
                        layer="ColumnParallelLinear")
        b = _attr.value((out_features,), None, I.Constant(0.0), generator, device, is_bias=True,
                        layer="ColumnParallelLinear", what="bias") if has_bias else None
        if self.group is not None:
            w, b = _shard(w, 1, self.group, blocks), b if b is None else _shard(b, 0, self.group, blocks)
        self.weight = _attr.finish(nn.Parameter(w), weight_attr)
        self.bias = None if b is None else nn.Parameter(b)
        self.weight.mp_axis = 1  # the dim the layout splits, at any degree (ZeRO's plan)
        if self.bias is not None:
            self.bias.mp_axis = 0
        if self.group is not None:
            _mark(self.weight, self.group, 1)
            if self.bias is not None:
                _mark(self.bias, self.group, 0)

    def forward(self, x):
        if self.group is None:
            return linear(x, self.weight, self.bias)
        out = copy_to_model_parallel(x, self.group) @ self.weight
        if self.bias is not None:
            out = out + self.bias
        return gather_from_model_parallel(out, self.group, self.blocks) if self.gather_output else out

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}, gather_output={self.gather_output}"


class RowParallelLinear(nn.Module):
    """``y = x @ W + b``, ``W`` ``[in, out]`` sharded on ``in``; the partial
    products are all-reduced and the bias added once, after it.
    ``input_is_parallel``: ``x`` is already this rank's slice of ``in``."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 input_is_parallel=False, fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.group = _mp_group(mp_group)
        w = _attr.value((in_features, out_features), weight_attr, _XAVIER, generator, device,
                        layer="RowParallelLinear")
        if self.group is not None:
            w = _shard(w, 0, self.group)
        self.weight = _attr.finish(nn.Parameter(w), weight_attr)
        self.weight.mp_axis = 0
        self.bias = _attr.param((out_features,), None, I.Constant(0.0), generator, device,
                                is_bias=True, layer="RowParallelLinear",
                                what="bias") if has_bias else None
        if self.group is not None:
            _mark(self.weight, self.group, 0)

    def forward(self, x):
        if self.group is None:
            return linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _ScatterToMP.apply(x, self.group)
        out = reduce_from_model_parallel(x @ self.weight, self.group)
        return out + self.bias if self.bias is not None else out

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class VocabParallelEmbedding(nn.Module):
    """Embedding drawn Normal(0, 0.02), its vocabulary sharded over the
    model-parallel group. An out-of-range id raises outside a
    ``TrainStep`` and gives the zero row inside one, as
    :func:`~paddle_tpu_torch.nn.functional.embedding` does."""

    init_std = 0.02

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None, mp_group=None, name=None,
                 *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.group = _mp_group(mp_group)
        std = self.init_std
        w = _attr.value((num_embeddings, embedding_dim), weight_attr,
                        lambda shape, dtype, g, d: I.normal(shape, std, g, d), generator, device,
                        layer="VocabParallelEmbedding")
        if self.group is not None:
            w = _shard(w, 0, self.group)
        self.weight = _attr.finish(nn.Parameter(w), weight_attr)
        self.weight.mp_axis = 0
        if self.group is not None:
            _mark(self.weight, self.group, 0)

    def forward(self, x):
        if self.group is None:
            return embedding(x, self.weight)
        if not in_compiled_step():
            bad = (x < 0) | (x >= self.num_embeddings)
            if bool(bad.any()):
                embedding(x, self.weight.new_zeros(self.num_embeddings, 1))  # raises, naming the id
        rows = self.weight.shape[0]
        local = x - self.group.rank * rows
        inside = (local >= 0) & (local < rows)
        out = torch.nn.functional.embedding(torch.where(inside, local, 0), self.weight)
        out = torch.where(inside[..., None], out, 0.0)
        return reduce_from_model_parallel(out, self.group)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class _VocabParallelCE(torch.autograd.Function):
    """Per-token softmax cross entropy of vocab-sharded logits ``[..., V /
    mp]`` against global labels, f32; ``ignore_index`` rows give 0."""

    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        rows = logits.shape[-1]
        x = logits.float()
        m = x.amax(dim=-1, keepdim=True)
        C.all_reduce(m, op=C.ReduceOp.MAX, group=group)
        sumexp = torch.exp(x - m).sum(dim=-1, keepdim=True)
        C.all_reduce(sumexp, group=group)
        valid = label != ignore_index
        local = label - group.rank * rows
        inside = valid & (local >= 0) & (local < rows)
        local = torch.where(inside, local, 0)
        target = torch.where(inside[..., None], x.gather(-1, local[..., None]), 0.0)
        C.all_reduce(target, group=group)
        loss = (torch.log(sumexp) + m - target).squeeze(-1)
        ctx.save_for_backward(logits, m, sumexp, local, inside, valid)
        return torch.where(valid, loss, 0.0)

    @staticmethod
    def backward(ctx, g):
        logits, m, sumexp, local, inside, valid = ctx.saved_tensors
        p = torch.exp(logits.float() - m) / sumexp
        iota = torch.arange(logits.shape[-1], device=logits.device)
        onehot = ((iota == local[..., None]) & inside[..., None]).float()
        scale = torch.where(valid, g.float(), 0.0)[..., None]
        return ((p - onehot) * scale).to(logits.dtype), None, None, None


class ParallelCrossEntropy(nn.Module):
    """Per-token softmax cross entropy over the class axis
    (``reduction="none"``), ``ignore_index`` rows 0; at mp > 1 over
    vocab-sharded logits."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self.group = _mp_group(mp_group)

    def forward(self, input, label):
        if self.group is None:
            return cross_entropy(input, label, reduction="none", ignore_index=self.ignore_index)
        if label.ndim == input.ndim and label.shape[-1] == 1:
            label = label.squeeze(-1)
        return _VocabParallelCE.apply(input, label.long(), self.group, self.ignore_index)


class TensorParallel(nn.Module):
    """Parity: fleet/meta_parallel/tensor_parallel.py:25. At mp > 1 the
    replicated (not ``is_distributed``) parameters and the buffers are
    broadcast from the group's rank 0 at construction, so every rank of
    the group starts from one copy; the forward is the wrapped layers'."""

    def __init__(self, layers, hcg=None, **kwargs):
        super().__init__()
        self._layers = layers
        group = _mp_group(hcg.get_model_parallel_group() if hcg is not None else None)
        if group is not None:
            with torch.no_grad():
                for t in list(layers.parameters()) + list(layers.buffers()):
                    if getattr(t, "mp_group", None) is None:
                        C.broadcast(t.data, src=0, group=group)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)


class _RNGStatesTracker:
    """Named random streams (parity: parallel_layers/random.py
    RNGStatesTracker): each name is a ``torch.Generator`` seeded once by
    :meth:`add`; ``rng_state(name)`` yields it, so draws made from it are
    the same on every rank that added the same seed (the tensor-parallel
    ranks of one group), while the default streams stay each rank's own."""

    def __init__(self):
        self._seeds = {}
        self._generators = {}

    def add(self, name, seed):
        if name in self._seeds and self._seeds[name] != int(seed):
            raise ValueError(f"RNG stream {name!r} already added with a different seed")
        self._seeds[name] = int(seed)

    def get_states_tracker(self):
        """Each stream's seed, by name."""
        return dict(self._seeds)

    def _generator(self, name, device):
        key = (name, device)
        if key not in self._generators:
            self._generators[key] = torch.Generator(device=device).manual_seed(self._seeds[name])
        return self._generators[key]

    @contextlib.contextmanager
    def rng_state(self, name="model_parallel_rng", device=None):
        """The stream ``name``'s generator on ``device`` (this process's
        device by default)."""
        if name not in self._seeds:
            raise ValueError(f"unknown RNG stream {name!r}; call add(name, seed) first")
        if device is None:
            from .env import get_device, is_initialized

            device = get_device() if is_initialized() else torch.device("cpu")
        yield self._generator(name, torch.device(device))


_RNG_TRACKER = None


def get_rng_state_tracker():
    global _RNG_TRACKER
    if _RNG_TRACKER is None:
        _RNG_TRACKER = _RNGStatesTracker()
    return _RNG_TRACKER

"""Tensor-parallel layers of the port at one rank
(``paddle_tpu/distributed/mp_layers.py``).

The reference's layers carry sharding annotations for XLA's partitioner;
at one rank they compute what their plain counterparts compute, with the
reference's default initialisers: ``ColumnParallelLinear`` and
``RowParallelLinear`` are a :class:`~paddle_tpu_torch.nn.layer.Linear`
(XavierNormal ``[in, out]`` weight, zero bias), ``VocabParallelEmbedding`` an
:class:`~paddle_tpu_torch.nn.layer.Embedding` drawn Normal(0, 0.02), and
``ParallelCrossEntropy`` the per-token hard-label cross entropy. A
model-parallel group of more than one rank raises: sharding over
``torch.distributed`` is ROADMAP.md Queue 1 item 13, as are
``TensorParallel`` and the RNG tracker.
"""
from __future__ import annotations

from torch import nn

from ..nn.functional.loss import cross_entropy
from ..nn.layer import Embedding, Linear


def _one_rank(mp_group):
    if mp_group is not None and getattr(mp_group, "nranks", 1) > 1:
        raise NotImplementedError(
            "model parallelism over more than one rank is not ported yet "
            "(ROADMAP.md, Queue 1 item 13)")


class ColumnParallelLinear(Linear):
    """``y = x @ W + b``, ``W`` ``[in, out]`` (sharded on ``out`` in the
    reference)."""

    def __init__(self, in_features, out_features, mp_group=None, *, device=None, generator=None):
        _one_rank(mp_group)
        super().__init__(in_features, out_features, device=device, generator=generator)


class RowParallelLinear(Linear):
    """``y = x @ W + b``, ``W`` ``[in, out]`` (sharded on ``in`` in the
    reference, with an all-reduce of the output)."""

    def __init__(self, in_features, out_features, mp_group=None, *, device=None, generator=None):
        _one_rank(mp_group)
        super().__init__(in_features, out_features, device=device, generator=generator)


class VocabParallelEmbedding(Embedding):
    """Embedding with the vocab dim sharded in the reference; drawn
    Normal(0, 0.02)."""

    init_std = 0.02

    def __init__(self, num_embeddings, embedding_dim, mp_group=None, *, device=None,
                 generator=None):
        _one_rank(mp_group)
        super().__init__(num_embeddings, embedding_dim, device=device, generator=generator)


class ParallelCrossEntropy(nn.Module):
    """Per-token softmax cross entropy over the class axis
    (``reduction="none"``), ``ignore_index`` rows 0."""

    def __init__(self, mp_group=None, ignore_index=-100):
        super().__init__()
        _one_rank(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return cross_entropy(input, label, reduction="none", ignore_index=self.ignore_index)

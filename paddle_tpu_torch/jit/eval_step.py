"""``EvalStep`` of the port (``paddle_tpu/jit/__init__.py:635-682``): the
model's forward alone, in eval mode under ``torch.no_grad()``.

The reference compiles the forward and runs it in f32; here the forward
runs eagerly in the parameters' dtype (an O2-trained model keeps f32
masters, so that is f32 too), and the model's training mode is restored
after the call.

With ``mesh`` (the fleet's ``HybridCommunicateGroup``) each rank feeds its
own block of the batch over the data axes (``fleet.shard_batch``'s block,
as ``TrainStep(mesh=)`` takes it; ``batch_sharding`` a subset of
``("dp", "sdp")``, both by default) and gets the global batch's outputs
back: every output is all-gathered over those axes in rank order, as the
reference's sharded computation returns a global array. Parameters already
hold their rank's piece (their ``dist_spec``), so the reference's per-batch
parameter placement has no counterpart.
"""
from __future__ import annotations

import torch


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, t) for k, t in tree.items()}
    return fn(tree)


class EvalStep:
    """``EvalStep(model)(*inputs)``: the model's outputs on ``inputs``
    (arrays or tensors, moved to the model's device) with no gradient."""

    def __init__(self, model, mesh=None, batch_sharding=None):
        self.model = model
        self.mesh = mesh
        self.device = next(model.parameters()).device
        self._group = None
        if mesh is not None:
            from ..distributed.topology import HybridCommunicateGroup

            if not isinstance(mesh, HybridCommunicateGroup):
                raise TypeError("EvalStep: mesh must be the fleet's HybridCommunicateGroup, got "
                                f"{type(mesh).__name__}")
            axes = tuple(batch_sharding or ("dp", "sdp"))
            if not set(axes) <= {"dp", "sdp"}:
                raise ValueError(f"EvalStep: batch_sharding must name axes of ('dp', 'sdp'), got "
                                 f"{batch_sharding!r}")
            if set(axes) == {"dp", "sdp"}:
                self._group = mesh.get_data_sharding_group()
            elif axes == ("dp",):
                self._group = mesh.get_data_parallel_group()
            else:
                self._group = mesh.get_sharding_parallel_group()

    def _gather(self, t):
        from ..distributed import collective as C

        return torch.cat(C.all_gather([], t, group=self._group), dim=0)

    @torch.no_grad()
    def __call__(self, *inputs):
        xs = tuple(torch.as_tensor(x, device=self.device) for x in inputs)
        was_training = self.model.training
        self.model.eval()
        try:
            out = self.model(*xs)
        finally:
            self.model.train(was_training)
        if self._group is not None and self._group.nranks > 1:
            out = _tree_map(self._gather, out)
        return out

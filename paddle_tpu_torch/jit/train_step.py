"""``TrainStep`` of the port (``paddle_tpu/jit/__init__.py``): forward, loss,
backward and optimizer update as one call.

The reference traces the step into one XLA program; PyTorch runs it eagerly
here, so ``run_steps(k)`` is a Python loop of k steps (a CUDA graph of it is
later work, ROADMAP.md Queue 1 item 8).

AMP O2 works as in the reference: the model's parameters stay the f32
masters; each step runs the model on bf16 casts of them
(``torch.func.functional_call``), so the gradient of each cast lands in f32
on its master; float inputs are cast likewise; buffers are not cast, so an
update made to one in place survives the step; the model's output goes into
the loss in bf16, and a bf16 loss is cast to f32.

``remat=True`` (or ``FLAGS_remat_policy`` other than ``"none"``) recomputes
the whole model call and loss in the backward. ``accumulate_steps=k``
merges gradients as the reference does: the batch is split into k strided
micro-batches (:func:`paddle_tpu_torch.distributed.pipeline.microbatch`),
each runs its forward and backward, the f32 gradients add up on the masters
and are divided by k, the loss is the mean of the k losses, and one update
follows (a gradient clip sees the average).
"""
from __future__ import annotations

import torch
from torch.func import functional_call

from ..distributed.pipeline import microbatch, unmicrobatch
from ..distributed.recompute import recompute
from ..framework.flags import flag
from ..observability import metrics

_NOT_PORTED = "TrainStep: {} is not ported yet (ROADMAP.md, Queue 1 item {})"


def _as_tensors(x, device):
    items = x if isinstance(x, (list, tuple)) else (x,)
    return tuple(torch.as_tensor(v, device=device) for v in items)


def _tree_map(fn, *trees):
    """``fn`` over the tensors of same-structured (nested tuple, list or
    dict) model outputs."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _stack_microbatches(*outs):
    """The k micro-batches' outputs back in batch order: a leaf with a
    batch dim is stacked ``[k, mb, ...]`` and unsplit; a scalar (GPT-MoE's
    aux loss) is stacked ``[k]``."""
    return _tree_map(lambda *xs: unmicrobatch(torch.stack(xs)) if xs[0].ndim else torch.stack(xs),
                     *outs)


class TrainStep:
    """One training step: ``loss_fn(model(*inputs), *labels)``, its
    backward, and ``optimizer``'s update at ``optimizer.lr_at(step)``.

    ``amp_level``: None or ``"O0"`` (the model's dtype) or ``"O2"`` (compute
    in ``amp_dtype`` over f32 masters). ``remat``: recompute the model call
    in the backward. ``accumulate_steps``: micro-batches per update.
    ``return_outputs``: the model's outputs (in batch order) in the metrics
    under ``"outputs"``. ``seed`` is kept for the reference's signature:
    nothing random runs in the step until dropout is ported. The knobs the
    port lacks raise ``NotImplementedError``."""

    def __init__(self, model, optimizer, loss_fn, mesh=None, state_shardings=None,
                 batch_shardings=None, remat=False, seed=0, amp_level=None, amp_dtype="bfloat16",
                 accumulate_steps=1, return_outputs=False, guard=None):
        if mesh is not None or state_shardings is not None or batch_shardings is not None:
            raise NotImplementedError(_NOT_PORTED.format("a device mesh or shardings", 13))
        if guard:
            raise NotImplementedError(_NOT_PORTED.format("guard", 6))
        if int(accumulate_steps) < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
        if amp_level not in (None, "O0", "O1", "O2"):
            raise ValueError(f"amp_level must be None/'O0'/'O1'/'O2', got {amp_level!r}")
        if amp_level == "O1":
            raise NotImplementedError(_NOT_PORTED.format("amp_level='O1'", 6))
        self.amp_level = None if amp_level == "O0" else amp_level
        self.amp_dtype = getattr(torch, amp_dtype) if self.amp_level else None
        if self.amp_dtype == torch.float16:
            raise NotImplementedError(_NOT_PORTED.format("float16 AMP (GradScaler)", 6))
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.seed = seed
        self.remat = bool(remat) or flag("FLAGS_remat_policy") != "none"
        self.accumulate_steps = int(accumulate_steps)
        self.return_outputs = bool(return_outputs)
        self.device = next(model.parameters()).device

    def _to_amp(self, t):
        return t.to(self.amp_dtype) if t.dtype == torch.float32 else t

    def _loss(self, inputs, labels):
        """``(loss, model outputs)`` of one (micro-)batch."""
        if self.amp_level == "O2":
            # cast the parameters only: the buffers run as they are, so an
            # in-place update in forward (a running statistic) lands in the
            # module's own buffer, as the reference's new_buffers do. The
            # casts are made here, outside a remat block, and stay saved.
            state = {n: self._to_amp(p) for n, p in self.model.named_parameters()}
            inputs = tuple(self._to_amp(x) for x in inputs)

            def call(*xs):
                return functional_call(self.model, state, xs)
        else:
            call = self.model

        def loss_of(*xs):
            out = call(*xs)
            return self.loss_fn(out, *labels), out

        if self.remat:
            loss, out = recompute(loss_of, *inputs, policy="nothing_saveable", replay=self.model)
        else:
            loss, out = loss_of(*inputs)
        return (loss.float() if loss.dtype == self.amp_dtype else loss), out

    def _step(self, inputs, labels):
        """One update; returns ``(loss, lr, outputs or None)``."""
        lr = self.optimizer.lr_at(self.optimizer._step_count)
        self.optimizer.clear_grad()
        inputs, labels = _as_tensors(inputs, self.device), _as_tensors(labels, self.device)
        k = self.accumulate_steps
        mb_in = [microbatch(x, k) for x in inputs]
        mb_lb = [microbatch(x, k) for x in labels]
        losses, outs = [], []
        was_training = self.model.training
        self.model.train()
        try:
            for i in range(k):
                loss, out = self._loss(tuple(x[i].contiguous() for x in mb_in),
                                       tuple(x[i].contiguous() for x in mb_lb))
                loss.backward()  # adds this micro-batch's f32 gradients on the masters
                losses.append(loss.detach())
                outs.append(_tree_map(torch.Tensor.detach, out) if self.return_outputs else None)
                del loss, out
        finally:
            self.model.train(was_training)
        if k > 1:
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(k)
        self.optimizer._apply(lr)
        outputs = None
        if self.return_outputs:
            outputs = outs[0] if k == 1 else _stack_microbatches(*outs)
        return torch.stack(losses).mean(), lr, outputs

    def __call__(self, inputs, labels):
        """One step; returns ``{"loss": f32 scalar tensor, "lr": float}``,
        plus ``"outputs"`` with ``return_outputs``."""
        loss, lr, outputs = self._step(inputs, labels)
        metrics.counter_inc("train_step.dispatches")
        metrics.counter_inc("train_step.steps")
        result = {"loss": loss, "lr": lr}
        if self.return_outputs:
            result["outputs"] = outputs
        return result

    def run_steps(self, batches, k=None):
        """k steps: ``batches`` is k ``(inputs, labels)`` pairs (``k`` may be
        omitted), or one pair whose tensors carry a leading ``[k, ...]`` axis
        (then ``k`` is given). Returns the metrics stacked ``[k]``."""
        if k is None:
            batches = list(batches)
            if not batches:
                raise ValueError("run_steps needs at least one batch")
        else:
            k = int(k)
            inputs, labels = (_as_tensors(x, self.device) for x in batches)
            for t in inputs + labels:
                if t.shape[:1] != (k,):
                    raise ValueError(f"pre-stacked batch leaf has leading dim {tuple(t.shape[:1])}, "
                                     f"expected ({k},)")
            batches = [(tuple(t[i] for t in inputs), tuple(t[i] for t in labels)) for i in range(k)]
        results = [self._step(i, l) for i, l in batches]
        metrics.counter_inc("train_step.dispatches")
        metrics.counter_inc("train_step.steps", len(results))
        out = {"loss": torch.stack([r[0] for r in results]),
               "lr": torch.tensor([r[1] for r in results], dtype=torch.float32)}
        if self.return_outputs:
            out["outputs"] = _tree_map(lambda *xs: torch.stack(xs), *(r[2] for r in results))
        return out

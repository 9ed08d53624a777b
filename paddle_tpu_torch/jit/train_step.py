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
"""
from __future__ import annotations

import torch
from torch.func import functional_call

from ..observability import metrics

_NOT_PORTED = "TrainStep: {} is not ported yet (ROADMAP.md, Queue 1 item {})"


def _as_tensors(x, device):
    items = x if isinstance(x, (list, tuple)) else (x,)
    return tuple(torch.as_tensor(v, device=device) for v in items)


class TrainStep:
    """One training step: ``loss_fn(model(*inputs), *labels)``, its
    backward, and ``optimizer``'s update at ``optimizer.lr_at(step)``.

    ``amp_level``: None or ``"O0"`` (the model's dtype) or ``"O2"`` (compute
    in ``amp_dtype`` over f32 masters). ``seed`` is kept for the reference's
    signature: nothing random runs in the step until dropout is ported. The
    knobs the port lacks raise ``NotImplementedError``."""

    def __init__(self, model, optimizer, loss_fn, mesh=None, state_shardings=None,
                 batch_shardings=None, remat=False, seed=0, amp_level=None, amp_dtype="bfloat16",
                 accumulate_steps=1, return_outputs=False, guard=None):
        if mesh is not None or state_shardings is not None or batch_shardings is not None:
            raise NotImplementedError(_NOT_PORTED.format("a device mesh or shardings", 13))
        if remat:
            raise NotImplementedError(_NOT_PORTED.format("remat (recompute)", 5))
        if int(accumulate_steps) > 1:
            raise NotImplementedError(_NOT_PORTED.format("accumulate_steps > 1", 6))
        if guard:
            raise NotImplementedError(_NOT_PORTED.format("guard", 6))
        if return_outputs:
            raise NotImplementedError(_NOT_PORTED.format("return_outputs", 6))
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
        self.device = next(model.parameters()).device

    def _to_amp(self, t):
        return t.to(self.amp_dtype) if t.dtype == torch.float32 else t

    def _loss(self, inputs, labels):
        was_training = self.model.training
        self.model.train()
        try:
            if self.amp_level == "O2":
                # cast the parameters only: the buffers run as they are, so an
                # in-place update in forward (a running statistic) lands in
                # the module's own buffer, as the reference's new_buffers do
                state = {n: self._to_amp(p) for n, p in self.model.named_parameters()}
                out = functional_call(self.model, state, tuple(self._to_amp(x) for x in inputs))
            else:
                out = self.model(*inputs)
            loss = self.loss_fn(out, *labels)
        finally:
            self.model.train(was_training)
        return loss.float() if loss.dtype == self.amp_dtype else loss

    def _step(self, inputs, labels):
        lr = self.optimizer.lr_at(self.optimizer._step_count)
        self.optimizer.clear_grad()
        loss = self._loss(_as_tensors(inputs, self.device), _as_tensors(labels, self.device))
        loss.backward()
        self.optimizer._apply(lr)
        return loss.detach(), lr

    def __call__(self, inputs, labels):
        """One step; returns ``{"loss": f32 scalar tensor, "lr": float}``."""
        loss, lr = self._step(inputs, labels)
        metrics.counter_inc("train_step.dispatches")
        metrics.counter_inc("train_step.steps")
        return {"loss": loss, "lr": lr}

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
        return {"loss": torch.stack([r[0] for r in results]),
                "lr": torch.tensor([r[1] for r in results], dtype=torch.float32)}

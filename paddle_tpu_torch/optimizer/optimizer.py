"""Optimizer classes of the port (``paddle_tpu/optimizer/optimizer.py``):
the base :class:`Optimizer`, :class:`AdamW` and :class:`Momentum`, with
Paddle's argument names.

``step()`` reads each parameter's ``.grad``, clips, and runs the functional
core (:mod:`.functional`) over all of them at once, in place.
:class:`paddle_tpu_torch.jit.TrainStep` runs the same update with the
schedule's ``lr_at(step)``, as the reference's compiled step does. The other
optimizers of the reference, L1/L2 ``weight_decay`` and AdamW's
``lr_ratio`` are not ported yet (ROADMAP.md, Queue 1 item 7).
"""
from __future__ import annotations

import torch

from . import functional as Fopt
from .lr import LRScheduler


class Optimizer:
    """``parameters``: tensors, or ``(name, tensor)`` pairs such as
    ``model.named_parameters()`` (the names feed AdamW's
    ``apply_decay_param_fun``; a bare tensor is named by its index)."""

    def __init__(self, learning_rate=0.001, parameters=None, grad_clip=None, core=None):
        self._lr = learning_rate
        named = [(None, p) if isinstance(p, torch.Tensor) else tuple(p) for p in parameters or ()]
        self._names = [n if n is not None else str(i) for i, (n, _) in enumerate(named)]
        self._params = [p for _, p in named]
        self._grad_clip = grad_clip
        self.core = core
        self._state = None
        self._step_count = 0

    # -- lr ---------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return self._lr

    def set_lr(self, value):
        self._lr = value

    def lr_at(self, step):
        """The learning rate at step ``step``: the schedule's, or the fixed
        rate."""
        if isinstance(self._lr, LRScheduler):
            return self._lr.lr_at(step)
        return self._lr

    # -- update -----------------------------------------------------------
    def _decay_mask(self, live):
        """Per-parameter decay flags of the ``live`` indices, or None."""
        return None

    @torch.no_grad()
    def _apply(self, lr):
        """One update at rate ``lr`` of every parameter that has a gradient;
        advances the step count."""
        live = [i for i, p in enumerate(self._params) if p.grad is not None]
        grads = [self._params[i].grad for i in live]
        if self._grad_clip is not None:
            grads = self._grad_clip.apply_list(grads)
        if self._state is None:
            self._state = self.core.init(self._params)
        sub = {k: [v[i] for i in live] for k, v in self._state.items()}
        self.core.decay_mask = self._decay_mask(live)
        self.core.update(grads, sub, [self._params[i] for i in live], lr, self._step_count)
        self._step_count += 1

    def step(self):
        self._apply(self.get_lr())

    def clear_grad(self):
        for p in self._params:
            p.grad = None

    # -- state dict -------------------------------------------------------
    def state_dict(self):
        out = {"step": self._step_count}
        for k, tensors in (self._state or {}).items():
            for i, v in enumerate(tensors):
                out[f"{k}.{i}"] = v
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state):
        self._step_count = int(state.get("step", 0))
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])
        groups = {}
        for key, v in state.items():
            if key in ("step", "LR_Scheduler"):
                continue
            k, i = key.rsplit(".", 1)
            groups.setdefault(k, {})[int(i)] = v
        if groups:
            self._state = {k: [torch.as_tensor(g[i], device=p.device).float().clone()
                               for i, p in enumerate(self._params)]
                           for k, g in groups.items()}


class AdamW(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, parameters=None,
                 weight_decay=0.01, apply_decay_param_fun=None, grad_clip=None):
        self.apply_decay_param_fun = apply_decay_param_fun
        super().__init__(learning_rate, parameters, grad_clip,
                         core=Fopt.AdamWCore(beta1, beta2, epsilon, float(weight_decay)))

    def _decay_mask(self, live):
        if self.apply_decay_param_fun is None:
            return None
        return [1.0 if self.apply_decay_param_fun(self._names[i]) else 0.0 for i in live]


class Momentum(Optimizer):
    """SGD with momentum (``MomentumCore``), as ``bench_suite.py`` trains
    LeNet and ResNet50. L2 ``weight_decay`` is not ported yet (ROADMAP.md,
    Queue 1 item 7)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None, use_nesterov=False,
                 weight_decay=None, grad_clip=None, name=None, multi_precision=False):
        if weight_decay:
            raise NotImplementedError("Momentum: weight_decay is not ported yet "
                                      "(ROADMAP.md, Queue 1 item 7)")
        super().__init__(learning_rate, parameters, grad_clip,
                         core=Fopt.MomentumCore(momentum, use_nesterov))

"""LR schedulers of the port (``paddle_tpu/optimizer/lr.py``): the base
class and the warm-up + cosine pair of GPT pretraining.

Each scheduler is stateful (``step()``, ``__call__``) for an eager loop, and
``lr_at(step)`` is the same schedule as a pure function of the step count,
which :class:`paddle_tpu_torch.jit.TrainStep` reads. The other schedulers of
the reference are not ported yet (ROADMAP.md, Queue 1 item 7).
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.last_lr = learning_rate
        self.step()

    def get_lr(self):
        raise NotImplementedError

    def lr_at(self, step):
        """The learning rate at step ``step`` (an int), as a float."""
        raise NotImplementedError

    def step(self, epoch=None):
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1
        self.last_lr = self.get_lr()

    def __call__(self):
        return self.last_lr

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]


class LinearWarmup(LRScheduler):
    """Linear from ``start_lr`` to ``end_lr`` over ``warmup_steps``, then
    ``learning_rate`` (a float, or a scheduler run from step 0)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1):
        self.lr_sched = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self.after_lr = learning_rate if not isinstance(learning_rate, LRScheduler) else None
        self.warmup_steps, self.start_lr, self.end_lr = warmup_steps, start_lr, end_lr
        super().__init__(end_lr, last_epoch)

    def get_lr(self):
        t = self.last_epoch
        if t < self.warmup_steps:
            return (self.end_lr - self.start_lr) * t / self.warmup_steps + self.start_lr
        if self.lr_sched is not None:
            self.lr_sched.last_epoch = t - self.warmup_steps
            return self.lr_sched.get_lr()
        return self.after_lr

    def lr_at(self, step):
        if step < self.warmup_steps:
            return (self.end_lr - self.start_lr) * step / self.warmup_steps + self.start_lr
        if self.lr_sched is not None:
            return self.lr_sched.lr_at(step - self.warmup_steps)
        return self.after_lr


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        return self.lr_at(self.last_epoch)

    def lr_at(self, step):
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * step / self.T_max)) / 2

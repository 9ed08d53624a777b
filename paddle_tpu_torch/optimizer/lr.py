"""LR schedulers of the port (``paddle_tpu/optimizer/lr.py``).

Each scheduler is stateful (``step()``, ``__call__``, ``state_dict``) for an
eager loop, and ``lr_at(step)`` is the same schedule as a pure function of
the step count, a Python float, which :class:`paddle_tpu_torch.jit.TrainStep`
reads. The reference evaluates ``lr_at`` in f32 inside its compiled step;
the port in float64 on the host. ``ReduceOnPlateau`` is driven by a metric
on the host, as in the reference; its ``lr_at`` is its current rate.
"""
from __future__ import annotations

import math

import numpy as np


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.last_lr = learning_rate
        self.verbose = verbose
        self.step()

    def get_lr(self):
        raise NotImplementedError

    def lr_at(self, step):
        """The learning rate at step ``step`` (an int), as a float."""
        raise NotImplementedError

    def step(self, epoch=None):
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")

    def __call__(self):
        return self.last_lr

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]


class _StepFunction(LRScheduler):
    """A schedule whose ``get_lr`` is ``lr_at(last_epoch)``."""

    def get_lr(self):
        return self.lr_at(self.last_epoch)


class LinearWarmup(LRScheduler):
    """Linear from ``start_lr`` to ``end_lr`` over ``warmup_steps``, then
    ``learning_rate`` (a float, or a scheduler run from step 0)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1, verbose=False):
        self.lr_sched = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self.after_lr = learning_rate if not isinstance(learning_rate, LRScheduler) else None
        self.warmup_steps, self.start_lr, self.end_lr = warmup_steps, start_lr, end_lr
        super().__init__(end_lr, last_epoch, verbose)

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


class CosineAnnealingDecay(_StepFunction):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1, verbose=False):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * step / self.T_max)) / 2


class NoamDecay(_StepFunction):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1, verbose=False):
        self.d_model, self.warmup_steps = d_model, warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        t = max(step, 1)
        return self.base_lr * self.d_model ** -0.5 * min(t ** -0.5, t * self.warmup_steps ** -1.5)


class PiecewiseDecay(_StepFunction):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries, self.values = list(boundaries), list(values)
        super().__init__(values[0], last_epoch, verbose)

    def lr_at(self, step):
        for b, v in zip(self.boundaries, self.values):
            if step < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(_StepFunction):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * math.exp(-self.gamma * step)


class InverseTimeDecay(_StepFunction):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr / (1 + self.gamma * step)


class PolynomialDecay(_StepFunction):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0, cycle=False,
                 last_epoch=-1, verbose=False):
        self.decay_steps, self.end_lr, self.power, self.cycle = decay_steps, end_lr, power, cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        t = step
        if self.cycle:
            decay_steps = self.decay_steps * max(1.0, math.ceil(t / self.decay_steps))
        else:
            decay_steps = self.decay_steps
            t = min(t, decay_steps)
        return (self.base_lr - self.end_lr) * (1 - t / decay_steps) ** self.power + self.end_lr


class ExponentialDecay(_StepFunction):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.gamma ** step


class MultiStepDecay(_StepFunction):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1, verbose=False):
        self.milestones, self.gamma = list(milestones), gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.gamma ** sum(1 for m in self.milestones if step >= m)


class StepDecay(_StepFunction):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1, verbose=False):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.gamma ** (step // self.step_size)


class LambdaDecay(_StepFunction):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.lr_lambda(step)


class OneCycleLR(_StepFunction):
    """Cosine up from ``max_learning_rate / divide_factor`` to the peak over
    ``phase_pct`` of ``total_steps``, then cosine down to
    ``end_learning_rate``. The reference takes ``anneal_strategy`` and
    ``three_phase`` and ignores them; the port raises on any but their
    defaults."""

    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3, anneal_strategy="cos",
                 three_phase=False, last_epoch=-1, verbose=False):
        if anneal_strategy != "cos" or three_phase:
            raise NotImplementedError(
                "OneCycleLR: only anneal_strategy='cos' and three_phase=False are "
                "implemented (the reference takes both and ignores them)")
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.up_steps = int(phase_pct * total_steps)
        super().__init__(self.initial_lr, last_epoch, verbose)

    def lr_at(self, step):
        if step <= self.up_steps:
            pct = step / max(self.up_steps, 1)
            return self.initial_lr + (self.max_lr - self.initial_lr) * (1 - math.cos(math.pi * pct)) / 2
        pct = min((step - self.up_steps) / max(self.total_steps - self.up_steps, 1), 1.0)
        return self.end_lr + (self.max_lr - self.end_lr) * (1 + math.cos(math.pi * pct)) / 2


class ReduceOnPlateau(LRScheduler):
    """Host-driven: ``step(metrics)`` cuts the rate by ``factor`` after more
    than ``patience`` steps without a gain of ``threshold`` (an absolute
    margin in both ``threshold_mode``s, as in the reference), then waits
    ``cooldown`` steps. ``lr_at(step)`` is the current rate, whatever the
    step."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10, threshold=1e-4,
                 threshold_mode="rel", cooldown=0, min_lr=0, epsilon=1e-8, verbose=False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr = cooldown, min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = learning_rate
        self.last_lr = learning_rate
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def lr_at(self, step):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        cur = float(metrics.item() if hasattr(metrics, "item") else metrics)
        if self.best is None:
            better = True
        elif self.mode == "min":
            better = cur < self.best - self.threshold
        else:
            better = cur > self.best + self.threshold
        if better:
            self.best = cur
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        elif self.num_bad > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0


class MultiplicativeDecay(LRScheduler):
    """``lr_t = lr_{t-1} * lr_lambda(t)``: ``get_lr`` multiplies the factors
    in turn; ``lr_at(step)`` takes their product first, as the reference
    does for a step other than ``last_epoch``."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        lr = self.base_lr
        for t in range(1, self.last_epoch + 1):
            lr *= self.lr_lambda(t)
        return lr

    def lr_at(self, step):
        s = int(step)
        if s == self.last_epoch:
            return self.get_lr()
        return self.base_lr * float(np.prod([self.lr_lambda(t) for t in range(1, s + 1)]))


class CyclicLR(LRScheduler):
    """Between ``base_learning_rate`` and ``max_learning_rate``, up over
    ``step_size_up`` steps and down over ``step_size_down``, scaled per
    ``mode`` (``triangular``, ``triangular2``, ``exp_range``) or by
    ``scale_fn``."""

    def __init__(self, base_learning_rate, max_learning_rate, step_size_up, step_size_down=None,
                 mode="triangular", exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.up = int(step_size_up)
        self.down = int(step_size_down) if step_size_down is not None else self.up
        self.mode = mode
        self.gamma = exp_gamma
        if scale_fn is not None:
            self.scale_fn, self.scale_mode = scale_fn, scale_mode
        elif mode == "triangular":
            self.scale_fn, self.scale_mode = (lambda c: 1.0), "cycle"
        elif mode == "triangular2":
            self.scale_fn, self.scale_mode = (lambda c: 1.0 / (2.0 ** (c - 1))), "cycle"
        elif mode == "exp_range":
            self.scale_fn, self.scale_mode = (lambda it: self.gamma ** it), "iterations"
        else:
            raise ValueError(mode)
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.lr_at(max(self.last_epoch, 0))

    def lr_at(self, step):
        total = self.up + self.down
        cycle = math.floor(1 + step / total)
        it = step - (cycle - 1) * total
        x = it / self.up if it <= self.up else 1.0 - (it - self.up) / self.down
        scale = self.scale_fn(cycle if self.scale_mode == "cycle" else float(step))
        return self.base_lr + (self.max_lr - self.base_lr) * x * scale

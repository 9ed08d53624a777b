"""AMP of the port (``paddle_tpu/amp/__init__.py``; parity: python/paddle/amp,
``auto_cast`` and ``GradScaler``).

``auto_cast`` (``amp_guard``) opens a thread-local scope in which the port's
own functional ops cast their float inputs at their entry by the
reference's lists, letter for letter: an op in :data:`WHITE_LIST` (or the
scope's ``custom_white_list``) runs in the scope's dtype, an op in
:data:`BLACK_LIST` (or ``custom_black_list``) takes inputs of the scope's
dtype up to f32, and an unlisted op keeps the incoming dtype (Paddle's O1
gray list). The reference installs this as a hook in its op dispatcher; the
port has no dispatcher of its own, so each op calls :func:`cast_inputs`
under the reference's op name: ``linear``, ``matmul``, ``bmm``, ``mm``,
``einsum``, ``conv1d``-``conv3d`` and ``sdpa``; ``softmax``,
``log_softmax``, ``cross_entropy``, ``layer_norm``, ``batch_norm``,
``norm``, ``sum``, ``mean``, ``logsumexp``, ``cumsum``, ``exp`` and the
``log``s. ``torch.autocast`` is not used: its op lists are not the
reference's. An op that the reference runs as one primitive (GPT's stacked
trunk, ``gpt_stack``) is unlisted: it runs in :func:`unlisted`, where the
ops inside it cast nothing.

``GradScaler`` is the reference's dynamic loss scaling (Micikevicius et
al. 2018): the loss is multiplied by the scale, ``unscale_`` divides the
gradients by it and reads one found-inf flag (one reduction over all
gradients, one host sync), ``step`` skips the optimizer's update on an
overflow, and ``update`` grows the scale after ``incr_every_n_steps``
clean steps or backs it off after ``decr_every_n_nan_or_inf`` overflowed
ones; the ``amp.loss_scale`` gauge, the ``amp.skipped_steps`` counter and
the ``loss_scale`` and ``bad_step`` run-log events record it. bfloat16
needs no scaling: ``GradScaler(enable=False)`` passes through.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["auto_cast", "amp_guard", "GradScaler", "decorate", "amp_state", "cast_inputs",
           "unlisted", "WHITE_LIST", "BLACK_LIST"]


class _AmpState(threading.local):
    enabled = False
    dtype = "bfloat16"
    level = "O1"
    custom_white_list = None
    custom_black_list = None


_STATE = _AmpState()

# Ops safe to run in low precision, and ops kept in f32 (the reference's,
# which mirror paddle/fluid/imperative/amp_auto_cast.cc).
WHITE_LIST = {"matmul", "linear", "conv1d", "conv2d", "conv3d", "bmm", "mm", "einsum",
              "flash_attention", "sdpa"}
BLACK_LIST = {"exp", "log", "log2", "log10", "mean", "sum", "softmax", "log_softmax",
              "cross_entropy", "layer_norm", "batch_norm", "norm", "logsumexp", "cumsum"}


def amp_state():
    """This thread's AMP state: ``enabled``, ``dtype``, ``level`` and the
    custom lists."""
    return _STATE


def _snapshot():
    return (_STATE.enabled, _STATE.dtype, _STATE.level, _STATE.custom_white_list,
            _STATE.custom_black_list)


def _restore(snap):
    (_STATE.enabled, _STATE.dtype, _STATE.level, _STATE.custom_white_list,
     _STATE.custom_black_list) = snap


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None, level="O1",
              dtype="bfloat16"):
    """The AMP scope (see the module's docstring); the previous state comes
    back on leaving."""
    prev = _snapshot()
    _restore((bool(enable), str(dtype).replace("torch.", ""), level,
              set(custom_white_list) if custom_white_list else None,
              set(custom_black_list) if custom_black_list else None))
    try:
        yield
    finally:
        _restore(prev)


amp_guard = auto_cast


@contextlib.contextmanager
def restored(snap):
    """A scope with the AMP state ``snap`` (``_snapshot()``), as a
    recompute replays the forward's."""
    prev = _snapshot()
    _restore(snap)
    try:
        yield
    finally:
        _restore(prev)


def unlisted():
    """The scope of an op that the reference runs as one unlisted primitive:
    its inputs keep their dtype and the ops inside it cast nothing."""
    return restored((False,) + _snapshot()[1:])


def maybe_cast_inputs(op_name, vals):
    """``vals`` cast for the op ``op_name`` by the active scope's lists (as
    the reference's dispatcher hook); non-tensors and non-float tensors
    pass unchanged."""
    if not _STATE.enabled:
        return list(vals)
    white = WHITE_LIST | (_STATE.custom_white_list or set())
    black = BLACK_LIST | (_STATE.custom_black_list or set())
    dt = getattr(torch, _STATE.dtype)
    if op_name in white:
        return [v.to(dt) if isinstance(v, torch.Tensor) and v.is_floating_point() and v.dtype != dt
                else v for v in vals]
    if op_name in black:
        return [v.float() if isinstance(v, torch.Tensor) and v.dtype == dt else v for v in vals]
    return list(vals)


def cast_inputs(op_name, *vals):
    """:func:`maybe_cast_inputs` for the inputs of one op call, as a tuple
    (the inputs themselves outside a scope)."""
    if not _STATE.enabled:
        return vals
    return tuple(maybe_cast_inputs(op_name, vals))


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16", master_weight=None,
             save_dtype=None):
    """O2's model cast (the reference's): every model's parameters and
    buffers to ``dtype``; returns ``models``, or ``(models, optimizers)``."""
    if models is not None:
        for m in models if isinstance(models, (list, tuple)) else [models]:
            m.to(getattr(torch, str(dtype).replace("torch.", "")))
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (parity: python/paddle/amp/grad_scaler.py:26).
    ``enable=False`` passes through (bfloat16 needs no scaling)."""

    def __init__(self, enable=True, init_loss_scaling=2.0**15, incr_ratio=2.0, decr_ratio=0.5,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = init_loss_scaling
        self._incr_ratio, self._decr_ratio = incr_ratio, decr_ratio
        self._incr_every, self._decr_every = incr_every_n_steps, decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        self._host_step = 0
        if enable:
            from ..observability.metrics import gauge_set

            gauge_set("amp.loss_scale", float(self._scale))

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient of ``optimizer`` by the scale in place and
        read whether any is non-finite: one reduction over them all on the
        device, one host sync."""
        if not self._enable:
            return
        if self._unscaled:
            raise RuntimeError("unscale_() has already been called on this optimizer since the "
                               "last update()")
        inv = 1.0 / self._scale
        grads = [p.grad for p in optimizer._params if p.grad is not None]
        if grads:
            torch._foreach_mul_(grads, inv)
            finite = torch.stack([torch.isfinite(g).all() for g in grads])
            self._found_inf = not bool(finite.all())
        else:
            self._found_inf = False
        self._unscaled = True

    def step(self, optimizer):
        """The optimizer's step on the unscaled gradients, skipped when one
        is non-finite; then :meth:`update`."""
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        self._host_step += 1
        if not self._found_inf:
            optimizer.step()
        else:
            from ..observability import runlog
            from ..observability.metrics import counter_inc

            counter_inc("amp.skipped_steps")
            runlog.emit("bad_step", step=self._host_step, component="amp",
                        loss_scale=float(self._scale))
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        """The dynamic scale's move after a step (see the module's
        docstring)."""
        self._unscaled = False
        if not (self._enable and self._dynamic):
            return
        prev, reason = self._scale, None
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
                reason = "backoff"
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
                reason = "grow"
        if reason is not None:
            from ..observability import runlog
            from ..observability.metrics import gauge_set

            gauge_set("amp.loss_scale", float(self._scale))
            runlog.emit("loss_scale", step=self._host_step, reason=reason,
                        value=float(self._scale), prev=float(prev))

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def set_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state["good_steps"]
        self._bad_steps = state["bad_steps"]

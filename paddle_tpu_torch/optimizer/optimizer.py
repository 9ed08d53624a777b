"""Optimizer classes of the port (``paddle_tpu/optimizer/optimizer.py``), with
Paddle's argument names: ``SGD``, ``Momentum``, ``Adam``, ``RowSparseAdam``,
``AdamW``, ``Lamb``, ``Adagrad``, ``RMSProp``, ``Adadelta``, ``Adamax``.

Two update paths, as in the reference, each the reference's order:

- the eager ``step()``: clip, then the L1/L2 penalty, then the functional
  core (:mod:`.functional`) over every parameter with a gradient, except
  that a lazy optimizer (``SGD``, ``Adam(lazy_mode=True)``,
  ``RowSparseAdam``) updates only the recorded rows of a parameter that
  has some (``Embedding(sparse=True)``, ``ShardedEmbedding``); laziness is
  off under a clip or a decay;
- :meth:`Optimizer._traced_update`, which
  :class:`paddle_tpu_torch.jit.TrainStep` runs at the schedule's
  ``lr_at(step)``: the penalty, then the clip, then the core, with the
  model's parameter names as the core's keys.

``weight_decay`` is a float (L2), ``L2Decay`` or ``L1Decay``: the gradient
gains ``coeff * p`` or ``coeff * sign(p)``. ``AdamW`` decays decoupled, in
its core.

Under ZeRO (``TrainStep`` over a fleet grid with sharding) the optimizer
carries the step's :class:`~paddle_tpu_torch.distributed.sharding.ZeroPlan`
in ``_shards``: ``_traced_update`` then updates each parameter's block
with its block of the averaged gradient, and the state covers the blocks
only. A norm (Lamb's trust ratio, a clip) sums the squares over the groups
that hold the rest of a parameter (:func:`paddle_tpu_torch.nn.clip.norm_groups`).
"""
from __future__ import annotations

import torch

from ..framework.selected_rows import take_pending_rows
from ..regularizer import L1Decay
from . import functional as Fopt
from .lr import LRScheduler


class Optimizer:
    """``parameters``: tensors, or ``(name, tensor)`` pairs such as
    ``model.named_parameters()`` (the names feed AdamW's
    ``apply_decay_param_fun``; a bare tensor is named by its index)."""

    # update only the recorded rows of a row-sparse gradient in step()
    _lazy_sparse = False
    # the core's update takes the parameters' names (``keys=``)
    _keyed_core = False
    # weight decay is the core's own (AdamW), not a gradient penalty
    _decoupled_decay = False

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None, grad_clip=None,
                 core=None):
        self._lr = learning_rate
        named = [(None, p) if isinstance(p, torch.Tensor) else tuple(p) for p in parameters or ()]
        self._names = [n if n is not None else str(i) for i, (n, _) in enumerate(named)]
        self._params = [p for _, p in named]
        self._grad_clip = grad_clip
        self._wd_is_l1 = isinstance(weight_decay, L1Decay)
        self._weight_decay = float(weight_decay) if weight_decay is not None else None
        self.core = core if core is not None else Fopt.SGDCore()
        self._state = None
        self._step_count = 0
        self._shards = None  # a ZeroPlan: the core updates blocks

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

    def _target(self, i):
        """What the core updates for parameter ``i``: the parameter, or its
        ZeRO block."""
        p = self._params[i]
        return p if self._shards is None else self._shards.local(p)

    def _penalized(self, grads, live):
        """``grads`` plus the L1/L2 penalty of their parameters."""
        if not self._weight_decay or self._decoupled_decay:
            return grads
        wd = self._weight_decay
        pen = torch.sign if self._wd_is_l1 else (lambda p: p)
        return [g + wd * pen(self._target(i)) for g, i in zip(grads, live)]

    def _ensure_state(self):
        """The core's state over every parameter (its ZeRO block), made at
        zero if no update made it yet."""
        if self._state is None:
            self._state = self.core.init([self._target(i) for i in range(len(self._params))])

    def _core_update(self, grads, live, lr, keys=None):
        """The core's update of the parameters ``live`` (indices) at ``lr``."""
        if not live:
            return
        self._ensure_state()
        sub = {k: [v[i] for i in live] for k, v in self._state.items()}
        self.core.decay_mask = self._decay_mask(live)
        kw = {"keys": keys} if self._keyed_core else {}
        self.core.update(grads, sub, [self._target(i) for i in live], lr, self._step_count, **kw)

    @torch.no_grad()
    def step(self):
        """The eager update at ``get_lr()``: clip, penalty, then the core
        over the dense gradients and ``row_update`` over the recorded rows;
        advances the step count."""
        live = [i for i, p in enumerate(self._params) if p.grad is not None]
        grads = dict(zip(live, (self._params[i].grad for i in live)))
        if self._grad_clip is not None:
            grads = dict(zip(live, self._clip(list(grads.values()), live)))
        lazy = (self._lazy_sparse and hasattr(self.core, "row_update")
                and self._grad_clip is None and not self._weight_decay)
        sparse = {}
        for i, p in enumerate(self._params):
            rows = take_pending_rows(p)  # always drained: stale rows must not leak
            if rows is not None and lazy and i in grads:
                sparse[i] = rows
        dense = [i for i in live if i not in sparse]
        lr = self.get_lr()
        self._core_update(self._penalized([grads[i] for i in dense], dense), dense, lr)
        if sparse and self._state is None:
            self._state = self.core.init(self._params)
        for i, rows in sparse.items():
            p = self._params[i]
            rows = rows.to(p.device)
            state_p = {k: v[i] for k, v in (self._state or {}).items()}
            self.core.row_update(rows, grads[i][rows], state_p, p, lr, self._step_count)
        self._step_count += 1

    def _clip(self, grads, live):
        """The clip of ``grads`` (of the parameters ``live``); over a sharded
        model the clip takes the parameters too, for whole norms."""
        from ..nn.clip import _shard_groups

        params = [self._params[i] for i in live]
        if _shard_groups(params) is not None:
            return self._grad_clip.apply_list(grads, params=params)
        return self._grad_clip.apply_list(grads)

    @torch.no_grad()
    def _traced_update(self, lr, keys_by_param=None):
        """The compiled step's update at ``lr``: penalty, clip, then the core
        over every parameter with a gradient; ``keys_by_param`` maps a
        parameter's ``id`` to its name in the model (the core's keys; the
        optimizer's own name where it has none). Advances the step count."""
        grad_of = (lambda p: p.grad) if self._shards is None else self._shards.grad
        live = [i for i, p in enumerate(self._params) if grad_of(p) is not None]
        grads = self._penalized([grad_of(self._params[i]) for i in live], live)
        if self._grad_clip is not None:
            grads = self._clip(grads, live)
        keys_by_param = keys_by_param or {}
        keys = [keys_by_param.get(id(self._params[i]), self._names[i]) for i in live]
        self._core_update(grads, live, lr, keys)
        self._step_count += 1

    def clear_grad(self, set_to_zero=True):
        for p in self._params:
            p.grad = None
            take_pending_rows(p)  # drop rows recorded without a step

    clear_gradients = clear_grad

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
            self._state = {k: [torch.as_tensor(g[i]).to(p.device, Fopt._acc_dtype(p.dtype), copy=True)
                               for i, p in enumerate(self._params)]
                           for k, g in groups.items()}


class SGD(Optimizer):
    """Always lazy over recorded rows: a row-sparse SGD step equals the
    dense one (the reference's selected-rows SGD)."""

    _lazy_sparse = True

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, core=Fopt.SGDCore())


class Momentum(Optimizer):
    """SGD with momentum (``MomentumCore``), as ``bench_suite.py`` trains
    LeNet and ResNet50."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None, use_nesterov=False,
                 weight_decay=None, grad_clip=None, name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         core=Fopt.MomentumCore(momentum, use_nesterov))


class Adam(Optimizer):
    """``lazy_mode=True``: a parameter with recorded rows updates only those
    rows in ``step()`` (the reference's ``adam_op.h`` lazy branch)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, parameters=None,
                 weight_decay=None, grad_clip=None, lazy_mode=False, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         core=Fopt.AdamCore(beta1, beta2, epsilon))
        self._lazy_sparse = bool(lazy_mode)


class RowSparseAdam(Optimizer):
    """Adam whose ``TrainStep`` update is row-sparse for the parameters
    named in ``sparse_params`` (the model's ``named_parameters`` names,
    e.g. ``DLRM.sparse_param_names()``): a row whose gradient is all zero
    keeps its parameters and moments bitwise. ``step()`` is the lazy
    ``Adam(lazy_mode=True)`` path over the rows the layers recorded.

    ``weight_decay`` is refused: decay writes every table row every step,
    which defeats the row-sparse contract."""

    _lazy_sparse = True
    _keyed_core = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, parameters=None,
                 sparse_params=(), weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if weight_decay:
            raise ValueError(
                "RowSparseAdam does not support weight_decay: decay writes "
                "every table row every step, defeating the row-sparse "
                "update contract")
        super().__init__(learning_rate, parameters, None, grad_clip,
                         core=Fopt.RowSparseAdamCore(beta1, beta2, epsilon, sparse=sparse_params))


class AdamW(Optimizer):
    _decoupled_decay = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, parameters=None,
                 weight_decay=0.01, apply_decay_param_fun=None, grad_clip=None, lr_ratio=None,
                 name=None, multi_precision=False):
        if lr_ratio is not None:
            raise NotImplementedError("AdamW: lr_ratio is not implemented "
                                      "(the reference takes it and ignores it)")
        self.apply_decay_param_fun = apply_decay_param_fun
        super().__init__(learning_rate, parameters, None, grad_clip,
                         core=Fopt.AdamWCore(beta1, beta2, epsilon, float(weight_decay)))

    def _decay_mask(self, live):
        if self.apply_decay_param_fun is None:
            return None
        return [1.0 if self.apply_decay_param_fun(self._names[i]) else 0.0 for i in live]


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, parameters=None, grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        if exclude_from_weight_decay_fn is not None:
            raise NotImplementedError("Lamb: exclude_from_weight_decay_fn is not implemented "
                                      "(the reference takes it and ignores it)")
        super().__init__(learning_rate, parameters, None, grad_clip,
                         core=Fopt.LambCore(beta1, beta2, epsilon, lamb_weight_decay))

    def _core_update(self, grads, live, lr, keys=None):
        """The trust ratio takes each parameter's whole norms: over a sharded
        model the squares are summed over the groups holding the rest."""
        from ..nn.clip import _reduce_terms, norm_groups

        groups = [norm_groups(self._params[i], whole_param=True) for i in live]
        self.core.whole_sq = None if not any(groups) else [
            (lambda sq, gs=gs: _reduce_terms([sq], [gs])) if gs else None for gs in groups]
        super()._core_update(grads, live, lr, keys)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         core=Fopt.AdagradCore(epsilon, initial_accumulator_value))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         core=Fopt.RMSPropCore(rho, epsilon, momentum, centered))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         core=Fopt.AdadeltaCore(rho, epsilon))


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         core=Fopt.AdamaxCore(beta1, beta2, epsilon))

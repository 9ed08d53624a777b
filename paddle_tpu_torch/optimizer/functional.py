"""Functional optimizer cores of the port (``paddle_tpu/optimizer/functional.py``):
``init(params) -> state`` and ``update(grads, state, params, lr, step)``.

The reference's update is pure over a pytree; here ``params``, ``grads`` and
the state's moments are lists of tensors, and ``update`` writes the new
parameters and moments IN PLACE (``torch._foreach_*``) and returns them.
Moments are f32 whatever the parameter dtype. It is jnp in the reference,
not a Pallas kernel, so it is plain PyTorch here.
"""
from __future__ import annotations

import torch


class MomentumCore:
    """``v = mu v + g``, then ``p -= lr v``, or with Nesterov ``p -= lr (g +
    mu v)``; the velocity is f32."""

    def __init__(self, momentum=0.9, use_nesterov=False):
        self.mu = momentum
        self.nesterov = use_nesterov

    def init(self, params):
        return {"velocity": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

    def update(self, grads, state, params, lr, step):
        g = [x.float() for x in grads]
        v = state["velocity"]
        torch._foreach_mul_(v, self.mu)
        torch._foreach_add_(v, g)
        step_dir = torch._foreach_add(g, v, alpha=self.mu) if self.nesterov else v
        for p, u in zip(params, torch._foreach_mul(step_dir, lr)):
            p.sub_(u.to(p.dtype))
        return params, state


class AdamCore:
    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def init(self, params):
        return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "v": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

    def _moments(self, grads, state):
        """m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2, in place."""
        g = [x.float() for x in grads]
        m, v = state["m"], state["v"]
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, g, alpha=1 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - self.b2)
        return m, v

    def _step_sizes(self, m, v, lr, step):
        """lr (m / bc1) / (sqrt(v / bc2) + eps) with t = step + 1, in f32."""
        t = step + 1
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, denom)
        return upd

    def update(self, grads, state, params, lr, step):
        m, v = self._moments(grads, state)
        for p, u in zip(params, self._step_sizes(m, v, lr, step)):
            p.sub_(u.to(p.dtype))
        return params, state


class AdamWCore(AdamCore):
    """Adam with decoupled weight decay, ``p (1 - lr wd mask)`` before the
    Adam step. ``decay_mask`` is a list of 0/1 (one per parameter) or None
    (decay all): the reference's ``apply_decay_param_fun``."""

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.01, decay_mask=None):
        super().__init__(beta1, beta2, epsilon)
        self.wd = weight_decay
        self.decay_mask = decay_mask

    def update(self, grads, state, params, lr, step):
        m, v = self._moments(grads, state)
        mask = self.decay_mask if self.decay_mask is not None else [1.0] * len(params)
        for p, u, decay in zip(params, self._step_sizes(m, v, lr, step), mask):
            p.mul_(1.0 - lr * self.wd * float(decay))
            p.sub_(u.to(p.dtype))
        return params, state

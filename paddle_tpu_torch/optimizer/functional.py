"""Functional optimizer cores of the port (``paddle_tpu/optimizer/functional.py``):
``init(params) -> state`` and ``update(grads, state, params, lr, step)``.

The reference's update is pure over a pytree; here ``params``, ``grads`` and
the state's tensors are lists, and ``update`` writes the new parameters and
state IN PLACE (``torch._foreach_*``, or a loop of in-place ops) and returns
them. State and update arithmetic are f32 for a bf16, f16 or f32 parameter
and float64 for a float64 one. ``row_update(rows,
g_rows, state_p, p, lr, step)`` updates only the rows ``rows`` of one
parameter (the eager lazy path). It is jnp in the reference, not a Pallas
kernel, so it is plain PyTorch here.
"""
from __future__ import annotations

import torch


def _acc_dtype(dtype):
    """The state's dtype for a parameter of ``dtype``: f32, or float64."""
    return torch.promote_types(dtype, torch.float32)


def _acc(t):
    """``t`` in its state dtype (itself when it is f32 or float64)."""
    return t.to(_acc_dtype(t.dtype))


def _zeros(params):
    return [torch.zeros_like(p, dtype=_acc_dtype(p.dtype)) for p in params]


class SGDCore:
    """``p -= lr g``."""

    def init(self, params):
        return {}

    def update(self, grads, state, params, lr, step):
        for p, g in zip(params, grads):
            p.sub_(lr * g.to(p.dtype))
        return params, state

    def row_update(self, rows, g_rows, state_p, p, lr, step):
        """Only the rows ``rows`` (unique) change (the reference's
        selected-rows SGD)."""
        p[rows] = p[rows] + (-lr * g_rows).to(p.dtype)
        return p, state_p


class MomentumCore:
    """``v = mu v + g``, then ``p -= lr v``, or with Nesterov ``p -= lr (g +
    mu v)``."""

    def __init__(self, momentum=0.9, use_nesterov=False):
        self.mu = momentum
        self.nesterov = use_nesterov

    def init(self, params):
        return {"velocity": _zeros(params)}

    def update(self, grads, state, params, lr, step):
        g = [_acc(x) for x in grads]
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
        return {"m": _zeros(params), "v": _zeros(params)}

    def _moments(self, grads, state):
        """m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2, in place."""
        g = [_acc(x) for x in grads]
        m, v = state["m"], state["v"]
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, g, alpha=1 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - self.b2)
        return m, v

    def _corrections(self, step):
        t = step + 1
        return 1 - self.b1 ** t, 1 - self.b2 ** t

    def _step_sizes(self, m, v, lr, step):
        """lr (m / bc1) / (sqrt(v / bc2) + eps) with t = step + 1, in the
        state's dtype."""
        bc1, bc2 = self._corrections(step)
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

    def row_update(self, rows, g_rows, state_p, p, lr, step):
        """Lazy-mode Adam (the reference's ``adam_op.h`` lazy branch): the
        moments and parameters of the rows ``rows`` (unique) update; every
        other row keeps its moments undecayed."""
        m, v = state_p["m"], state_p["v"]
        g = g_rows.to(m.dtype)
        m_r = self.b1 * m[rows] + (1 - self.b1) * g
        v_r = self.b2 * v[rows] + (1 - self.b2) * g.square()
        bc1, bc2 = self._corrections(step)
        p[rows] = p[rows] + (-(lr * (m_r / bc1) / ((v_r / bc2).sqrt() + self.eps))).to(p.dtype)
        m[rows] = m_r
        v[rows] = v_r
        return p, state_p


class RowSparseAdamCore(AdamCore):
    """Adam whose update is row-sparse for the parameters named in
    ``sparse``: a row whose gradient is all zero this step keeps its
    parameters AND moments bitwise (no moment decay), every other parameter
    takes the dense Adam step. ``update`` matches names through ``keys``
    (one per parameter): ``TrainStep`` passes the model's
    ``named_parameters`` names, as the reference's compiled step keys its
    state; the eager ``step()`` passes none, as the reference's eager state
    is keyed by index and never matches (its lazy rows come from
    :func:`~paddle_tpu_torch.framework.selected_rows.record_rows`).

    The masked update is elementwise over the whole table (``torch.where``
    chains), as the reference's."""

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8, sparse=()):
        super().__init__(beta1, beta2, epsilon)
        self.sparse = frozenset(sparse)

    def _masked_update(self, g, m, v, p, lr, step):
        """The update of one table, in place."""
        if g.ndim == 1:
            touched = g != 0
        else:
            touched = (g != 0).reshape(g.shape[0], -1).any(dim=1)
            touched = touched.reshape((-1,) + (1,) * (g.ndim - 1))
        g = g.to(m.dtype)
        m_new = torch.where(touched, self.b1 * m + (1 - self.b1) * g, m)
        v_new = torch.where(touched, self.b2 * v + (1 - self.b2) * g.square(), v)
        bc1, bc2 = self._corrections(step)
        upd = (lr * (m_new / bc1) / ((v_new / bc2).sqrt() + self.eps)).to(p.dtype)
        p.copy_(torch.where(touched, p - upd, p))
        m.copy_(m_new)
        v.copy_(v_new)

    def update(self, grads, state, params, lr, step, keys=None):
        lazy = [k in self.sparse for k in keys] if keys is not None else [False] * len(params)
        dense = [i for i, s in enumerate(lazy) if not s]
        if dense:
            super().update([grads[i] for i in dense],
                           {k: [state[k][i] for i in dense] for k in ("m", "v")},
                           [params[i] for i in dense], lr, step)
        for i in (i for i, s in enumerate(lazy) if s):
            self._masked_update(grads[i], state["m"][i], state["v"][i], params[i], lr, step)
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


class LambCore(AdamCore):
    """Layer-wise adaptive rates: ``r = m^ / (sqrt(v^) + eps) + wd p``, each
    parameter's step scaled by ``||p|| / ||r||`` (1 where either is 0).
    ``whole_sq`` (None, or one function per parameter) turns the sum of
    squares of a parameter's piece into its whole parameter's."""

    whole_sq = None

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-6, lamb_weight_decay=0.01):
        super().__init__(beta1, beta2, epsilon)
        self.wd = lamb_weight_decay

    def update(self, grads, state, params, lr, step):
        m, v = self._moments(grads, state)
        bc1, bc2 = self._corrections(step)
        whole = self.whole_sq or [None] * len(params)
        for p, mm, vv, sq in zip(params, m, v, whole):
            r = (mm / bc1) / ((vv / bc2).sqrt() + self.eps) + self.wd * p
            if sq is None:
                w_norm = torch.linalg.vector_norm(_acc(p))
                r_norm = torch.linalg.vector_norm(_acc(r))
            else:
                w_norm = torch.sqrt(sq(_acc(p).square().sum()))
                r_norm = torch.sqrt(sq(_acc(r).square().sum()))
            trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
            p.sub_((lr * trust * r).to(p.dtype))
        return params, state


class AdagradCore:
    """``a += g^2``, ``p -= lr g / (sqrt(a) + eps)``."""

    def __init__(self, epsilon=1e-6, initial_accumulator_value=0.0):
        self.eps = epsilon
        self.init_acc = initial_accumulator_value

    def init(self, params):
        return {"moment": [torch.full_like(p, self.init_acc, dtype=_acc_dtype(p.dtype))
                           for p in params]}

    def update(self, grads, state, params, lr, step):
        for p, g, a in zip(params, grads, state["moment"]):
            g = _acc(g)
            a.add_(g.square())
            p.sub_((lr * g / (a.sqrt() + self.eps)).to(p.dtype))
        return params, state


class RMSPropCore:
    """``s = rho s + (1 - rho) g^2``; centered, also ``mg = rho mg + (1 -
    rho) g`` and the denominator ``sqrt(s - mg^2 + eps)``, else ``sqrt(s +
    eps)``; ``mom = mu mom + lr g / denom``, ``p -= mom``."""

    def __init__(self, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False):
        self.rho, self.eps, self.mu, self.centered = rho, epsilon, momentum, centered

    def init(self, params):
        state = {"mean_square": _zeros(params), "moment": _zeros(params)}
        if self.centered:
            state["mean_grad"] = _zeros(params)
        return state

    def update(self, grads, state, params, lr, step):
        for i, (p, g) in enumerate(zip(params, grads)):
            g = _acc(g)
            ms, mom = state["mean_square"][i], state["moment"][i]
            ms.copy_(self.rho * ms + (1 - self.rho) * g.square())
            if self.centered:
                mg = state["mean_grad"][i]
                mg.copy_(self.rho * mg + (1 - self.rho) * g)
                denom = (ms - mg.square() + self.eps).sqrt()
            else:
                denom = (ms + self.eps).sqrt()
            mom.copy_(self.mu * mom + lr * g / denom)
            p.sub_(mom.to(p.dtype))
        return params, state


class AdadeltaCore:
    """``a = rho a + (1 - rho) g^2``, ``d = g sqrt(u + eps) / sqrt(a + eps)``,
    ``u = rho u + (1 - rho) d^2``, ``p -= lr d``."""

    def __init__(self, rho=0.95, epsilon=1e-6):
        self.rho, self.eps = rho, epsilon

    def init(self, params):
        return {"avg_sq_grad": _zeros(params), "avg_sq_update": _zeros(params)}

    def update(self, grads, state, params, lr, step):
        for p, g, a, u in zip(params, grads, state["avg_sq_grad"], state["avg_sq_update"]):
            g = _acc(g)
            a.copy_(self.rho * a + (1 - self.rho) * g.square())
            d = g * (u + self.eps).sqrt() / (a + self.eps).sqrt()
            u.copy_(self.rho * u + (1 - self.rho) * d.square())
            p.sub_((lr * d).to(p.dtype))
        return params, state


class AdamaxCore:
    """``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g|)``, ``p -= lr / (1 -
    b1^t) m / (u + eps)``."""

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def init(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    def update(self, grads, state, params, lr, step):
        bc1 = 1 - self.b1 ** (step + 1)
        for p, g, m, u in zip(params, grads, state["m"], state["u"]):
            g = _acc(g)
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            u.copy_(torch.maximum(self.b2 * u, g.abs()))
            p.sub_((lr / bc1 * m / (u + self.eps)).to(p.dtype))
        return params, state

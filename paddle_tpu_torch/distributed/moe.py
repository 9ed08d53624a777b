"""Mixture of experts (``paddle_tpu/distributed/moe.py``): the Naive,
GShard and Switch gates, the ``dense`` dispatch/combine composite and
:class:`MoELayer`.

Routing (gate scores, top-k, GShard's random second-expert jitter, capacity
dropping, the aux loss) happens here; the dispatch / expert FFN / combine
core goes through the ``moe`` registry kernel: ``pallas_sorted``
(:mod:`paddle_tpu_torch.ops.moe_pallas`, the CUDA kernels K4/K4b on the
card) where it takes the call, else the ``dense`` fallback below. The
reference's expert sharding (``expert_axis``) annotates a mesh the port
does not have yet, so it is not carried.

The jitter draws from a ``torch.Generator`` that the layer owns, seeded at
construction (``MoELayer.seed``), not from a global key: re-seeding it
(``layer.generator.manual_seed(layer.seed)``) repeats the routing. Under
activation recompute, :func:`routing_replay` makes the recompute draw what
the forward drew.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..framework.device import resolve_device
from ..ops import moe_pallas as _moe_pallas  # registers 'pallas_sorted'
from ..ops import registry as _registry

__all__ = ["NaiveGate", "GShardGate", "SwitchGate", "MoELayer", "dense_dispatch_combine",
           "routing_replay"]


def _xavier_normal(shape, generator, device):
    """The reference's ``XavierNormal``: std ``sqrt(2 / (fan_in + fan_out))``
    with its fans (``[in, out]`` for 2-D, ``[out, in, *k]`` beyond)."""
    if len(shape) == 2:
        fan_in, fan_out = shape
    else:
        receptive = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.empty(shape, device=device).normal_(0.0, std, generator=generator)


class NaiveGate(nn.Module):
    """Linear scores + top-k. No jitter, no aux loss, no capacity opinion
    (``capacity = None`` defers to the layer)."""

    capacity = None
    random_routing = False

    def __init__(self, d_model, num_expert, world_size=1, topk=2, *, device=None, generator=None):
        super().__init__()
        self.topk = topk
        self.num_expert = num_expert
        self.weight = nn.Parameter(_xavier_normal((d_model, num_expert), generator,
                                                  resolve_device(device)))

    def score(self, x):
        return x @ self.weight

    @staticmethod
    def aux_loss(probs, gate_idx, num_expert):
        return torch.zeros((), dtype=probs.dtype, device=probs.device)


class GShardGate(NaiveGate):
    """Top-2 with random second-expert jitter + the GShard load-balance aux
    loss. ``capacity`` is the (train, eval) capacity-factor pair; in
    training ``random_routing`` keeps each token's second expert with
    probability ``min(1, 2·p2)``, and a dropped pair is not dispatched."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2, capacity=(1.2, 2.4),
                 random_routing=True, *, device=None, generator=None):
        super().__init__(d_model, num_expert, world_size, topk, device=device, generator=generator)
        self.capacity = tuple(capacity)
        self.random_routing = bool(random_routing)

    @staticmethod
    def aux_loss(probs, gate_idx, num_expert):
        # GShard eq. 4: mean gate prob * top-1 dispatch fraction, scaled by E
        me = probs.mean(dim=0)
        ce = F.one_hot(gate_idx[:, 0], num_expert).to(probs.dtype).mean(dim=0)
        return num_expert * (me * ce).sum()


class SwitchGate(NaiveGate):
    """Top-1 routing; the Switch-Transformer aux loss (GShard's form over
    the top-1 assignment)."""

    def __init__(self, d_model, num_expert, world_size=1, topk=1, capacity=(1.2, 2.4), *,
                 device=None, generator=None):
        super().__init__(d_model, num_expert, world_size, topk, device=device, generator=generator)
        self.capacity = tuple(capacity)

    aux_loss = staticmethod(GShardGate.aux_loss)


def dense_dispatch_combine(tokens, gate_vals, gate_idx, drop_mask, w1, b1, w2, b2, *, capacity,
                           activation):
    """The GShard/Switch dense composite: one-hot + cumsum queue positions,
    padded ``[E, capacity, D]`` dispatch einsums, gather combine. The
    registry's ``moe`` fallback: always available, and the plain reference
    the ``pallas_sorted`` path is held against."""
    T, D = tokens.shape
    E = w1.shape[0]
    K = gate_idx.shape[1]
    act = {"gelu": lambda x: F.gelu(x, approximate="tanh"), "relu": F.relu,
           "silu": F.silu}[activation]

    flat_idx = gate_idx.reshape(-1).long()  # [T*K] expert ids (k-major per token)
    onehot = F.one_hot(flat_idx, E)  # [T*K, E]
    if drop_mask is not None:
        # jitter-dropped pairs are not dispatched and consume no capacity
        onehot = onehot * (~drop_mask.reshape(-1)).long()[:, None]
    pos_in_expert = torch.cumsum(onehot, dim=0) - 1  # rank within expert
    pos = (pos_in_expert * onehot).sum(dim=-1)  # [T*K]
    keep = pos < capacity
    if drop_mask is not None:
        keep = keep & ~drop_mask.reshape(-1)
    gv = gate_vals.reshape(-1) * keep.to(gate_vals.dtype)

    tok_rep = torch.arange(T, device=tokens.device).repeat_interleave(K)
    e_ids = torch.where(keep, flat_idx, torch.zeros_like(flat_idx))
    p_ids = torch.where(keep, pos, torch.zeros_like(pos))
    contrib = tokens[tok_rep] * keep[:, None].to(tokens.dtype)
    disp = torch.zeros((E, capacity, D), dtype=tokens.dtype, device=tokens.device)
    disp = disp.index_put((e_ids, p_ids), contrib, accumulate=True)

    h = act(torch.einsum("ecd,edh->ech", disp, w1) + b1)
    y = torch.einsum("ech,ehd->ecd", h, w2) + b2

    gathered = y[e_ids, p_ids]  # [T*K, D]
    combined = torch.zeros((T, D), dtype=y.dtype, device=y.device)
    return combined.index_add(0, tok_rep, gathered * gv[:, None])


_registry.register(
    "moe", "dense", dense_dispatch_combine, fallback=True,
    doc="one-hot/cumsum dispatch + padded [E, capacity, D] einsums (plain PyTorch composite)")


def jitter_drop_mask(gate_vals, generator):
    """GShard random routing: ``[T, K]`` bool, True where a pair is not
    dispatched. Each token keeps its second expert with probability
    ``min(1, 2·p2)`` (the reference's ``2*topk_val > rand`` test); the
    other ranks always dispatch."""
    n_tok, K = gate_vals.shape
    r = torch.rand(n_tok, generator=generator, device=gate_vals.device, dtype=gate_vals.dtype)
    drop = torch.zeros((n_tok, K), dtype=torch.bool, device=gate_vals.device)
    drop[:, 1] = 2.0 * gate_vals[:, 1].detach() <= r
    return drop


class MoELayer(nn.Module):
    """Expert FFN mixture: stacked expert weights ``w1 [E, D, H]``,
    ``b1 [E, 1, H]``, ``w2 [E, H, D]``, ``b2 [E, 1, D]`` and a gate
    (``'naive' | 'gshard' | 'switch'``).

    ``capacity_factor``: an explicit per-expert capacity factor; ``None``
    takes the gate's (train, eval) pair. ``activation``: ``'gelu'`` (tanh
    form), ``'relu'`` or ``'silu'``. ``device`` as the port's entry points;
    ``generator`` draws the initial weights (a fresh one seeded ``seed``
    when None); ``seed`` seeds the layer's own routing generator. After a
    forward, ``aux_loss`` holds the gate's load-balancing loss."""

    def __init__(self, d_model, d_hidden, num_experts, top_k=2, capacity_factor=None,
                 gate="gshard", activation="gelu", *, device=None, generator=None, seed=0):
        super().__init__()
        if activation not in _moe_pallas.ACTIVATIONS:
            raise ValueError(f"activation must be one of {_moe_pallas.ACTIVATIONS}, "
                             f"got {activation!r}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(int(seed))
        self.num_experts = num_experts
        self.top_k = 1 if gate == "switch" else top_k
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.seed = int(seed)
        self.generator = torch.Generator(device=device).manual_seed(self.seed)
        gate_cls = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}[gate]
        self.gate = gate_cls(d_model, num_experts, topk=self.top_k, device=device,
                             generator=generator)
        E, D, H = num_experts, d_model, d_hidden
        self.w1 = nn.Parameter(_xavier_normal((E, D, H), generator, device))
        self.b1 = nn.Parameter(torch.zeros((E, 1, H), device=device))
        self.w2 = nn.Parameter(_xavier_normal((E, H, D), generator, device))
        self.b2 = nn.Parameter(torch.zeros((E, 1, D), device=device))
        self.aux_loss = None

    def _capacity_factor(self):
        if self.capacity_factor is not None:
            return float(self.capacity_factor)
        cap = self.gate.capacity or (1.25, 2.0)
        return float(cap[0] if self.training else cap[1])

    def capacity(self, num_tokens):
        """The per-expert token budget for ``num_tokens`` tokens:
        ``max(1, ceil(T·K·cf / E))`` at the current capacity factor."""
        return max(1, int(math.ceil(num_tokens * self.top_k * self._capacity_factor()
                                    / self.num_experts)))

    def forward(self, x):
        """x: ``[batch, seq, d_model]`` (or ``[tokens, d_model]``)."""
        xs = x if x.ndim == 3 else x[None]
        B, S, D = xs.shape
        tokens = xs.reshape(B * S, D)
        E, K = self.num_experts, self.top_k
        probs = torch.softmax(self.gate.score(tokens), dim=-1)  # [T, E]
        gate_vals, gate_idx = torch.topk(probs, K, dim=-1)  # [T, K]
        drop_mask = None
        if self.training and self.gate.random_routing and K >= 2:
            drop_mask = jitter_drop_mask(gate_vals, self.generator)
        self.aux_loss = type(self.gate).aux_loss(probs, gate_idx, E)
        out = _registry.dispatch(
            "moe", tokens, gate_vals, gate_idx, drop_mask, self.w1, self.b1, self.w2, self.b2,
            capacity=self.capacity(B * S), activation=self.activation)
        out = out.reshape(B, S, D)
        return out[0] if x.ndim == 2 else out


def routing_replay(module):
    """The ``(forward, recompute)`` context pair, for
    ``torch.utils.checkpoint``'s ``context_fn``, that replays the routing of
    every :class:`MoELayer` in ``module`` (None: no layer). The forward
    context records each layer's generator state before and after the
    forward; the recompute context sets the state from before, so the
    recompute draws the forward's jitter, and on leaving (also when the
    checkpoint stops the recompute early) sets the state from after and
    puts back each layer's ``aux_loss``, so the recompute changes neither
    the next forward's draws nor the aux loss the criterion read."""
    layers = [] if module is None else [m for m in module.modules() if isinstance(m, MoELayer)]
    before, after = [], []

    @contextlib.contextmanager
    def forward():
        before[:] = [m.generator.get_state() for m in layers]
        try:
            yield
        finally:
            after[:] = [m.generator.get_state() for m in layers]

    @contextlib.contextmanager
    def recompute():
        aux = [m.aux_loss for m in layers]
        for m, state in zip(layers, before):
            m.generator.set_state(state)
        try:
            yield
        finally:
            for m, state, a in zip(layers, after, aux):
                m.generator.set_state(state)
                m.aux_loss = a

    return forward(), recompute()

"""Mixture of experts (``paddle_tpu/distributed/moe.py``): the Naive,
GShard and Switch gates, the ``dense`` dispatch/combine composite and
:class:`MoELayer`.

Routing (gate scores, top-k, GShard's random second-expert jitter, capacity
dropping, the aux loss) happens here; the dispatch / expert FFN / combine
core goes through the ``moe`` registry kernel: ``pallas_sorted``
(:mod:`paddle_tpu_torch.ops.moe_pallas`, the CUDA kernels K4/K4b on the
card) where it takes the call, else the ``dense`` fallback below.

Expert parallelism (``expert_axis="dp"``, the reference's default): built
after ``fleet.init`` with a ``dp`` degree n above 1, a layer holds experts
``[r * E / n, (r + 1) * E / n)`` of rank r of the ``dp`` group (the
reference marks its expert weights ``P("dp", ...)``) and routes as the
reference's GSPMD program does over the global batch: the capacity comes
from the global token count; a pair's queue position in its expert is its
position among this rank's pairs plus the pairs the lower ranks sent there
(one all-gather of the ``[E]`` counts); the aux loss takes ``me`` and ``ce``
from sums all-reduced over the group. The kept rows go to their owners by
``global_scatter``, the owner runs the grouped FFN on the rows it received
(stacked in rank order, so row p of expert e is the one-process buffer's
row p) and sends the outputs back by ``global_gather``; the sender
combines them with its gate weights
(:func:`expert_parallel_dispatch_combine`, called by the layer, which takes
the registry's pick for the call to choose the owner's FFN). Each owner keeps its experts'
gradient: the reducers leave a parameter marked ``expert_group`` out of
their all-reduce. Expert parallelism together with ``mp``, ``pp``, ``sdp``
or ``sep`` raises (ROADMAP.md, Queue 1 item 13c).

The jitter draws from a ``torch.Generator`` that the layer owns, seeded at
construction (``MoELayer.seed``), not from a global key: re-seeding it
(``layer.generator.manual_seed(layer.seed)``) repeats the routing. Under
expert parallelism it draws over the global token count and each rank
takes its rows' slice, so a world of n ranks routes as a world of one.
Under activation recompute, :func:`routing_replay` makes the recompute draw
what the forward drew.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..framework.device import resolve_device
from ..nn import initializer as _I
from ..ops import moe_pallas as _moe_pallas  # registers 'pallas_sorted'
from ..ops import registry as _registry
from ..ops.moe_pallas import sort_pairs

__all__ = ["NaiveGate", "GShardGate", "SwitchGate", "MoELayer", "dense_dispatch_combine",
           "expert_parallel_dispatch_combine", "routing_replay"]


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


def _param_value(shape, default, generator, device, is_bias=False):
    """A parameter's value as the reference's ``create_parameter`` makes it:
    the global initialiser where one is set, else ``default(shape,
    generator, device)``."""
    return _I.make(shape, None, lambda s, dtype, g, d: default(s, g, d), generator, device,
                   is_bias=is_bias)


def _zeros(shape, generator, device):
    return torch.zeros(shape, device=device)


class NaiveGate(nn.Module):
    """Linear scores + top-k. No jitter, no aux loss, no capacity opinion
    (``capacity = None`` defers to the layer)."""

    capacity = None
    random_routing = False

    def __init__(self, d_model, num_expert, world_size=1, topk=2, *, device=None, generator=None):
        super().__init__()
        self.topk = topk
        self.num_expert = num_expert
        self.weight = nn.Parameter(_param_value((d_model, num_expert), _xavier_normal, generator,
                                                resolve_device(device)))

    def score(self, x):
        return x @ self.weight

    @staticmethod
    def aux_loss(probs, gate_idx, num_expert, group=None):
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
    def aux_loss(probs, gate_idx, num_expert, group=None):
        """GShard eq. 4: E * sum(me * ce), ``me`` the mean gate probability
        and ``ce`` the top-1 dispatch fraction per expert. Over an expert
        ``group`` both are the whole group's means (sums all-reduced): the
        value is the global batch's, and ``me``'s gradient is this rank's
        tokens' mean, which the data group's averaging makes the global
        one's."""
        me = probs.mean(dim=0)
        ce = F.one_hot(gate_idx[:, 0], num_expert).to(probs.dtype).mean(dim=0)
        if group is not None:
            from . import collective

            sums = torch.stack([probs.detach().sum(dim=0),
                                F.one_hot(gate_idx[:, 0], num_expert).to(probs.dtype).sum(dim=0)])
            collective.all_reduce(sums, group=group)
            sums = sums / (probs.shape[0] * group.nranks)
            me = me + (sums[0] - me.detach())
            ce = sums[1]
        return num_expert * (me * ce).sum()


class SwitchGate(NaiveGate):
    """Top-1 routing; the Switch-Transformer aux loss (GShard's form over
    the top-1 assignment)."""

    def __init__(self, d_model, num_expert, world_size=1, topk=1, capacity=(1.2, 2.4), *,
                 device=None, generator=None):
        super().__init__(d_model, num_expert, world_size, topk, device=device, generator=generator)
        self.capacity = tuple(capacity)

    aux_loss = staticmethod(GShardGate.aux_loss)


def _einsum_ffn(xg, w1, b1, w2, b2, activation, rows=None):
    """The expert FFN over the padded ``[E*cap, D]`` layout as batched
    einsums, the dense composite's (every row computed; ``rows`` is taken
    for the grouped FFN's signature)."""
    E, D, _ = w1.shape
    act = {"gelu": lambda x: F.gelu(x, approximate="tanh"), "relu": F.relu,
           "silu": F.silu}[activation]
    h = act(torch.einsum("ecd,edh->ech", xg.reshape(E, -1, D), w1) + b1)
    return (torch.einsum("ech,ehd->ecd", h, w2) + b2).reshape(xg.shape)


def dense_dispatch_combine(tokens, gate_vals, gate_idx, drop_mask, w1, b1, w2, b2, *, capacity,
                           activation):
    """The GShard/Switch dense composite: one-hot + cumsum queue positions,
    padded ``[E, capacity, D]`` dispatch einsums, gather combine. The
    registry's ``moe`` fallback: always available, and the plain reference
    the ``pallas_sorted`` path is held against."""
    T, D = tokens.shape
    E = w1.shape[0]
    K = gate_idx.shape[1]

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

    y = _einsum_ffn(disp.reshape(E * capacity, D), w1, b1, w2, b2, activation)
    gathered = y.reshape(E, capacity, D)[e_ids, p_ids]  # [T*K, D]
    combined = torch.zeros((T, D), dtype=y.dtype, device=y.device)
    return combined.index_add(0, tok_rep, gathered * gv[:, None])


_registry.register(
    "moe", "dense", dense_dispatch_combine, fallback=True,
    doc="one-hot/cumsum dispatch + padded [E, capacity, D] einsums (plain PyTorch composite)")


def expert_parallel_dispatch_combine(tokens, gate_vals, gate_idx, drop_mask, w1, b1, w2, b2, *,
                                     capacity, activation, group, ffn):
    """The ``moe`` dispatch/combine with the experts over ``group``: this
    rank holds ``El = w1.shape[0]`` of the ``E = El * n`` experts (rank r
    experts ``[r * El, (r + 1) * El)``) and routes its tokens ``[T, D]``
    (gate_idx over all E) as one process routes the group's tokens, ranks
    in order:

    1. route: the sort of :func:`~paddle_tpu_torch.ops.moe_pallas.sort_pairs`;
       one all-gather of each rank's per-expert counts; a pair's global
       queue position is its own plus the lower ranks' counts for its
       expert, and it is kept below ``capacity``;
    2. exchange: the kept rows, in expert order, to their owners by
       ``global_scatter`` (counts from the all-gather: one host sync);
    3. FFN: the owner lays out what it received, expert by expert in rank
       order (row p of expert e is the one-process layout's row p), and
       runs ``ffn`` (the grouped FFN, K4/K4b on the card) with ``rows`` the
       live rows per expert, ``min(count, capacity)``, on the device;
    4. combine: the outputs back by ``global_gather`` and the weighted
       scatter-add to token order.

    The backward runs the exchanges in reverse (each one's backward is the
    other). Returns ``[T, D]``."""
    from .utils import global_gather, global_scatter

    T, D = tokens.shape
    El = w1.shape[0]
    n, me = group.nranks, group.rank
    E = El * n
    cap = int(capacity)
    device = tokens.device
    e_sorted, tok_sorted, gv_sorted, counts, pos = sort_pairs(gate_vals, gate_idx, drop_mask, E)

    from . import collective

    # each rank's pairs per expert, and its token count: the capacity and
    # the split sizes assume every rank holds as many tokens
    table = collective.all_gather(torch.cat([counts[:E], counts.new_tensor([T])]), group=group)
    every = table[:, :E]  # [n, E]
    before = torch.cumsum(every, 0) - every  # the lower ranks' pairs per expert
    offset = torch.cat([before[me], before.new_zeros(1)])  # a dropped pair: none
    keep = (e_sorted < E) & (pos + offset[e_sorted] < cap)
    kept = torch.minimum((cap - before).clamp(min=0), every)  # [n, E] rows each rank sends
    host = torch.cat([kept, table[:, E:]], 1).cpu()  # the split sizes of the exchange
    tokens_each = host[:, E].tolist()
    if len(set(tokens_each)) > 1:
        raise ValueError(f"expert parallelism needs the same token count on every rank of the "
                         f"expert group; the ranks hold {tokens_each} (batch x sequence)")
    host = host[:, :E]
    local_count = host[me].tolist()
    global_count = host[:, me * El:(me + 1) * El].reshape(-1).tolist()

    sel = keep.nonzero().squeeze(1)  # kept pairs, by expert then queue position
    send = tokens.index_select(0, tok_sorted[sel])
    recv = global_scatter(send, local_count, global_count, group=group)

    # the owner's padded [El * cap, D] layout: expert i's rows in rank order
    per_expert = host[:, me * El:(me + 1) * El].sum(0)  # [El]
    R = int(per_expert.sum())
    expert = torch.repeat_interleave(torch.arange(El), per_expert)
    first = torch.cumsum(per_expert, 0) - per_expert
    slot = (expert * cap + torch.arange(R) - first[expert]).to(device)
    row_ids = torch.full((El * cap,), R, dtype=torch.long, device=device)
    row_ids.scatter_(0, slot, torch.arange(R, device=device))
    xg = torch.cat([recv, recv.new_zeros((1, D))]).index_select(0, row_ids)
    # the live rows of each expert, counted on the device: the kernels read them there
    rows = kept[:, me * El:(me + 1) * El].sum(0).to(torch.int32)
    yg = ffn(xg, w1, b1, w2, b2, activation, rows)

    back = global_gather(yg.index_select(0, slot), local_count, global_count, group=group)
    weights = gv_sorted.index_select(0, sel).to(back.dtype)
    out = torch.zeros((T, D), dtype=back.dtype, device=device)
    return out.index_add(0, tok_sorted.index_select(0, sel), back * weights[:, None])


def jitter_drop_mask(gate_vals, generator, total=None, offset=0):
    """GShard random routing: ``[T, K]`` bool, True where a pair is not
    dispatched. Each token keeps its second expert with probability
    ``min(1, 2·p2)`` (the reference's ``2*topk_val > rand`` test); the
    other ranks always dispatch. Under expert parallelism the draw is over
    the group's ``total`` tokens and this rank's take rows ``[offset,
    offset + T)`` of it."""
    n_tok, K = gate_vals.shape
    r = torch.rand(n_tok if total is None else total, generator=generator,
                   device=gate_vals.device, dtype=gate_vals.dtype)[offset:offset + n_tok]
    drop = torch.zeros((n_tok, K), dtype=torch.bool, device=gate_vals.device)
    drop[:, 1] = 2.0 * gate_vals[:, 1].detach() <= r
    return drop


def _expert_group(expert_axis):
    """The active fleet's group along ``expert_axis``, or None (no fleet, or
    a degree of 1)."""
    from .fleet import fleet
    from .topology import AXES

    hcg = fleet.get_hybrid_communicate_group()
    if hcg is None:
        return None
    if expert_axis != "dp":
        raise NotImplementedError(f"expert_axis {expert_axis!r}: the port shards experts over "
                                  "'dp' only, the reference's default")
    group = hcg.group(expert_axis)
    if group.nranks == 1:
        return None
    other = {f"{a}_degree": d for a, d in zip(AXES, hcg.dims) if a != expert_axis and d > 1}
    if other:
        raise NotImplementedError(
            f"expert parallelism over {expert_axis} together with {other} is not ported yet "
            "(ROADMAP.md, Queue 1 item 13c): a mixture of experts runs at dp > 1 alone")
    return group


class MoELayer(nn.Module):
    """Expert FFN mixture: stacked expert weights ``w1 [E, D, H]``,
    ``b1 [E, 1, H]``, ``w2 [E, H, D]``, ``b2 [E, 1, D]`` and a gate
    (``'naive' | 'gshard' | 'switch'``).

    ``capacity_factor``: an explicit per-expert capacity factor; ``None``
    takes the gate's (train, eval) pair. ``activation``: ``'gelu'`` (tanh
    form), ``'relu'`` or ``'silu'``. ``expert_axis``: the fleet axis the
    experts shard over (``"dp"``, the reference's default; see the module's
    docstring): built under a fleet of ``dp`` degree n > 1 the layer holds
    ``E / n`` experts, this rank's slice of the weights drawn for all E.
    ``device`` as the port's entry points (``"meta"`` draws nothing);
    ``generator`` draws the initial weights (a fresh one seeded ``seed``
    when None); ``seed`` seeds the layer's own routing generator. After a
    forward, ``aux_loss`` holds the gate's load-balancing loss."""

    def __init__(self, d_model, d_hidden, num_experts, top_k=2, capacity_factor=None,
                 gate="gshard", activation="gelu", expert_axis="dp", *, device=None,
                 generator=None, seed=0):
        super().__init__()
        if activation not in _moe_pallas.ACTIVATIONS:
            raise ValueError(f"activation must be one of {_moe_pallas.ACTIVATIONS}, "
                             f"got {activation!r}")
        device = resolve_device(device)
        meta = device.type == "meta"
        if generator is None and not meta:
            generator = torch.Generator(device=device).manual_seed(int(seed))
        self.num_experts = num_experts
        self.top_k = 1 if gate == "switch" else top_k
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.expert_axis = expert_axis
        self.expert_group = _expert_group(expert_axis)
        n = 1 if self.expert_group is None else self.expert_group.nranks
        if num_experts % n:
            raise ValueError(f"{num_experts} experts do not split over {expert_axis} degree {n}")
        self.seed = int(seed)
        self.generator = None if meta else torch.Generator(device=device).manual_seed(self.seed)
        gate_cls = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}[gate]
        self.gate = gate_cls(d_model, num_experts, topk=self.top_k, device=device,
                             generator=generator)
        E, D, H = num_experts, d_model, d_hidden
        lo, hi = (0, E) if n == 1 else (self.expert_group.rank * E // n,
                                        (self.expert_group.rank + 1) * E // n)
        # all experts' values, then this rank's experts
        self.w1 = nn.Parameter(_param_value((E, D, H), _xavier_normal, generator,
                                            device)[lo:hi].contiguous())
        self.b1 = nn.Parameter(_param_value((E, 1, H), _zeros, generator, device,
                                            is_bias=True)[lo:hi].contiguous())
        self.w2 = nn.Parameter(_param_value((E, H, D), _xavier_normal, generator,
                                            device)[lo:hi].contiguous())
        self.b2 = nn.Parameter(_param_value((E, 1, D), _zeros, generator, device,
                                            is_bias=True)[lo:hi].contiguous())
        self.mark_experts()
        self.aux_loss = None

    def mark_experts(self):
        """Mark the expert weights for the distributed layer: ``expert_group``
        (None when every rank holds all experts) and ``expert_axis``. A
        model that remakes its parameters (``to_empty``) marks them again."""
        for p in (self.w1, self.b1, self.w2, self.b2):
            p.expert_group = self.expert_group
            p.expert_axis = self.expert_axis

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
        """x: ``[batch, seq, d_model]`` (or ``[tokens, d_model]``); under
        expert parallelism this rank's rows of the group's batch, every
        rank holding as many."""
        xs = x if x.ndim == 3 else x[None]
        B, S, D = xs.shape
        tokens = xs.reshape(B * S, D)
        E, K = self.num_experts, self.top_k
        group = self.expert_group
        n, r = (1, 0) if group is None else (group.nranks, group.rank)
        if self.generator is None:  # built on the meta device
            self.generator = torch.Generator(device=x.device).manual_seed(self.seed)
        probs = torch.softmax(self.gate.score(tokens), dim=-1)  # [T, E]
        gate_vals, gate_idx = torch.topk(probs, K, dim=-1)  # [T, K]
        drop_mask = None
        if self.training and self.gate.random_routing and K >= 2:
            where = {} if group is None else dict(total=n * B * S, offset=r * B * S)
            drop_mask = jitter_drop_mask(gate_vals, self.generator, **where)
        self.aux_loss = type(self.gate).aux_loss(probs, gate_idx, E, group=group)
        args = (tokens, gate_vals, gate_idx, drop_mask, self.w1, self.b1, self.w2, self.b2)
        kw = dict(capacity=self.capacity(n * B * S), activation=self.activation)
        if n == 1:
            out = _registry.dispatch("moe", *args, **kw)
        else:
            # the registry's pick (counted there) chooses the owner's expert
            # FFN: the grouped FFN (K4/K4b on the card) where pallas_sorted
            # takes the call, else the dense composite's einsums
            impl = _registry.select("moe", *args, **kw)
            ffn = _moe_pallas.grouped_ffn if impl.name == "pallas_sorted" else _einsum_ffn
            out = expert_parallel_dispatch_combine(*args, group=group, ffn=ffn, **kw)
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

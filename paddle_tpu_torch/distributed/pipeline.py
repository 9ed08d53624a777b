"""Pipeline parallelism of the port (``paddle_tpu/distributed/pipeline.py``;
parity: fleet/meta_parallel/pipeline_parallel.py:31, its 1F1B
``train_batch``:154, ``PipelineLayer`` pp_layers.py:162 and the p2p
helpers of pp_utils/p2p_communication.py:222).

The reference runs its pipeline as one SPMD program: the stages' weights
stacked over the ``pp`` mesh axis, activations moved by ``ppermute``, the
backward by autodiff, and its ``"1f1b"`` is GPipe's order with every stage
application rematerialized, its only way to bound memory inside one XLA
program. The port runs one process per stage, each holding only its own
layers, and moves the activations and their gradients by point-to-point
sends over the ``pp`` group (:func:`~.collective.p2p`). Its schedules are
the reference Paddle's:

- ``"gpipe"``: every micro-batch's forward, then every backward;
- ``"1f1b"``: ``pp - s - 1`` warm-up forwards on stage ``s``, then one
  forward and one backward in turn, then the remaining backwards (the
  cool-down). Stage ``s`` holds at most ``pp - s`` micro-batches' stage
  inputs at once, where GPipe holds all of them. Nothing is recomputed
  unless ``strategy.recompute`` asks for it.

:func:`run_schedule` drives one step of either over a stage's forward and
backward functions (``TrainStep`` gives it the model's stage and the loss
on the last stage). :func:`microbatch` is the strided split that gradient
accumulation shares with the schedule.
"""
from __future__ import annotations

import torch

from . import collective as C

SCHEDULES = ("gpipe", "1f1b")
_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
_HEADER = 8  # dtype, ndim, up to 6 dims


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """``[B, ...] -> [n_micro, B / n_micro, ...]`` with micro-batch i the
    rows ``i::n_micro`` (strided, as in the reference: GPT-MoE's capacity is
    computed per micro-batch, so a contiguous split would route
    differently)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    return x.reshape(b // n_micro, n_micro, *x.shape[1:]).transpose(0, 1)


def unmicrobatch(xm: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`microbatch`."""
    n_micro, mb = xm.shape[0], xm.shape[1]
    return xm.transpose(0, 1).reshape(n_micro * mb, *xm.shape[2:])


def active_pipeline_plan():
    """``(hcg, n_micro)`` of the live fleet's pipeline, or ``(None, 1)``
    without one (``pp`` 1). ``n_micro`` is
    ``strategy.pipeline_configs.accumulate_steps``, or ``2 * pp`` when that
    is 1 or less."""
    from .fleet import fleet

    hcg = fleet.get_hybrid_communicate_group()
    if hcg is None or hcg.get_pipe_parallel_world_size() <= 1:
        return None, 1
    n_micro = 1
    if fleet._strategy is not None:
        n_micro = int(fleet._strategy.pipeline_configs.accumulate_steps)
    if n_micro <= 1:
        n_micro = 2 * hcg.get_pipe_parallel_world_size()
    return hcg, n_micro


def active_pipeline_schedule() -> str:
    """The live strategy's schedule, ``"gpipe"`` or ``"1f1b"``; another
    name raises ``ValueError``."""
    from .fleet import fleet

    schedule = fleet._strategy.pipeline_configs.schedule if fleet._strategy is not None else "gpipe"
    if schedule not in SCHEDULES:
        raise ValueError(f"pipeline schedule must be 'gpipe' or '1f1b', got {schedule!r}")
    return schedule


class _Link:
    """The stage's point-to-point exchanges with its neighbours over the
    ``pp`` group. The first activation a stage sends in a step of a new
    shape goes after a header with its dtype and shape; the receiver keeps
    it (``meta``), so a step of the same batch shape sends none."""

    def __init__(self, group, stage, n_stages, meta):
        self.group, self.stage = group, stage
        self.first, self.last = stage == 0, stage == n_stages - 1
        self.meta = meta  # {"recv": (shape, dtype) or None, "sent": bool}
        self.device = None

    def _header_out(self, y):
        h = torch.zeros(_HEADER, dtype=torch.int64)
        h[0], h[1] = _DTYPES.index(y.dtype), y.ndim
        h[2:2 + y.ndim] = torch.tensor(y.shape)
        C.send(h.to(y.device), dst=self.stage + 1, group=self.group)

    def _header_in(self):
        h = C.recv(torch.zeros(_HEADER, dtype=torch.int64, device=self.device),
                   src=self.stage - 1, group=self.group).cpu()
        self.meta["recv"] = (tuple(int(d) for d in h[2:2 + int(h[1])]), _DTYPES[int(h[0])])

    def _buffer(self):
        shape, dtype = self.meta["recv"]
        return torch.empty(shape, dtype=dtype, device=self.device)

    def exchange(self, send_fwd=None, send_bwd=None, recv_fwd=False, recv_bwd=None):
        """One batch of this stage's exchanges: send ``send_fwd`` downstream
        and ``send_bwd`` upstream; receive an activation from upstream
        (``recv_fwd``) and a gradient shaped like ``recv_bwd`` from
        downstream. Returns ``(activation, gradient)``, None for what was
        not received."""
        if send_fwd is not None and not self.meta.get("sent"):
            self._header_out(send_fwd)
            self.meta["sent"] = True
        if recv_fwd and self.meta.get("recv") is None:
            self._header_in()
        sends, recvs = [], []
        x = dy = None
        if send_fwd is not None:
            sends.append((send_fwd, self.stage + 1))
        if send_bwd is not None:
            sends.append((send_bwd, self.stage - 1))
        if recv_fwd:
            x = self._buffer()
            recvs.append((x, self.stage - 1))
        if recv_bwd is not None:
            dy = torch.empty_like(recv_bwd)
            recvs.append((dy, self.stage + 1))
        if sends or recvs:
            C.p2p(sends=sends, recvs=recvs, group=self.group)
        return x, dy


class ScheduleStats:
    """What one step's schedule did on this stage: its order of ``("F",
    i)`` and ``("B", i)``, and the most micro-batches whose stage inputs
    it held at once (forward done, backward not)."""

    def __init__(self):
        self.order, self.held, self.peak_held = [], 0, 0

    def forward(self, i):
        self.order.append(("F", i))
        self.held += 1
        self.peak_held = max(self.peak_held, self.held)

    def backward(self, i):
        self.order.append(("B", i))
        self.held -= 1


def run_schedule(forward, backward, n_micro, schedule, group, stage, n_stages, meta, device):
    """One step of ``schedule`` on stage ``stage`` of ``n_stages``, over
    ``n_micro`` micro-batches in order.

    ``forward(i, x)`` runs micro-batch ``i``'s forward on the activation
    ``x`` received from upstream (None on the first stage) and returns what
    goes downstream (on the last stage, anything: nothing is sent);
    ``backward(i, dy)`` runs its backward with the gradient ``dy`` received
    from downstream (None on the last stage) and returns the gradient of
    ``x`` (None on the first stage). The order is Paddle's (Megatron's):
    every send is posted together with the receive that follows it, so no
    two neighbours wait on each other. ``meta`` is the caller's cache of
    the activation's shape (see :class:`_Link`). Returns a
    :class:`ScheduleStats`."""
    if schedule not in SCHEDULES:
        raise ValueError(f"pipeline schedule must be 'gpipe' or '1f1b', got {schedule!r}")
    link = _Link(group, stage, n_stages, meta)
    link.device = device
    stats = ScheduleStats()
    warmup = n_micro if schedule == "gpipe" else min(n_stages - stage - 1, n_micro)
    remaining = n_micro - warmup
    outs = {}

    def fwd(i, x):
        stats.forward(i)
        y = forward(i, x)
        outs[i] = y
        return None if link.last else y

    def bwd(i, dy):
        stats.backward(i)
        dx = backward(i, dy)
        outs.pop(i, None)
        return None if link.first else dx

    fwd_i = bwd_i = 0
    for _ in range(warmup):
        x, _ = link.exchange(recv_fwd=not link.first)
        y = fwd(fwd_i, x)
        fwd_i += 1
        link.exchange(send_fwd=y)
    x = None
    if remaining:
        x, _ = link.exchange(recv_fwd=not link.first)
    for k in range(remaining):
        y = fwd(fwd_i, x)
        fwd_i += 1
        _, dy = link.exchange(send_fwd=y, recv_bwd=None if link.last else outs[bwd_i])
        dx = bwd(bwd_i, dy)
        bwd_i += 1
        if k == remaining - 1:
            link.exchange(send_bwd=dx)
        else:
            x, _ = link.exchange(send_bwd=dx, recv_fwd=not link.first)
    for _ in range(warmup):
        _, dy = link.exchange(recv_bwd=None if link.last else outs[bwd_i])
        dx = bwd(bwd_i, dy)
        bwd_i += 1
        link.exchange(send_bwd=dx)
    return stats


@torch.no_grad()
def pipeline_forward(stage_fn, x, group, stage, n_stages, n_micro=1):
    """An inference pass through the stages: ``stage_fn(h)`` is this
    stage's part; the first stage feeds ``x`` in ``n_micro`` strided
    micro-batches, and every stage returns the last stage's outputs in
    batch order (broadcast over ``group``)."""
    meta = {}
    outs = []

    def forward(i, h):
        y = stage_fn(microbatch(x, n_micro)[i] if stage == 0 else h)
        outs.append(y)
        return y

    link = _Link(group, stage, n_stages, meta)
    link.device = x.device
    for i in range(n_micro):
        h, _ = link.exchange(recv_fwd=stage > 0)
        y = forward(i, h)
        link.exchange(send_fwd=None if stage == n_stages - 1 else y)
    if stage == n_stages - 1:
        out = unmicrobatch(torch.stack(outs))
        head = torch.tensor([_DTYPES.index(out.dtype), out.ndim, *out.shape]
                            + [0] * (_HEADER - 2 - out.ndim), device=x.device)
    else:
        head = torch.zeros(_HEADER, dtype=torch.int64, device=x.device)
    C.broadcast(head, src=n_stages - 1, group=group)
    head = head.cpu()
    if stage != n_stages - 1:
        out = torch.empty(tuple(int(d) for d in head[2:2 + int(head[1])]),
                          dtype=_DTYPES[int(head[0])], device=x.device)
    return C.broadcast(out.contiguous(), src=n_stages - 1, group=group)


class LayerDesc:
    """Parity: pp_layers.py:58. A layer to build, on the stage that holds it."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """Parity: pp_layers.py:77. A layer used on several stages under one
    ``key`` (GPT's tied word table): each of those stages builds it, the
    copies start from the first holder's weights, and their gradients are
    summed (:meth:`PipelineLayer.allreduce_shared_weight_gradients`).
    ``forward_func(layer, x)`` is how it is applied, if given."""

    def __init__(self, key, layer_cls, *args, forward_func=None, shared_weight_attr="weight",
                 **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.key = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Parity: pp_layers.py:92. The bounds of ``num_parts`` segments of the
    layer list, by count: the first ``n % num_parts`` segments one longer."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.descs = layers_desc
        self.num_parts = num_parts

    def do_segment(self):
        n = len(self.descs)
        base, extra = divmod(n, self.num_parts)
        bounds = [0]
        for i in range(self.num_parts):
            bounds.append(bounds[-1] + base + (1 if i < extra else 0))
        return bounds


class PipelineLayer(torch.nn.Module):
    """Parity: PipelineLayer (pp_layers.py:162). ``layers`` (descs or built
    modules) split into ``num_stages`` segments (the fleet's ``pp`` degree
    by default); this rank builds and holds only its stage's segment, and
    its ``forward`` runs that segment: on the first stage from the batch,
    on the others from the activation received. ``TrainStep`` over the
    fleet's grid runs the schedule across the stages; ``pipeline_forward``
    gives an inference pass. Without a pipeline (one stage) it is the
    whole list in order."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None, seg_method="uniform",
                 recompute_interval=0, **kwargs):
        super().__init__()
        from .fleet import fleet

        hcg = fleet.get_hybrid_communicate_group()
        pp = hcg.get_pipe_parallel_world_size() if hcg is not None else 1
        self.num_stages = int(num_stages or pp)
        if self.num_stages not in (1, pp):
            raise ValueError(f"num_stages {self.num_stages} is not the fleet's pp degree {pp}")
        self.stage = hcg.get_pipe_parallel_rank() if self.num_stages > 1 else 0
        self.loss_fn = loss_fn
        self.recompute_interval = recompute_interval
        self.descs = list(layers)
        self.segments = SegmentLayers(self.descs, self.num_stages).do_segment()
        lo, hi = self.segments[self.stage], self.segments[self.stage + 1]
        self.run_function = []
        self.shared_layers = torch.nn.ModuleDict()
        self._shared = {}  # key -> (group, attr)
        self._build(lo, hi, hcg)

    def _build(self, lo, hi, hcg):
        built = torch.nn.ModuleList()
        holders = {}
        for i, d in enumerate(self.descs):
            if isinstance(d, SharedLayerDesc):
                holders.setdefault(d.key, []).append(self._stage_of(i))
        groups = {}
        if self.num_stages > 1:
            for key, stages in holders.items():  # every rank makes every group, in one order
                stages = sorted(set(stages))
                for ranks in hcg.topo.get_comm_list("pp"):
                    g = C.new_group([ranks[s] for s in stages], axis_name=f"shared:{key}")
                    if hcg.global_rank in g.ranks:
                        groups[key] = g
        for i in range(lo, hi):
            d = self.descs[i]
            if isinstance(d, SharedLayerDesc):
                if d.key not in self.shared_layers:
                    self.shared_layers[d.key] = d.build_layer()
                    self._shared[d.key] = (groups.get(d.key), d.shared_weight_attr)
                layer = self.shared_layers[d.key]
                fn = (lambda x, layer=layer, f=d.forward_func: f(layer, x)) if d.forward_func \
                    else layer
                self.run_function.append(fn)
            else:
                layer = d.build_layer() if isinstance(d, LayerDesc) else d
                if isinstance(layer, torch.nn.Module):
                    built.append(layer)
                self.run_function.append(layer)
        self.layers = built
        with torch.no_grad():  # the copies of a shared layer start from its first holder's
            for key, (g, attr) in self._shared.items():
                if g is not None and g.nranks > 1:
                    C.broadcast(getattr(self.shared_layers[key], attr).data, src=0, group=g)

    def _stage_of(self, i):
        return next(s for s in range(self.num_stages) if i < self.segments[s + 1])

    def forward(self, x):
        for fn in self.run_function:
            x = fn(x)
        return x

    def allreduce_shared_weight_gradients(self):
        """Sum each shared layer's weight gradient over the stages holding
        it (``TrainStep`` calls this after the schedule)."""
        for key, (g, attr) in self._shared.items():
            w = getattr(self.shared_layers[key], attr)
            if g is not None and g.nranks > 1 and w.grad is not None:
                C.all_reduce(w.grad, group=g)

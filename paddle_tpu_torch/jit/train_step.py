"""``TrainStep`` of the port (``paddle_tpu/jit/__init__.py``): forward, loss,
backward and optimizer update as one call.

The reference traces the step into one XLA program; PyTorch runs it eagerly
here, so ``run_steps(k)`` is a Python loop of k steps (a CUDA graph of it is
later work, ROADMAP.md Queue 1 item 8).

AMP O2 works as in the reference: the model's parameters stay the f32
masters; each step runs the model on bf16 casts of them
(``torch.func.functional_call``), so the gradient of each cast lands in f32
on its master; float inputs are cast likewise; buffers are not cast, so an
update made to one in place survives the step; the model's output goes into
the loss in bf16, and a bf16 loss is cast to f32.

``remat=True`` (or ``FLAGS_remat_policy`` other than ``"none"``) recomputes
the whole model call and loss in the backward. ``accumulate_steps=k``
merges gradients as the reference does: the batch is split into k strided
micro-batches (:func:`paddle_tpu_torch.distributed.pipeline.microbatch`),
each runs its forward and backward, the f32 gradients add up on the masters
and are divided by k, the loss is the mean of the k losses, and one update
follows (a gradient clip sees the average).

The forward and backward run inside
:func:`~paddle_tpu_torch.framework.selected_rows.compiled_step`, as the
reference's run inside its trace: no layer records looked-up rows there,
and an out-of-range embedding id gives the zero row. The update is the
optimizer's compiled-path one (``Optimizer._traced_update``: penalty, clip,
core), keyed by the model's ``named_parameters`` names, so
``RowSparseAdam(sparse_params=["embedding.weight"])`` matches the table
even when it was given bare ``model.parameters()``.

With ``mesh`` (``fleet.distributed_step``), the reference's GSPMD step,
whose gradient is the global batch's, becomes one process per rank whose
gradients the data group (``dp`` x ``sdp``) averages
(:mod:`paddle_tpu_torch.distributed`). The returned loss is the data
group's mean of the ranks' losses: the global batch's mean when every
rank's loss averages the same count (the MLM loss of ranks holding
different numbers of labelled tokens weighs them differently; ROADMAP.md,
Queue 3). That pass runs whenever a mesh is given, at degree 1 too:

- ``state_shardings`` (a ZeRO stage, 1 to 3; or the stage that
  ``group_sharded_parallel`` recorded on the model) runs the step's
  :class:`~paddle_tpu_torch.distributed.sharding.ZeroPlan`: stage 1
  averages whole gradients and updates each rank's blocks, stage 2
  reduce-scatters the split gradients over ``sdp`` and all-reduces them
  over ``dp``, both then all-gather the parameters; at stage 3 the
  parameters are blocks, gathered for the forward and again in the
  backward, and their gradients come back reduce-scattered;
- with ``pp > 1`` the step runs the fleet's pipeline schedule
  (:func:`~paddle_tpu_torch.distributed.pipeline.run_schedule`,
  ``pipeline_configs.schedule``) over ``n_micro =
  pipeline_configs.accumulate_steps`` micro-batches (``2 pp`` when that is
  1), and its own ``accumulate_steps`` stays 1. The last stage weighs
  micro-batch i's loss by its share of the batch's averaged terms
  (``loss_fn.token_count(*labels)``, a loss mask's sum, where the loss
  says; equal shares otherwise), so the step's loss is the batch's, and
  broadcasts it to the other stages. A model with
  ``allreduce_shared_weight_gradients`` (a tied table on the first and
  last stage) has it called before the gradients are averaged;
- at a sequence degree above 1 each rank holds a block of the sequence
  (``fleet.shard_batch``), the model must say it runs so
  (``sequence_parallel``: GPT's stacked trunk), and a replicated
  parameter's gradient is summed over ``sep`` and averaged over the data
  group in one all-reduce (the ``data_sep`` group);
- a mixture of experts' weights sharded over ``dp`` (``expert_group``)
  keep their owner's gradient, divided by the data group's size, and are
  left out of the all-reduce. ZeRO (a stage, or ``sdp > 1``) together
  with a mixture of experts or with ``sep > 1`` raises (ROADMAP.md,
  Queue 1 item 13c).

``guard=True`` (or ``FLAGS_train_guard``) is the reference's training-health
guard. After the backward (and the mesh's gradient pass), one all-finite
reduction runs over the loss and the gradients: the f32 sum of squares of
every gradient (its shards' squares summed over the groups holding the
rest, as the global-norm clip sums them) feeds both the global gradient
norm and the bad-step flag, reduced over the world so every rank skips
together. The update then runs, and every parameter, optimizer moment and
buffer is set back to its pre-step value where the flag is set
(``torch.where`` on the card: a bad step leaves them bit for bit), the
step count stays, and ``skipped`` counts the step. The metrics carry
``health = {bad_step, grad_norm, skipped}`` as tensors on the card. The
host learns the flag one step late: a step's flag is read at the next
step's update, after that step's forward and backward are queued, so the
card never waits on the host for it (``state`` reads it at once). The
chaos injector ``FLAGS_chaos_nan_at_step`` fills the gradients with NaN
at that dispatch (counted as ``step + skipped``), once per process, as
the reference's does.

``state`` is the step's whole training state as the reference keys it
(``params``: the f32 masters, or the model's parameters without AMP;
``buffers``; ``opt``: each optimizer moment by parameter name; ``step``;
``skipped`` with the guard; ``lr``: the LR schedule's state; ``rng``: each
MoE layer's generator); ``load_state`` puts one back. Under a mesh they
are this rank's pieces: :mod:`paddle_tpu_torch.distributed.converter`
joins and cuts them for a checkpoint.
"""
from __future__ import annotations

import torch
from torch.func import functional_call

from ..distributed import collective as C
from ..distributed.env import get_world_size
from ..distributed.pipeline import (active_pipeline_plan, active_pipeline_schedule, microbatch,
                                    run_schedule, unmicrobatch)
from ..distributed.recompute import recompute
from ..framework.flags import flag
from ..framework.selected_rows import compiled_step
from ..nn.clip import _reduce_terms, _shard_groups
from ..observability import metrics, slo
from ..testing import chaos

_NOT_PORTED = "TrainStep: {} is not ported yet (ROADMAP.md, Queue 1 item {})"


def _as_tensors(x, device):
    items = x if isinstance(x, (list, tuple)) else (x,)
    return tuple(torch.as_tensor(v, device=device) for v in items)


def _tree_map(fn, *trees):
    """``fn`` over the tensors of same-structured (nested tuple, list or
    dict) model outputs."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _stack_microbatches(*outs):
    """The k micro-batches' outputs back in batch order: a leaf with a
    batch dim is stacked ``[k, mb, ...]`` and unsplit; a scalar (GPT-MoE's
    aux loss) is stacked ``[k]``."""
    return _tree_map(lambda *xs: unmicrobatch(torch.stack(xs)) if xs[0].ndim else torch.stack(xs),
                     *outs)


class TrainStep:
    """One training step: ``loss_fn(model(*inputs), *labels)``, its
    backward, and ``optimizer``'s update at ``optimizer.lr_at(step)``.

    ``amp_level``: None or ``"O0"`` (the model's dtype) or ``"O2"`` (compute
    in ``amp_dtype`` over f32 masters). ``remat``: recompute the model call
    in the backward. ``accumulate_steps``: micro-batches per update.
    ``return_outputs``: the model's outputs (in batch order) in the metrics
    under ``"outputs"``. ``mesh``: the fleet's ``HybridCommunicateGroup``;
    then each rank runs the step on its own block of the batch, and after
    the backward the f32 master gradients (and the loss) are averaged over
    the data group, bucketed as ``DataParallel`` does, before the update
    (or by the ZeRO plan of ``state_shardings``, the stage). That pass runs
    whenever a mesh is given, at degree 1 too (a sum over one rank,
    divided by 1: the same bits). ``batch_shardings``: the axes the batch
    is split over, a subset of ``("dp", "sdp")`` (each rank feeds its own
    block). ``seed`` is kept for the reference's signature: nothing random
    runs in the step until dropout is ported. The knobs the port lacks
    raise ``NotImplementedError``."""

    def __init__(self, model, optimizer, loss_fn, mesh=None, state_shardings=None,
                 batch_shardings=None, remat=False, seed=0, amp_level=None, amp_dtype="bfloat16",
                 accumulate_steps=1, return_outputs=False, guard=None):
        if (state_shardings is not None or batch_shardings is not None) and mesh is None:
            raise ValueError("TrainStep: state_shardings and batch_shardings need a mesh")
        if batch_shardings is not None and (not set(batch_shardings) <= {"dp", "sdp"}):
            raise ValueError(f"TrainStep: batch_shardings must name axes of ('dp', 'sdp'), got "
                             f"{batch_shardings!r}")
        if int(accumulate_steps) < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
        if amp_level not in (None, "O0", "O1", "O2"):
            raise ValueError(f"amp_level must be None/'O0'/'O1'/'O2', got {amp_level!r}")
        if amp_level == "O1":
            raise NotImplementedError(_NOT_PORTED.format("amp_level='O1'", 6))
        self.amp_level = None if amp_level == "O0" else amp_level
        self.amp_dtype = getattr(torch, amp_dtype) if self.amp_level else None
        if self.amp_dtype == torch.float16:
            raise NotImplementedError(_NOT_PORTED.format("float16 AMP (GradScaler)", 6))
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.seed = seed
        self.remat = bool(remat) or flag("FLAGS_remat_policy") != "none"
        self.accumulate_steps = int(accumulate_steps)
        self.return_outputs = bool(return_outputs)
        self.device = next(model.parameters()).device
        self._param_names = {id(p): n for n, p in model.named_parameters()}
        self.mesh = mesh
        self.batch_shardings = tuple(batch_shardings or ("dp", "sdp"))
        self._reducer = self._zero = None
        self._gather = {}
        self.n_micro, self.schedule, self.last_schedule = 1, None, None
        self._pp_meta = {}
        self.guard = bool(flag("FLAGS_train_guard")) if guard is None else bool(guard)
        # chaos: NaN gradients at a dispatch, armed once per process (read at
        # construction, as the reference compiles it into its program)
        self._nan_chaos = chaos.nan_grads_due()
        self.chaos_nan_armed = 0 if self._nan_chaos is None else self._nan_chaos[1]
        self._dispatched = 0  # step + skipped: the monotonic dispatch counter
        self.skipped = 0  # settled bad steps
        self._pending = None  # the last step's bad flag, not read yet
        self._skipped_t = None  # the cumulative count on the device
        if mesh is not None:
            self._init_mesh(mesh, int(state_shardings or getattr(model, "_sharding_stage", 0)))

    def _init_mesh(self, mesh, stage):
        from ..distributed.parallel import _BucketReducer
        from ..distributed.sharding import ZeroPlan
        from ..distributed.topology import HybridCommunicateGroup

        if not isinstance(mesh, HybridCommunicateGroup):
            raise TypeError("TrainStep: mesh must be the fleet's HybridCommunicateGroup, got "
                            f"{type(mesh).__name__}")
        params = [p for p in self.model.parameters() if p.requires_grad]
        sep = mesh.get_sep_parallel_world_size()
        if sep > 1 and not getattr(self.model, "sequence_parallel", False):
            raise NotImplementedError(
                f"TrainStep: sep_degree {sep} cuts each row's sequence over ranks, which only "
                "GPT's stacked trunk runs (ROADMAP.md, Queue 1 item 13c)")
        if stage and (sep > 1 or any(hasattr(p, "expert_axis") for p in params)):
            raise NotImplementedError(_NOT_PORTED.format(
                "ZeRO together with sequence parallelism or a mixture of experts", "13c"))
        if stage:
            self._zero = ZeroPlan(params, stage, mesh, names=self._param_names)
            self.optimizer._shards = self._zero
            if stage == 3:
                self._gather = self._stage3_gathers()
        else:
            self._reducer = _BucketReducer(params, group=mesh.get_data_sharding_group(),
                                           names=self._param_names,
                                           sum_group=mesh.get_data_sep_group())
        if mesh.get_pipe_parallel_world_size() > 1:
            if self.accumulate_steps > 1:
                raise ValueError("TrainStep: with a pipeline the micro-batches are "
                                 "pipeline_configs.accumulate_steps; accumulate_steps must be 1")
            if self.return_outputs:
                raise NotImplementedError(_NOT_PORTED.format(
                    "return_outputs with a pipeline (the outputs live on the last stage)", "13c"))
            plan, n_micro = active_pipeline_plan()
            self.n_micro = n_micro if plan is not None else 2 * mesh.get_pipe_parallel_world_size()
            self.schedule = active_pipeline_schedule()

    def _stage3_gathers(self):
        """The split parameters the step gathers as its forward begins, by
        name: those of modules that do not gather their own
        (``zero_gathers_own``), which get theirs in ``_zero_parts``."""
        z = self._zero
        own = set()
        for prefix, mod in self.model.named_modules():
            if getattr(type(mod), "zero_gathers_own", False):
                mod._zero_parts = {n: (z.part(p), z.sdp) for n, p in mod.named_parameters(
                    recurse=False) if z.part(p) is not None}
                own |= {f"{prefix}.{n}" if prefix else n for n in mod._zero_parts}
        return {n: (z.part(p), z.sdp) for n, p in self.model.named_parameters()
                if z.part(p) is not None and n not in own}

    def _to_amp(self, t):
        return t.to(self.amp_dtype) if t.dtype == torch.float32 else t

    def _loss(self, inputs, labels):
        """``(loss, model outputs)`` of one (micro-)batch; the loss is None
        when ``labels`` is (a pipeline stage before the last)."""
        if self.amp_level == "O2" or self._gather:
            # cast the parameters only: the buffers run as they are, so an
            # in-place update in forward (a running statistic) lands in the
            # module's own buffer, as the reference's new_buffers do. The
            # casts (and at ZeRO stage 3 the gathers of the parameters whose
            # modules do not gather their own) are made here, outside a remat
            # block, and stay saved.
            from ..distributed.sharding import gather_param

            amp = self._to_amp if self.amp_level == "O2" else (lambda t: t)
            state = {n: gather_param(amp(p), *self._gather[n]) if n in self._gather else amp(p)
                     for n, p in self.model.named_parameters()}
            inputs = tuple(amp(x) for x in inputs)

            def call(*xs):
                return functional_call(self.model, state, xs)
        else:
            call = self.model

        def loss_of(*xs):
            out = call(*xs)
            return (None if labels is None else self.loss_fn(out, *labels)), out

        if self.remat:
            loss, out = recompute(loss_of, *inputs, policy="nothing_saveable", replay=self.model)
        else:
            loss, out = loss_of(*inputs)
        if loss is not None and loss.dtype == self.amp_dtype:
            loss = loss.float()
        return loss, out

    def _micro_weights(self, labels):
        """Each micro-batch's share of the batch's averaged loss terms (the
        loss's ``token_count``, or equal shares)."""
        count = getattr(self.loss_fn, "token_count", None)
        if count is None:
            return [1.0 / len(labels)] * len(labels)
        counts = [torch.as_tensor(count(*lb), dtype=torch.float32, device=self.device)
                  for lb in labels]
        total = torch.stack(counts).sum()
        return [c / total for c in counts]

    def _pipeline_pass(self, inputs, labels):
        """This stage's part of the pipeline schedule over the step's
        micro-batches; the batch's loss on every stage."""
        hcg = self.mesh
        group, stage = hcg.get_pipe_parallel_group(), hcg.get_pipe_parallel_rank()
        n_stages, n = hcg.get_pipe_parallel_world_size(), self.n_micro
        first, last = stage == 0, stage == n_stages - 1
        mb_in = [microbatch(x, n) for x in inputs]
        mb_lb = [microbatch(x, n) for x in labels]
        labels_of = [tuple(x[i].contiguous() for x in mb_lb) for i in range(n)]
        weights = self._micro_weights(labels_of) if last else None
        saved, losses = {}, []

        def forward(i, x):
            if first:
                xs = tuple(t[i].contiguous() for t in mb_in)
            else:
                xs = (x.requires_grad_(),)
            with compiled_step():
                loss, out = self._loss(xs, labels_of[i] if last else None)
                y = loss * weights[i] if last else out
            if last:
                losses.append(y.detach())
            saved[i] = (x, y)
            return None if last else y.detach()

        def backward(i, dy):
            x, y = saved.pop(i)
            with compiled_step():
                torch.autograd.backward(y, None if last else dy)
            return None if first else x.grad

        key = tuple(tuple(t.shape) for t in inputs)
        self.last_schedule = run_schedule(forward, backward, n, self.schedule, group, stage,
                                          n_stages, self._pp_meta.setdefault(key, {}), self.device)
        loss = torch.stack(losses).sum() if last else torch.zeros((), device=self.device)
        return C.broadcast(loss, src=n_stages - 1, group=group)

    def _step(self, inputs, labels):
        """One update; returns ``(loss, lr, outputs or None, health or None)``."""
        self.optimizer.clear_grad()
        inputs, labels = _as_tensors(inputs, self.device), _as_tensors(labels, self.device)
        # buffers updated in the forward go back with the rest on a bad step
        buffers = ([b.clone() for b in self.model.buffers()]
                   if self.guard and any(True for _ in self.model.buffers()) else None)
        if self.schedule is not None:
            was_training = self.model.training
            self.model.train()
            try:
                loss = self._pipeline_pass(inputs, labels)
            finally:
                self.model.train(was_training)
            return (*self._update(loss, buffers), None)
        k = self.accumulate_steps
        mb_in = [microbatch(x, k) for x in inputs]
        mb_lb = [microbatch(x, k) for x in labels]
        losses, outs = [], []
        was_training = self.model.training
        self.model.train()
        try:
            for i in range(k):
                with compiled_step():
                    loss, out = self._loss(tuple(x[i].contiguous() for x in mb_in),
                                           tuple(x[i].contiguous() for x in mb_lb))
                    loss.backward()  # adds this micro-batch's f32 gradients on the masters
                losses.append(loss.detach())
                outs.append(_tree_map(torch.Tensor.detach, out) if self.return_outputs else None)
                del loss, out
        finally:
            self.model.train(was_training)
        if k > 1:
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(k)
        loss, lr, health = self._update(torch.stack(losses).mean(), buffers)
        outputs = None
        if self.return_outputs:
            outputs = outs[0] if k == 1 else _stack_microbatches(*outs)
        return loss, lr, health, outputs

    def _grad_of(self, p):
        return p.grad if self._zero is None else self._zero.grad(p)

    def _update(self, loss, buffers=None):
        """The gradients (and ``loss``) averaged over the data group, the
        chaos NaN and the guard, the optimizer's update, and at ZeRO stages
        1-2 the parameters gathered; returns ``(averaged loss, lr, health
        or None)``."""
        shared = getattr(self.model, "allreduce_shared_weight_gradients", None)
        if shared is not None:
            shared()
        if self._zero is not None:
            loss = self._zero.reduce(extra=loss)
        elif self._reducer is not None:
            # the f32 master gradients and the loss averaged over the data group
            loss = self._reducer.reduce(find_unused_parameters=True, extra=loss)
        opt = self.optimizer
        if self._nan_chaos is not None and self.chaos_nan_armed > 0 \
                and self._dispatched >= self._nan_chaos[0]:
            self.chaos_nan_armed -= 1
            for p in opt._params:
                g = self._grad_of(p)
                if g is not None:
                    g.fill_(float("nan"))
        self._dispatched += 1
        health = bad = None
        if self.guard:
            bad, gnorm = self._health(loss)
            self._settle()  # the previous step's flag: this step's work is queued by now
            opt._ensure_state()
            kept = [opt._target(i) for i in range(len(opt._params))] + [
                t for ts in opt._state.values() for t in ts]
            snapshot = [t.clone() for t in kept]
        lr = opt.lr_at(opt._step_count)
        opt._traced_update(lr, self._param_names)
        if self.guard:
            with torch.no_grad():
                for t, old in zip(kept, snapshot):
                    t.copy_(torch.where(bad, old, t))
                if buffers is not None:
                    for b, old in zip(self.model.buffers(), buffers):
                        b.copy_(torch.where(bad, old, b))
            del snapshot
            opt._step_count -= 1  # counted when the flag is read (_settle)
            self._pending = bad
            self._skipped_t = self._skipped_count() + bad.to(torch.int32)
            health = {"bad_step": bad, "grad_norm": gnorm, "skipped": self._skipped_t}
        if self._zero is not None:
            self._zero.gather()
        return loss, lr, health

    def _skipped_count(self):
        if self._skipped_t is None:
            self._skipped_t = torch.tensor(self.skipped, dtype=torch.int32, device=self.device)
        return self._skipped_t

    @torch.no_grad()
    def _health(self, loss):
        """``(bad, global gradient norm)`` of this step, on the device: one
        f32 sum of squares over every gradient (shards summed over their
        groups), the flag reduced over the world under a mesh."""
        params = [p for p in self.optimizer._params if self._grad_of(p) is not None]
        terms = [self._grad_of(p).float().square().sum() for p in params]
        sumsq = _reduce_terms(terms, _shard_groups(params)) if terms else \
            torch.zeros((), device=self.device)
        bad = ~(torch.isfinite(sumsq) & torch.isfinite(loss.float()))
        if self.mesh is not None and get_world_size() > 1:
            flag_ = bad.to(torch.float32)
            C.all_reduce(flag_, op=C.ReduceOp.MAX)
            bad = flag_ > 0
        return bad, torch.sqrt(sumsq)

    def _settle(self):
        """Read the last step's bad flag (a host sync) into the step and
        skip counts."""
        if self._pending is None:
            return
        bad, self._pending = bool(self._pending), None
        if bad:
            self.skipped += 1
        else:
            self.optimizer._step_count += 1

    # -- state -----------------------------------------------------------------
    def _opt_names(self):
        opt = self.optimizer
        return [self._param_names.get(id(p), opt._names[i]) for i, p in enumerate(opt._params)]

    def _moe_layers(self):
        from ..distributed.moe import MoELayer

        return [(n, m) for n, m in self.model.named_modules() if isinstance(m, MoELayer)]

    @property
    def state(self):
        """The training state (see the module's docstring): detached views
        of the step's own tensors, not copies; this rank's pieces under a
        mesh."""
        from ..optimizer.lr import LRScheduler

        self._settle()
        opt = self.optimizer
        opt._ensure_state()
        names = self._opt_names()
        out = {"params": {n: p.detach() for n, p in self.model.named_parameters()},
               "buffers": {n: b.detach() for n, b in self.model.named_buffers()},
               "opt": {k: dict(zip(names, ts)) for k, ts in opt._state.items()},
               "step": int(opt._step_count)}
        if self.guard:
            out["skipped"] = int(self.skipped)
        if isinstance(opt._lr, LRScheduler):
            out["lr"] = opt._lr.state_dict()
        moe = self._moe_layers()
        if moe:
            rng = {}
            for n, m in moe:
                if m.generator is None:  # built on the meta device: as its forward makes it
                    m.generator = torch.Generator(device=m.w1.device).manual_seed(m.seed)
                rng[n] = m.generator.get_state()
            out["rng"] = rng
        return out

    @torch.no_grad()
    def load_state(self, state):
        """Put a state (:attr:`state`'s structure, host or device tensors) back
        into the model, the optimizer and the step's counters."""
        from ..optimizer.lr import LRScheduler

        params = dict(self.model.named_parameters())
        for n, v in state["params"].items():
            params[n].copy_(torch.as_tensor(v))
        buffers = dict(self.model.named_buffers())
        for n, v in state.get("buffers", {}).items():
            buffers[n].copy_(torch.as_tensor(v))
        opt = self.optimizer
        opt._ensure_state()
        index = {n: i for i, n in enumerate(self._opt_names())}
        for k, tree in state.get("opt", {}).items():
            for n, v in tree.items():
                opt._state[k][index[n]].copy_(torch.as_tensor(v))
        opt._step_count = int(state["step"])
        self.skipped = int(state.get("skipped", 0))
        self._pending, self._skipped_t = None, None
        self._dispatched = opt._step_count + self.skipped
        if "lr" in state and isinstance(opt._lr, LRScheduler):
            opt._lr.set_state_dict(dict(state["lr"]))
        if "rng" in state:
            layers = dict(self._moe_layers())
            for n, v in state["rng"].items():
                m = layers[n]
                if m.generator is None:
                    m.generator = torch.Generator(device=m.w1.device)
                m.generator.set_state(torch.as_tensor(v))

    def __call__(self, inputs, labels):
        """One step; returns ``{"loss": f32 scalar tensor, "lr": float}``,
        plus ``"health"`` with the guard and ``"outputs"`` with
        ``return_outputs``."""
        loss, lr, health, outputs = self._step(inputs, labels)
        metrics.counter_inc("train_step.dispatches")
        metrics.counter_inc("train_step.steps")
        result = {"loss": loss, "lr": lr}
        if health is not None:
            result["health"] = health
        if self.return_outputs:
            result["outputs"] = outputs
        return result

    def run_steps(self, batches, k=None):
        """k steps: ``batches`` is k ``(inputs, labels)`` pairs (``k`` may be
        omitted), or one pair whose tensors carry a leading ``[k, ...]`` axis
        (then ``k`` is given). Returns the metrics stacked ``[k]``."""
        if k is None:
            batches = list(batches)
            if not batches:
                raise ValueError("run_steps needs at least one batch")
        else:
            k = int(k)
            inputs, labels = (_as_tensors(x, self.device) for x in batches)
            for t in inputs + labels:
                if t.shape[:1] != (k,):
                    raise ValueError(f"pre-stacked batch leaf has leading dim {tuple(t.shape[:1])}, "
                                     f"expected ({k},)")
            batches = [(tuple(t[i] for t in inputs), tuple(t[i] for t in labels)) for i in range(k)]
        # every batch on the device before the first step: a copy from host
        # memory waits for the card, so copies between steps would hold each
        # step's launches back until the previous step had run
        batches = [(_as_tensors(i, self.device), _as_tensors(l, self.device)) for i, l in batches]
        results = [self._step(i, l) for i, l in batches]
        metrics.counter_inc("train_step.dispatches")
        metrics.counter_inc("train_step.steps", len(results))
        out = {"loss": torch.stack([r[0] for r in results]),
               "lr": torch.tensor([r[1] for r in results], dtype=torch.float32)}
        if self.guard:
            out["health"] = {k: torch.stack([r[2][k] for r in results])
                             for k in ("bad_step", "grad_norm", "skipped")}
        if self.return_outputs:
            out["outputs"] = _tree_map(lambda *xs: torch.stack(xs), *(r[3] for r in results))
        # judgment layer: a single flag check per call until FLAGS_slo arms it
        slo.on_tick()
        return out


class MultiStepRunner:
    """Amortized training loop over a batch stream
    (``paddle_tpu/jit/__init__.py:MultiStepRunner``): groups every K
    batches and runs them through :meth:`TrainStep.run_steps`.

    ``batch_iter`` yields per-step ``(inputs, labels)`` batches; with
    ``prestacked=True`` it yields ``[k, ...]``-stacked pairs. Iterating the
    runner yields one stacked metrics dict per group; a trailing group
    smaller than K still runs.

    ``monitor`` (a :class:`paddle_tpu_torch.stability.HealthMonitor`) makes
    the runner health-aware: every group's stacked metrics are fed to the
    monitor, which handles periodic checkpointing and divergence rollback
    (restoring the step in place — the stream just keeps going with the
    rewound state). One observe per K steps.
    """

    def __init__(self, step: TrainStep, k: int, prestacked: bool = False, monitor=None):
        if int(k) < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.step = step
        self.k = int(k)
        self.prestacked = prestacked
        self.monitor = monitor
        if monitor is not None and monitor.train_step is None:
            monitor.train_step = step

    def _emit(self, metrics_):
        if self.monitor is not None:
            self.monitor.observe(metrics_)
        return metrics_

    def run(self, batch_iter):
        if self.prestacked:
            for inputs, labels in batch_iter:
                lead = (inputs[0] if isinstance(inputs, (list, tuple)) else inputs).shape[0]
                yield self._emit(self.step.run_steps((inputs, labels), k=lead))
            return
        group = []
        for batch in batch_iter:
            group.append(batch)
            if len(group) == self.k:
                yield self._emit(self.step.run_steps(group))
                group = []
        if group:
            yield self._emit(self.step.run_steps(group))

    __call__ = run

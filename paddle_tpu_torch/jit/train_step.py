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
"""
from __future__ import annotations

import torch
from torch.func import functional_call

from ..distributed import collective as C
from ..distributed.pipeline import (active_pipeline_plan, active_pipeline_schedule, microbatch,
                                    run_schedule, unmicrobatch)
from ..distributed.recompute import recompute
from ..framework.flags import flag
from ..framework.selected_rows import compiled_step
from ..observability import metrics, slo

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
        if guard:
            raise NotImplementedError(_NOT_PORTED.format("guard", 6))
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
        """One update; returns ``(loss, lr, outputs or None)``."""
        lr = self.optimizer.lr_at(self.optimizer._step_count)
        self.optimizer.clear_grad()
        inputs, labels = _as_tensors(inputs, self.device), _as_tensors(labels, self.device)
        if self.schedule is not None:
            was_training = self.model.training
            self.model.train()
            try:
                loss = self._pipeline_pass(inputs, labels)
            finally:
                self.model.train(was_training)
            return self._update(loss, lr), lr, None
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
        loss = self._update(torch.stack(losses).mean(), lr)
        outputs = None
        if self.return_outputs:
            outputs = outs[0] if k == 1 else _stack_microbatches(*outs)
        return loss, lr, outputs

    def _update(self, loss, lr):
        """The gradients (and ``loss``) averaged over the data group, the
        optimizer's update, and at ZeRO stages 1-2 the parameters gathered;
        returns the averaged loss."""
        shared = getattr(self.model, "allreduce_shared_weight_gradients", None)
        if shared is not None:
            shared()
        if self._zero is not None:
            loss = self._zero.reduce(extra=loss)
        elif self._reducer is not None:
            # the f32 master gradients and the loss averaged over the data group
            loss = self._reducer.reduce(find_unused_parameters=True, extra=loss)
        self.optimizer._traced_update(lr, self._param_names)
        if self._zero is not None:
            self._zero.gather()
        return loss

    def __call__(self, inputs, labels):
        """One step; returns ``{"loss": f32 scalar tensor, "lr": float}``,
        plus ``"outputs"`` with ``return_outputs``."""
        loss, lr, outputs = self._step(inputs, labels)
        metrics.counter_inc("train_step.dispatches")
        metrics.counter_inc("train_step.steps")
        result = {"loss": loss, "lr": lr}
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
        if self.return_outputs:
            out["outputs"] = _tree_map(lambda *xs: torch.stack(xs), *(r[2] for r in results))
        # judgment layer: a single flag check per call until FLAGS_slo arms it
        slo.on_tick()
        return out

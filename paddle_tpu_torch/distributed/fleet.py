"""Fleet orchestration of the port (``paddle_tpu/distributed/fleet.py``;
parity: python/paddle/distributed/fleet/base/fleet_base.py, fleet.init:210,
distributed_model:946, save_persistables:833).

The reference's ``fleet.distributed_step`` compiles one GSPMD program whose
shardings carry every parallelism, and XLA inserts the collectives. The
port's runs one process per rank: ``fleet.init`` joins the world and lays
the ranks on the hybrid grid (:mod:`.topology`); the model's
tensor-parallel layers hold their shards and run their own collectives
(:mod:`.mp_layers`); ``distributed_step`` is a ``TrainStep`` over the
grid, which averages the f32 master gradients over the data group (``dp``
x ``sdp``) before the update, at the strategy's ZeRO stage
(:mod:`.sharding`), and at ``pp > 1`` runs the pipeline schedule
(:mod:`.pipeline`); ``shard_batch`` gives each rank its block of the
global batch. At a sequence degree above 1 ``shard_batch`` also gives
each ``sep`` rank its block of the sequence, and the step sums a
replicated parameter's gradient over ``sep`` (:mod:`.ring_attention`; GPT's
stacked trunk exchanges its heads by Ulysses).
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import torch

from .env import get_device, get_rank, get_world_size, init_parallel_env
from .strategy import DistributedStrategy
from .topology import HybridCommunicateGroup


class Fleet:
    def __init__(self):
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._is_initialized = False
        self._batch_axes = ("dp", "sdp")

    # -- lifecycle ---------------------------------------------------------
    def init(self, role_maker=None, is_collective=True, strategy=None, device=None):
        """Join the world (:func:`~.env.init_parallel_env` on ``device``) and
        build the hybrid grid of ``strategy.hybrid_configs`` (``dp``,
        ``mp``, ``pp``, ``sharding`` and ``sep`` degrees); ``mp_degree``
        comes from ``tensor_parallel_configs`` when ``hybrid_configs`` leaves
        it at 1, and ``tensor_parallel_configs.tensor_init_seed`` (if set)
        seeds the model-parallel RNG stream."""
        self._strategy = strategy or DistributedStrategy()
        self._batch_axes = ("dp", "sdp")
        hc = self._strategy.hybrid_configs
        tp = self._strategy.tensor_parallel_configs
        mp_degree = hc.mp_degree if hc.mp_degree > 1 else int(tp.tensor_parallel_degree)
        init_parallel_env(device=device)
        self._hcg = HybridCommunicateGroup(dp_degree=hc.dp_degree, mp_degree=mp_degree,
                                           pp_degree=hc.pp_degree,
                                           sharding_degree=hc.sharding_degree,
                                           sep_degree=hc.sep_degree)
        if int(tp.tensor_init_seed) >= 0:
            from .mp_layers import get_rng_state_tracker

            get_rng_state_tracker().add("model_parallel_rng", int(tp.tensor_init_seed))
        self._is_initialized = True
        return self

    def is_first_worker(self):
        return get_rank() == 0

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def barrier_worker(self):
        from .env import is_initialized

        if is_initialized():
            torch.distributed.barrier()

    def get_hybrid_communicate_group(self):
        return self._hcg

    # -- model/optimizer wrappers (paddle API parity) ----------------------
    def distributed_model(self, model):
        """The model itself, as in the reference: its tensor-parallel layers
        already hold their shards, and ``distributed_step`` reduces the
        gradients."""
        model._fleet = self
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        optimizer._fleet = self
        return optimizer

    # -- the training entry ------------------------------------------------
    def distributed_step(self, model, optimizer, loss_fn, seed=0, batch_sharding=None):
        """A ``TrainStep`` over the hybrid grid, per the active strategy:
        ``amp_configs`` (O2 bf16; float16 raises), ``recompute`` /
        ``recompute_configs.enable``, ``gradient_merge`` and, at pp 1,
        ``pipeline_configs.accumulate_steps`` as micro-batches (at pp > 1
        the pipeline's, with ``pipeline_configs.schedule``), and the ZeRO
        stage ``sharding_configs.sharding_stage`` when ``sharding`` is on or
        ``sharding_degree`` is above 1 (or the stage
        ``group_sharded_parallel`` recorded), with its optimizer state in
        pinned host memory under ``sharding_configs.offload``.
        ``batch_sharding``: the axes :meth:`shard_batch` splits the
        batch over, a subset of ``("dp", "sdp")`` (default both). Feed it
        :meth:`shard_batch`'s blocks."""
        from ..jit import TrainStep

        if self._hcg is None:
            raise RuntimeError("call fleet.init(strategy=...) first")
        strat = self._strategy
        # strategy.sharding names the stage; else group_sharded_parallel's
        # record; else a sharding degree above 1 takes the strategy's default
        stage = getattr(model, "_sharding_stage", 0)
        if strat.sharding or (not stage and strat.hybrid_configs.sharding_degree > 1):
            stage = int(strat.sharding_configs.sharding_stage)
        if stage and strat.sharding_configs.offload:
            model._sharding_offload = optimizer._sharding_offload = True
        axes = tuple(batch_sharding) if batch_sharding is not None else ("dp", "sdp")
        if not axes or not set(axes) <= {"dp", "sdp"}:
            raise ValueError(f"batch_sharding must name axes of ('dp', 'sdp'), got {axes!r}")
        self._batch_axes = tuple(a for a in ("dp", "sdp") if a in axes)
        if not strat.sharding_configs.comm_overlap:
            warnings.warn(
                "sharding_configs.comm_overlap=False has no effect: the gradient buckets are "
                "reduced after the backward, with no communication stream to overlap")
        remat = strat.recompute or strat.recompute_configs.enable
        amp_level = strat.amp_configs.level if (strat.amp or strat.amp_configs.enable) else None
        amp_dtype = strat.amp_configs.dtype if amp_level else "bfloat16"
        if amp_level and str(amp_dtype) in ("float16", "fp16"):
            raise ValueError(
                "strategy amp with float16 needs loss scaling "
                f"(init_loss_scaling={strat.amp_configs.init_loss_scaling}, "
                f"dynamic={strat.amp_configs.use_dynamic_loss_scaling}) which "
                "the fused TrainStep does not implement — use bfloat16 "
                "(TPU-native, no scaling needed) or the eager amp.GradScaler "
                "path")
        accumulate = 1
        if strat.gradient_merge:
            accumulate = int(strat.gradient_merge_configs.get("k_steps", 1))
        elif strat.hybrid_configs.pp_degree == 1:
            # pipeline_configs.accumulate_steps doubles as gradient accumulation
            # when there is no pipeline to micro-batch (the reference's semantics)
            accumulate = int(strat.pipeline_configs.accumulate_steps)
        return TrainStep(model, optimizer, loss_fn, mesh=self._hcg, remat=remat, seed=seed,
                         amp_level=amp_level, amp_dtype=amp_dtype, accumulate_steps=accumulate,
                         state_shardings=stage or None, batch_shardings=self._batch_axes)

    def shard_batch(self, *arrays):
        """This rank's block of each global batch leaf: with ``n`` the size
        of the data axes (``dp`` x ``sdp``, or those ``batch_sharding``
        named) and ``r = dp_rank * sdp + sdp_rank`` this rank's index over
        them, rows ``[r * B / n, (r + 1) * B / n)`` of dim 0, the block
        GSPMD's ``P(("dp", "sdp"))`` gives it (the ranks of one mp group
        and of one pipeline get the same block), on this rank's device. At
        a sequence degree m above 1, a leaf of two or more dims is also
        cut along dim 1: ``sep`` rank j gets positions ``[j * S / m, (j +
        1) * S / m)``, the block of ``P(("dp", "sdp"), "sep")``
        (``paddle_tpu/models/gpt.py:343``)."""
        if self._hcg is None:
            raise RuntimeError("call fleet.init(strategy=...) first")
        hcg = self._hcg
        sizes = {"dp": hcg.get_data_parallel_world_size(),
                 "sdp": hcg.get_sharding_parallel_world_size()}
        ranks = {"dp": hcg.get_data_parallel_rank(), "sdp": hcg.get_sharding_parallel_rank()}
        n, r = 1, 0
        for axis in self._batch_axes:
            n, r = n * sizes[axis], r * sizes[axis] + ranks[axis]
        names = " x ".join(f"{a} {sizes[a]}" for a in self._batch_axes)
        m, j = hcg.get_sep_parallel_world_size(), hcg.get_sep_parallel_rank()
        device = get_device()
        out = []
        for a in arrays:
            t = torch.as_tensor(a)
            if t.ndim == 0 or t.shape[0] % n:
                raise ValueError(f"shard_batch: a leaf of shape {tuple(t.shape)} does not split "
                                 f"over {names} along dim 0")
            b = t.shape[0] // n
            t = t[r * b:(r + 1) * b]
            if m > 1 and t.ndim >= 2:
                if t.shape[1] % m:
                    raise ValueError(f"shard_batch: a leaf of shape {tuple(a.shape)} does not "
                                     f"split over sep {m} along dim 1")
                c = t.shape[1] // m
                t = t[:, j * c:(j + 1) * c]
            out.append(t.contiguous().to(device))
        return tuple(out) if len(out) > 1 else out[0]

    # -- save/load (parity: fleet_base.py:795,833) -------------------------
    def save_persistables(self, executor_or_model, dirname, **kwargs):
        """``model.state_dict()`` to ``dirname/model.pdparams``, written by
        rank 0 only (at mp > 1 that is mp rank 0's shards; see
        :func:`paddle_tpu_torch.utils.convert.gather_state`)."""
        if get_rank() != 0:
            return
        os.makedirs(dirname, exist_ok=True)
        torch.save(executor_or_model.state_dict(), os.path.join(dirname, "model.pdparams"))

    def save_inference_model(self, model, dirname, input_spec=None, **kwargs):
        raise NotImplementedError(
            "save_inference_model (jit.save) is not ported yet (ROADMAP.md, Queue 1 item 14)")


fleet = Fleet()

"""DistributedStrategy of the port (``paddle_tpu/distributed/strategy.py``,
parity: the protobuf-backed config in
python/paddle/distributed/fleet/base/distributed_strategy.py).

A copy of the reference's dataclass tree (the port imports nothing of
``paddle_tpu``): the same knobs, hybrid degrees, sharding, amp, recompute,
pipeline micro-batching and tensor parallelism, and the same
dict-assignment ``__setattr__`` (``strategy.hybrid_configs = {"dp_degree":
2}`` sets the named fields of the config in place).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class HybridConfig:
    dp_degree: int = 1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1  # sequence/context parallel (green-field; absent in ref)
    ep_degree: int = 1  # expert parallel


@dataclass
class ShardingConfig:
    sharding_stage: int = 1  # ZeRO stage 1/2/3
    offload: bool = False
    comm_overlap: bool = True


@dataclass
class AmpConfig:
    enable: bool = False
    dtype: str = "bfloat16"
    level: str = "O1"
    init_loss_scaling: float = 32768.0
    use_dynamic_loss_scaling: bool = True


@dataclass
class RecomputeConfig:
    enable: bool = False
    checkpoints: Optional[list] = None


@dataclass
class PipelineConfig:
    accumulate_steps: int = 1  # micro-batches
    schedule: str = "gpipe"  # gpipe | 1f1b (memory schedule hint)


@dataclass
class TensorParallelConfig:
    tensor_parallel_degree: int = 1
    tensor_init_seed: int = -1


@dataclass
class DistributedStrategy:
    hybrid_configs: HybridConfig = field(default_factory=HybridConfig)
    sharding_configs: ShardingConfig = field(default_factory=ShardingConfig)
    amp_configs: AmpConfig = field(default_factory=AmpConfig)
    recompute_configs: RecomputeConfig = field(default_factory=RecomputeConfig)
    pipeline_configs: PipelineConfig = field(default_factory=PipelineConfig)
    tensor_parallel_configs: TensorParallelConfig = field(default_factory=TensorParallelConfig)
    amp: bool = False
    recompute: bool = False
    sharding: bool = False
    gradient_merge: bool = False
    gradient_merge_configs: dict = field(default_factory=lambda: {"k_steps": 1})
    find_unused_parameters: bool = False

    def _set(self, name, value):
        # paddle lets users assign dicts to *_configs; accept both
        if isinstance(value, dict):
            cfg = getattr(self, name)
            for k, v in value.items():
                setattr(cfg, k, v)
        else:
            object.__setattr__(self, name, value)

    def __setattr__(self, name, value):
        if name.endswith("_configs") and isinstance(value, dict) and hasattr(self, name):
            cfg = getattr(self, name)
            for k, v in value.items():
                if hasattr(cfg, k):
                    setattr(cfg, k, v)
            return
        object.__setattr__(self, name, value)

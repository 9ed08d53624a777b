"""Distributed layer of the port (``paddle_tpu/distributed``): the process
environment, the hybrid topology, eager collectives and point-to-point
sends over ``torch.distributed``, ``DataParallel``, the tensor-parallel
layers, ZeRO sharding (``sharding``), the pipeline (``pipeline``),
``fleet`` (``init``, ``distributed_step``, ``shard_batch``), the
mixture-of-experts layer with its experts over ``dp`` (``moe``, the
exchanges ``utils.global_scatter``/``global_gather``), sequence parallelism
over ``sep`` (``ring_attention``: ring and Ulysses attention), the host
actor runtime (``fleet_executor``) and the recommender's embedding table
in its single-shard form (``embedding``), checkpoints (``checkpoint``,
``converter``: written whole, restored onto any mesh), the fault-tolerant
runtime (``resilience``: ``CheckpointManager``, ``watchdog``,
``run_resilient``), elastic membership (``elastic``) and the launcher
(``launch``). The sharded embedding's exchange waits for a later slice
(ROADMAP.md, Queue 1 item 13d)."""
from . import fleet as fleet_mod  # noqa: F401
from . import utils  # noqa: F401
from .collective import (  # noqa: F401
    Group,
    ReduceOp,
    all_gather,
    all_gather_concat,
    all_reduce,
    all_to_all,
    alltoall,
    barrier,
    broadcast,
    get_group,
    new_group,
    p2p,
    ppermute,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    wait,
)
from .env import ParallelEnv, get_rank, get_world_size, init_parallel_env  # noqa: F401
from .fleet import Fleet, fleet  # noqa: F401
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    TensorParallel,
    VocabParallelEmbedding,
    get_rng_state_tracker,
)
from .fleet_executor import Carrier, FleetExecutor, TaskNode  # noqa: F401
from .moe import MoELayer  # noqa: F401
from .parallel import DataParallel, spawn  # noqa: F401
from .pipeline import (  # noqa: F401
    LayerDesc,
    PipelineLayer,
    SegmentLayers,
    SharedLayerDesc,
    pipeline_forward,
    run_schedule,
)
from .resilience import (CheckpointCorruption, CheckpointManager, WorkerFault,  # noqa: F401
                         run_resilient, watchdog)
from .ring_attention import ring_attention, ulysses_attention  # noqa: F401
from .sharding import ZeroPlan, group_sharded_parallel, state_shardings  # noqa: F401
from .strategy import DistributedStrategy  # noqa: F401
from .topology import AXES, CommunicateTopology, HybridCommunicateGroup, build_mesh  # noqa: F401
from .utils import global_gather, global_scatter  # noqa: F401

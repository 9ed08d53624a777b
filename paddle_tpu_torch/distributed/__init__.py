"""Distributed layer of the port (``paddle_tpu/distributed``): the process
environment, the hybrid topology, eager collectives over
``torch.distributed``, ``DataParallel``, the tensor-parallel layers,
``fleet`` (``init``, ``distributed_step``, ``shard_batch``), plus the
mixture-of-experts layer (``moe``) and the recommender's embedding table
in its single-shard form (``embedding``). ZeRO sharding, the pipeline and
the launcher wait for later slices (ROADMAP.md, Queue 1 items 13b-13d)."""
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
from .parallel import DataParallel, spawn  # noqa: F401
from .strategy import DistributedStrategy  # noqa: F401
from .topology import AXES, CommunicateTopology, HybridCommunicateGroup, build_mesh  # noqa: F401

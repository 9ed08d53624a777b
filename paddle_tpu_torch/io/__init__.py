"""The input pipeline of the port (``paddle_tpu/io``; parity:
python/paddle/io): datasets and samplers, the DataLoader with thread and
process workers and device prefetch, and the native record feed."""
from .dataloader import DataLoader, default_collate_fn, stack_batches  # noqa: F401
from .mp_worker import WorkerInfo, get_worker_info  # noqa: F401
from .dataset import (  # noqa: F401
    BatchSampler,
    ChainDataset,
    ComposeDataset,
    ConcatDataset,
    Dataset,
    DistributedBatchSampler,
    IterableDataset,
    RandomSampler,
    Sampler,
    SequenceSampler,
    Subset,
    TensorDataset,
    WeightedRandomSampler,
    random_split,
)
from .record_feed import RecordFileLoader, RecordSchema  # noqa: F401

"""Datasets and samplers of the port (``paddle_tpu/io/dataset.py``; parity:
python/paddle/fluid/dataloader/{dataset,batch_sampler,sampler}.py).

The reference's random samplers draw from numpy's global stream; here each
takes an explicit ``generator``: a ``numpy.random.RandomState``, an int seed
for one, or None, which derives one from :func:`paddle_tpu_torch.seed`
(:func:`paddle_tpu_torch.framework.random.host_generator`, one stream per
sampler kind). A ``RandomState`` seeded as the reference's global stream
gives the reference's permutations and draws, call for call.
``DistributedBatchSampler`` shuffles with ``RandomState(epoch)``, as the
reference does.
"""
from __future__ import annotations

import bisect

import numpy as np

from ..framework.random import host_generator


def as_random_state(generator, tag: str) -> np.random.RandomState:
    """``generator`` as a ``numpy.random.RandomState``: itself, one seeded
    with an int, or (None) one derived from the port's seed and ``tag``."""
    if isinstance(generator, np.random.RandomState):
        return generator
    if generator is None:
        return np.random.RandomState(int(host_generator(tag).integers(2 ** 32)))
    if isinstance(generator, (int, np.integer)):
        return np.random.RandomState(int(generator))
    raise TypeError(f"generator must be a numpy.random.RandomState, an int seed or None, got "
                    f"{type(generator).__name__}")


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Sample ``i`` is ``tuple(t[i] for t in tensors)`` (arrays or
    tensors)."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self._cum[-1]

    def __getitem__(self, idx):
        di = bisect.bisect_right(self._cum, idx)
        prev = 0 if di == 0 else self._cum[di - 1]
        return self.datasets[di][idx - prev]


class ConcatDataset(ChainDataset):
    pass


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint :class:`Subset` s of the given lengths over one permutation
    drawn from ``generator``."""
    n = len(dataset)
    if sum(lengths) != n:
        raise ValueError("sum of lengths must equal dataset size")
    perm = as_random_state(generator, "io.random_split").permutation(n)
    out, off = [], 0
    for length in lengths:
        out.append(Subset(dataset, perm[off:off + length].tolist()))
        off += length
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation (or, with ``replacement``, ``num_samples`` uniform
    draws) from ``generator`` each iteration."""

    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)
        self.generator = as_random_state(generator, "io.RandomSampler")

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(self.generator.randint(0, n, self.num_samples).tolist())
        return iter(self.generator.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True, generator=None):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = as_random_state(generator, "io.WeightedRandomSampler")

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(self.generator.choice(len(p), self.num_samples, replace=self.replacement,
                                          p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Parity: python/paddle/fluid/dataloader/batch_sampler.py. ``generator``
    feeds the :class:`RandomSampler` that ``shuffle`` makes."""

    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1, drop_last=False,
                 generator=None):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset, generator=generator)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """This rank's share of the index space (parity:
    python/paddle/fluid/dataloader/batch_sampler.py DistributedBatchSampler):
    the indices, shuffled by ``RandomState(epoch)`` with ``shuffle``, padded
    to a multiple of the replicas and strided by rank. ``num_replicas`` and
    ``rank`` default to the port's world (``distributed.env``)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False,
                 drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle
        if num_replicas is None or rank is None:
            from ..distributed.env import get_rank, get_world_size

            num_replicas = num_replicas if num_replicas is not None else get_world_size()
            rank = rank if rank is not None else get_rank()
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        n = len(dataset)
        self.num_samples = (n + self.nranks - 1) // self.nranks
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[:self.total_size - n]  # pad to divide evenly, as Paddle does
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

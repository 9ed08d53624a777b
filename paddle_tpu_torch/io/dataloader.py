"""DataLoader of the port (``paddle_tpu/io/dataloader.py``; parity:
python/paddle/fluid/reader.py:275 and dataloader_iter.py).

Batches are made on the host: serially, in thread workers (numpy and
torch's CPU ops release the GIL) or, with ``worker_mode="process"``, in
forked worker processes (:mod:`.mp_worker`) for GIL-bound pipelines.
``default_collate_fn`` returns torch tensors on the CPU.

``use_buffer_reader`` (on by default) feeds the card one batch ahead when
the loader's ``device`` is CUDA (the default; ``device="cpu"`` makes no
copy): each batch's tensors are pinned (process workers hand them over
pinned already) and copied with ``non_blocking=True`` on a side stream; the
batch is handed out after the consumer's stream waits on the copy's event,
and each tensor ``record_stream``s the consumer's stream, so its memory is
not reused while the step that reads it runs. ``fuse_steps=k`` yields
``[k, ...]`` stacks for ``TrainStep.run_steps(stack, k=k)`` instead, one
copy per stack. The spans ``dataloader.fetch`` (a batch's samples and
collate), ``dataloader.prefetch`` (the consumer waiting on a worker) and
``dataloader.device_put`` (issuing a copy), and the counters
``dataloader.batches``, ``dataloader.device_puts`` and
``dataloader.bad_batches`` are the reference's.

``FLAGS_dataloader_max_bad_batches > 0`` skips a batch whose sample or
collate raised, up to that many an iteration, with a ``bad_batch`` run-log
event each.
"""
from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..framework.device import resolve_device
from ..framework.flags import flag
from ..observability import runlog
from ..observability.metrics import counter_inc as _counter_inc
from ..observability.spans import span as _span
from .dataset import BatchSampler, IterableDataset, as_random_state

# sentinel flowing through the worker and iterator plumbing in place of a
# batch whose sample or collate raised (FLAGS_dataloader_max_bad_batches > 0);
# the consumer-facing iterator filters it out
_SKIPPED_BATCH = object()


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    return [tree]


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _pinned(x):
    t = _as_tensor(x)
    return t if t.is_pinned() else t.pin_memory()


class _DevicePut:
    """Host batches to ``device``, each copy issued one batch ahead of the
    consumer (see the module's docstring)."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def put(self, batch):
        with _span("dataloader.device_put"):
            _counter_inc("dataloader.device_puts")
            host = _tree_map(_pinned, batch)
            # the copy does not wait for the consumer's queued steps: it
            # reads fresh host memory into memory of the side stream's own
            with torch.cuda.stream(self.stream):
                out = _tree_map(lambda t: t.to(self.device, non_blocking=True), host)
                event = torch.cuda.Event()
                event.record(self.stream)
            return out, event

    def take(self, pending):
        out, event = pending
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for t in _leaves(out):
            t.record_stream(consumer)
        return out

    def __call__(self, it):
        prev = None
        for batch in it:
            nxt = self.put(batch)
            if prev is not None:
                yield self.take(prev)
            prev = nxt
        if prev is not None:
            yield self.take(prev)


def device_prefetch(it, device):
    """``it``'s batches on the CUDA ``device``, each copied one batch ahead;
    ``it`` itself for a CPU device."""
    device = torch.device(device)
    return _DevicePut(device)(it) if device.type == "cuda" else it


def stack_batches(it, k, to_device=True, device=None):
    """Group every ``k`` consecutive batches of ``it`` into one
    ``[k, ...]``-stacked batch, the feed of ``TrainStep.run_steps(stack,
    k=k)`` and ``MultiStepRunner(prestacked=True)``. Stacking happens on the
    host; with ``to_device`` each stack is copied to ``device`` (the CUDA
    card by default) one stack ahead. A batch of another shape (a
    ``drop_last=False`` remainder) starts a new group, and a trailing group
    shorter than ``k`` is still yielded."""
    k = int(k)
    if k < 1:
        raise ValueError(f"stack_batches needs k >= 1, got {k}")

    def sig(batch):
        return tuple(tuple(np.shape(leaf)) for leaf in _leaves(batch))

    def stack(group):
        return _tree_map(lambda *xs: torch.stack([_as_tensor(x) for x in xs]), *group)

    def stacks():
        group = []
        for batch in it:
            if group and sig(batch) != sig(group[0]):
                yield stack(group)
                group = []
            group.append(batch)
            if len(group) == k:
                yield stack(group)
                group = []
        if group:
            yield stack(group)

    if not to_device:
        return stacks()
    return device_prefetch(stacks(), resolve_device(device))


def default_collate_fn(batch):
    """Samples to one batch, structure kept: arrays and tensors stacked,
    ints as int64, floats as float32, all torch tensors on the CPU."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn([b[i] for b in batch]) for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, torch.Tensor):
        return torch.stack([b.detach().cpu() for b in batch])
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, dtype=np.float32))
    return torch.from_numpy(np.stack([np.asarray(b) for b in batch]))


class DataLoader:
    """Batches of ``dataset`` (map-style through ``batch_sampler``, or an
    ``IterableDataset`` in order).

    ``num_workers > 0`` runs thread workers by default;
    ``worker_mode="process"`` runs forked worker processes with a
    shared-memory transport, the reference's multiprocess architecture
    (dataloader_iter.py:342), with ``persistent_workers``, ``timeout`` and
    ``worker_init_fn``. ``generator`` (a ``numpy.random.RandomState``, an int
    seed or None for one derived from :func:`paddle_tpu_torch.seed`) draws
    the shuffle's permutations and the process workers' base seed.
    ``device``: where batches go with ``use_buffer_reader`` (the CUDA card
    unless ``device="cpu"``; without a CUDA device that raises)."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True, batch_sampler=None,
                 batch_size=1, shuffle=False, drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False, worker_mode="thread",
                 fuse_steps=None, generator=None, device=None):
        self.dataset = dataset
        self.device = resolve_device(device)
        # fuse_steps=K: [K, ...] stacks (one per K steps) for
        # TrainStep.run_steps instead of single batches
        self.fuse_steps = int(fuse_steps) if fuse_steps else None
        if self.fuse_steps is not None and self.fuse_steps < 1:
            raise ValueError(f"fuse_steps must be >= 1, got {fuse_steps}")
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1)
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', got {worker_mode!r}")
        self.worker_mode = worker_mode
        self.generator = as_random_state(generator, "io.DataLoader")
        self._pool = None  # the persistent WorkerPool (process mode)
        self._bad_count = 0  # batches skipped this iteration (poison samples)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
            if worker_mode == "process":
                raise ValueError("worker_mode='process' needs a map-style "
                                 "dataset (IterableDataset iterates in-order "
                                 "in the main process; use threads)")
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle, batch_size=batch_size,
                                              drop_last=drop_last, generator=self.generator)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("length of IterableDataset loader is unknown")
        return len(self.batch_sampler)

    def _fetch(self, indices):
        try:
            with _span("dataloader.fetch"):
                batch = self.collate_fn([self.dataset[i] for i in indices])
        except Exception as exc:
            return self._bad_batch(exc, indices=list(indices))
        _counter_inc("dataloader.batches")
        return batch

    def _bad_batch(self, exc, **info):
        """Poison-sample resilience (FLAGS_dataloader_max_bad_batches > 0):
        a sample or collate exception yields a skip sentinel, bounded per
        iteration, instead of killing the iterator mid-epoch."""
        limit = int(flag("FLAGS_dataloader_max_bad_batches"))
        if limit <= 0:
            raise exc
        self._bad_count += 1
        _counter_inc("dataloader.bad_batches")
        runlog.emit("bad_batch", count=self._bad_count, limit=limit,
                    error=f"{type(exc).__name__}: {exc}", **info)
        if self._bad_count > limit:
            raise RuntimeError(
                f"DataLoader: {self._bad_count} bad batches in one iteration "
                f"exceeds FLAGS_dataloader_max_bad_batches={limit}") from exc
        return _SKIPPED_BATCH

    def _to_card(self):
        return self.use_buffer_reader and self.device.type == "cuda"

    def __iter__(self):
        self._bad_count = 0  # the bad-batch budget is per iteration
        if self._iterable_mode:
            it = self._iter_iterable()
        elif self.num_workers == 0:
            it = (self._fetch(indices) for indices in self.batch_sampler)
        elif self.worker_mode == "process":
            it = self._iter_multiprocess()
        else:
            it = self._iter_threaded()
        it = (b for b in it if b is not _SKIPPED_BATCH)
        if self.fuse_steps is not None:
            # one copy per K batches, still one stack ahead
            it = stack_batches(it, self.fuse_steps, to_device=self._to_card(), device=self.device)
        elif self._to_card():
            it = device_prefetch(it, self.device)
        yield from it

    def _iter_multiprocess(self):
        from .mp_worker import WorkerPool

        # the epoch's order first, then a new pool's base seed: the shuffle
        # draws from the generator as in the serial and thread modes
        batches = list(self.batch_sampler)
        pool = self._pool
        if pool is None or pool._closed:
            pool = WorkerPool(self.dataset, self.collate_fn, self.num_workers,
                              worker_init_fn=self.worker_init_fn, use_shm=self.use_shared_memory,
                              timeout=self.timeout, prefetch_factor=self.prefetch_factor,
                              base_seed=int(self.generator.randint(2 ** 31)),
                              pin=self._to_card())
        if self.persistent_workers:
            self._pool = pool
            try:
                yield from pool.run_epoch(batches)
            except Exception:
                self._pool = None  # the pool is shut down: respawn next epoch
                raise
        else:
            try:
                yield from pool.run_epoch(batches)
            finally:
                pool.shutdown()

    def shutdown(self):
        """Stop persistent process workers (no-op otherwise)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass

    def _iter_iterable(self):
        def collate(b):
            try:
                with _span("dataloader.fetch"):
                    out = self.collate_fn(b)
            except Exception as exc:
                return self._bad_batch(exc)
            _counter_inc("dataloader.batches")
            return out

        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield collate(batch)
                batch = []
        if batch and not self.drop_last:
            yield collate(batch)

    def _iter_threaded(self):
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = queue.Queue()
            sampler_iter = iter(self.batch_sampler)
            in_flight = 0
            limit = self.num_workers * self.prefetch_factor

            def submit_next():
                nonlocal in_flight
                try:
                    indices = next(sampler_iter)
                except StopIteration:
                    return False
                pending.put(pool.submit(self._fetch, indices))
                in_flight += 1
                return True

            for _ in range(limit):
                if not submit_next():
                    break
            while in_flight:
                fut = pending.get()
                in_flight -= 1
                submit_next()
                # the prefetch span is the stall: time the consumer spent
                # blocked on a worker batch (0 when workers keep up)
                with _span("dataloader.prefetch"):
                    batch = fut.result()
                yield batch

"""Process workers of the port's DataLoader (``paddle_tpu/io/mp_worker.py``;
parity: the reference's ``_DataLoaderIterMultiProcess``,
python/paddle/fluid/dataloader/dataloader_iter.py:342, ``_worker_loop`` in
dataloader/worker.py and its shared-memory LoDTensor transport).

- Forked worker processes take ``(batch key, indices)`` from their own index
  queue, run ``collate_fn([dataset[i] for i in indices])`` and ship each
  array or CPU tensor of the batch back through a POSIX shared-memory
  segment (``multiprocessing.shared_memory``), so large batches never pass
  through a pickle pipe. Batch ``i`` of an epoch goes to worker ``i % n``:
  which worker (and so which worker seed) makes a batch does not depend on
  timing.
- The parent restores batch order, detects dead workers instead of
  blocking forever, re-raises worker exceptions with their tracebacks, and
  keeps persistent workers across epochs. It copies each segment into a
  fresh tensor (pinned host memory when the loader feeds the card).
- The parent has CUDA initialised by then; a forked worker must never touch
  it. Workers run the dataset and ``collate_fn`` on the CPU with one torch
  thread, and exit with ``os._exit`` (no inherited atexit hook runs). Pinning
  and the copy to the card happen in the parent.
- Worker ``i``'s :class:`WorkerInfo` carries ``seed = base_seed + i``
  (reference worker.py); the loader draws ``base_seed`` from its generator.
"""
from __future__ import annotations

import os
import queue as pyqueue
import traceback

import numpy as np
import torch

_POLL_S = 2.0  # liveness-check cadence while waiting on the data queue


class WorkerInfo:
    """Worker-side view for IterableDataset sharding (reference
    dataloader/worker.py WorkerInfo / paddle.io.get_worker_info)."""

    def __init__(self, id, num_workers, dataset=None, seed=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_info: WorkerInfo | None = None


def get_worker_info():
    """Inside a process worker: its :class:`WorkerInfo` (``seed`` = the
    pool's base seed + the worker's id); in the main process and in thread
    workers, which share it, None."""
    return _worker_info


class _ShmRef:
    """Descriptor of one array parked in a shared-memory segment; ``tensor``:
    whether it was a torch tensor."""

    __slots__ = ("name", "shape", "dtype", "tensor")

    def __init__(self, name, shape, dtype, tensor):
        self.name, self.shape, self.dtype, self.tensor = name, shape, str(dtype), tensor


def _pack(obj, use_shm):
    """Replace array and CPU tensor leaves by :class:`_ShmRef` descriptors,
    each copied into a fresh segment; other leaves travel inline."""
    is_tensor = isinstance(obj, torch.Tensor)
    if use_shm and (is_tensor or isinstance(obj, np.ndarray)):
        arr = obj.detach().contiguous().numpy() if is_tensor else obj
        if arr.nbytes > 0:
            from multiprocessing import shared_memory

            shm = shared_memory.SharedMemory(create=True, size=arr.nbytes)
            np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)[...] = arr
            ref = _ShmRef(shm.name, arr.shape, arr.dtype, is_tensor)
            shm.close()  # the segment lives until the parent unlinks it
            return ref
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v, use_shm) for v in obj)
    if isinstance(obj, dict):
        return {k: _pack(v, use_shm) for k, v in obj.items()}
    return obj


def _unpack(obj, pin=False):
    """The batch back from its segments (each unlinked): a tensor leaf in a
    new tensor, in pinned memory with ``pin``; an array leaf as an array."""
    if isinstance(obj, _ShmRef):
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=obj.name)
        try:
            view = np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)
            if not obj.tensor:
                return np.array(view)
            out = torch.empty(obj.shape, dtype=torch.from_numpy(view[:0]).dtype, pin_memory=pin)
            out.numpy()[...] = view
            return out
        finally:
            shm.close()
            shm.unlink()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, pin) for v in obj)
    if isinstance(obj, dict):
        return {k: _unpack(v, pin) for k, v in obj.items()}
    return obj


def _discard(obj):
    """Unlink the segments of a batch that will never be consumed."""
    if isinstance(obj, _ShmRef):
        from multiprocessing import shared_memory

        try:
            shm = shared_memory.SharedMemory(name=obj.name)
            shm.close()
            shm.unlink()
        except Exception:
            pass
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _discard(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            _discard(v)


def _worker_loop(dataset, collate_fn, index_q, data_q, worker_id, num_workers,
                 worker_init_fn, use_shm, base_seed):
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset, seed=base_seed + worker_id)
    torch.set_num_threads(1)  # n workers, not n x cores threads, share the host
    try:
        try:
            if worker_init_fn is not None:
                worker_init_fn(worker_id)
        except Exception as exc:
            # key None marks a fatal worker-level failure (not tied to a
            # batch), so the parent reports the real traceback and not a
            # misleading "killed (OOM/segfault)" hint
            data_q.put((None, None,
                        f"worker {worker_id} init failed — {type(exc).__name__}: "
                        f"{exc}\n{traceback.format_exc()}"))
            data_q.close()
            data_q.join_thread()  # flush before os._exit kills the feeder
            os._exit(1)
        while True:
            item = index_q.get()
            if item is None:
                break
            key, indices = item  # key = (epoch, batch index)
            try:
                batch = collate_fn([dataset[i] for i in indices])
                data_q.put((key, _pack(batch, use_shm), None))
            except Exception as exc:  # ship the traceback, keep serving
                data_q.put((key, None, f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}"))
    except (KeyboardInterrupt, SystemExit):
        # interrupted: drop what the feeder still buffers (flushing could
        # block forever on a parent that is itself dying)
        data_q.cancel_join_thread()
    else:
        # sentinel exit: flush buffered batches so the parent can drain and
        # unlink them instead of leaking segments
        data_q.close()
        data_q.join_thread()
    finally:
        os._exit(0)  # no atexit hook inherited through fork runs


class WorkerPool:
    """A fork-based worker pool and ordered batch iteration over it."""

    def __init__(self, dataset, collate_fn, num_workers, worker_init_fn=None, use_shm=True,
                 timeout=0, prefetch_factor=2, base_seed=0, pin=False):
        import multiprocessing as mp

        self.base_seed = int(base_seed)
        self.pin = pin
        ctx = mp.get_context("fork" if "fork" in mp.get_all_start_methods() else "spawn")
        try:
            # start the resource tracker before forking so workers inherit it:
            # segments they register then unregister cleanly when the parent
            # unlinks them (otherwise each worker spawns its own tracker, which
            # warns about already-unlinked segments at exit)
            from multiprocessing import resource_tracker

            resource_tracker.ensure_running()
        except Exception:
            pass
        self._timeout = timeout
        self._prefetch = max(1, prefetch_factor)
        self._index_qs = [ctx.Queue() for _ in range(num_workers)]
        self._data_q = ctx.Queue()
        self._closed = False
        self._active = False  # one epoch in flight per pool
        self._epoch = 0  # tags queue traffic so a half-consumed epoch's
        self._workers = []  # leftovers cannot leak into the next one
        for wid in range(num_workers):
            p = ctx.Process(target=_worker_loop,
                            args=(dataset, collate_fn, self._index_qs[wid], self._data_q, wid,
                                  num_workers, worker_init_fn, use_shm, self.base_seed),
                            daemon=True)
            p.start()
            self._workers.append(p)

    def _send(self, epoch, i, indices):
        self._index_qs[i % len(self._workers)].put(((epoch, i), indices))

    def run_epoch(self, index_batches):
        """Generator: feed the index queues, yield collated batches in order.

        Backpressure: at most ``num_workers * prefetch_factor`` index batches
        are outstanding (the reference keeps the same bound), so workers
        cannot park an unbounded epoch in /dev/shm ahead of a slow consumer.
        Results tagged with an older epoch (an iterator abandoned mid-epoch)
        are discarded, segments included.
        """
        if self._active:
            raise RuntimeError(
                "this DataLoader's process-worker pool is already serving an "
                "iterator; with persistent_workers only one epoch can be "
                "in flight (exhaust or close the first iterator, or use "
                "thread mode for concurrent iteration)")
        self._active = True
        self._epoch += 1
        epoch = self._epoch
        batches = [list(ix) for ix in index_batches]
        total = len(batches)
        window = min(len(self._workers) * self._prefetch, total)
        for i in range(window):
            self._send(epoch, i, batches[i])
        reorder = {}

        def _fail(msg):
            self.shutdown()
            raise RuntimeError(msg)

        try:
            yield from self._epoch_loop(epoch, batches, total, window, reorder, _fail)
        finally:
            # early close or error: unlink what the reorder buffer holds, it
            # is unreachable from both the queue and the next epoch
            for payload, _ in reorder.values():
                _discard(payload)
            reorder.clear()
            self._active = False

    def _epoch_loop(self, epoch, batches, total, sent, reorder, _fail):
        from ..observability.spans import span

        received = 0
        next_idx = 0
        waited = 0.0
        while next_idx < total:
            while next_idx in reorder:
                payload, err = reorder.pop(next_idx)
                next_idx += 1
                if err is not None:
                    _fail(f"DataLoader worker raised:\n{err}")
                yield _unpack(payload, self.pin)
            if next_idx >= total:
                break
            try:
                # the prefetch span is the stall: time the consumer waits on
                # the workers (about 0 when they keep up)
                with span("dataloader.prefetch"):
                    key, payload, err = self._data_q.get(timeout=_POLL_S)
                if key is None:  # fatal worker-level failure (e.g. init)
                    _discard(payload)
                    _fail(f"DataLoader worker failed:\n{err}")
                ep, bidx = key
                if ep != epoch:
                    _discard(payload)
                    continue
                waited = 0.0
                received += 1
                reorder[bidx] = (payload, err)
                if sent < total:  # top the window up per receive
                    self._send(epoch, sent, batches[sent])
                    sent += 1
            except pyqueue.Empty:
                waited += _POLL_S
                dead = [p for p in self._workers if not p.is_alive()]
                if dead:
                    # a worker may have flushed its own fatal report just
                    # before dying: prefer that to the generic hint
                    try:
                        while True:
                            key, payload, err = self._data_q.get_nowait()
                            if key is None:
                                _discard(payload)
                                _fail(f"DataLoader worker failed:\n{err}")
                            ep, bidx = key
                            if ep != epoch:
                                _discard(payload)
                            else:
                                reorder[bidx] = (payload, err)
                    except pyqueue.Empty:
                        pass
                    p = dead[0]
                    _fail(f"DataLoader worker (pid {p.pid}) exited unexpectedly "
                          f"with code {p.exitcode}. This usually means the "
                          "worker was killed (OOM/segfault) — rerun with "
                          "num_workers=0 to debug in the main process.")
                if self._timeout and waited >= self._timeout:
                    _fail(f"DataLoader timed out after {self._timeout}s waiting "
                          f"for batch {next_idx} ({received}/{total} received)")

    def shutdown(self):
        if self._closed:
            return
        self._closed = True
        # stop the workers first (the data queue is unbounded, so their
        # in-flight puts cannot block), then drain every unconsumed batch:
        # draining before the join would miss batches finished during it
        for q in self._index_qs:
            try:
                q.put(None)
            except Exception:
                pass
        for p in self._workers:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        try:
            while True:
                _, payload, _ = self._data_q.get_nowait()
                _discard(payload)
        except Exception:
            pass
        for q in self._index_qs:
            q.close()
        self._data_q.close()

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass

"""Native record-file feed of the port (``paddle_tpu/io/record_feed.py``):
C++ reader threads read, block-shuffle and batch fixed-size binary records
(one sample = one struct of fixed-shape fields) with no GIL on the hot
path; Python receives ready batch buffers.

Parity: the reference's C++ dataset pipeline (``paddle/fluid/framework/
data_feed.cc`` readers, ``data_set.cc`` file sharding and channels, surfaced
in Python as ``paddle.distributed.QueueDataset``/``InMemoryDataset``). The
readers are the port's own copy of the reference's sources
(``paddle_tpu_torch/csrc/host/``), built with g++ at first use
(:mod:`paddle_tpu_torch.framework.native`), so the same files and seed give
the reference's batches (in its order with one reader thread). Each batch
arrives as a dict of torch tensors by field, copied to the loader's
``device`` one batch ahead as the DataLoader does (the CUDA card unless
``device="cpu"``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..framework import native
from ..framework.device import resolve_device
from .dataloader import device_prefetch


class RecordSchema:
    """One fixed-size record: ordered ``(name, dtype, shape)`` fields."""

    def __init__(self, fields: Sequence[Tuple[str, str, Sequence[int]]]):
        self.fields = [(n, np.dtype(d), tuple(int(s) for s in shape)) for n, d, shape in fields]
        self.record_bytes = sum(dt.itemsize * int(np.prod(shape, dtype=np.int64).item() or 1)
                                for _, dt, shape in self.fields)

    def write_records(self, path: str, columns: Dict[str, np.ndarray]) -> int:
        """Serialize sample-major columns into a record file; returns the
        count of records."""
        converted = []
        n = None
        for name, dt, shape in self.fields:
            arr = np.ascontiguousarray(columns[name], dtype=dt)
            if arr.shape[1:] != shape:
                raise ValueError(f"field {name}: expected trailing shape {shape}, got {arr.shape[1:]}")
            n = arr.shape[0] if n is None else n
            if arr.shape[0] != n:
                raise ValueError("all columns must share the leading (sample) dim")
            converted.append(arr.reshape(n, -1).view(np.uint8).reshape(n, -1))
        # fields interleaved sample-major in one shot: an (n, record_bytes) matrix
        packed = np.concatenate(converted, axis=1) if len(converted) > 1 else converted[0]
        with open(path, "wb") as f:
            f.write(np.ascontiguousarray(packed).tobytes())
        return n

    def decode_batch(self, raw: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Split a uint8 tensor of packed records into tensors by field."""
        nrec, rem = divmod(raw.numel(), self.record_bytes)
        if rem:
            raise ValueError(f"batch of {raw.numel()} bytes is not a multiple of record size "
                             f"{self.record_bytes}")
        raw = raw.view(nrec, self.record_bytes)
        out = {}
        off = 0
        for name, dt, shape in self.fields:
            nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64).item() or 1)
            field = raw[:, off:off + nbytes].contiguous().view(torch.from_numpy(np.empty(0, dt)).dtype)
            out[name] = field.reshape((nrec,) + shape)
            off += nbytes
        return out


class RecordFileLoader:
    """Iterable over native-read batches of records from sharded files.

    One epoch per iteration; ``shuffle`` is a bounded-memory block shuffle
    in the native readers (the reference's data_feed shuffling), seeded
    ``seed`` plus the epoch's index. ``num_workers`` reader threads claim
    the files in turn.
    """

    def __init__(self, files: List[str], schema: RecordSchema, batch_size: int,
                 num_workers: int = 2, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, queue_capacity: int = 8, device=None):
        if not files:
            raise ValueError("RecordFileLoader needs at least one file")
        self.schema = schema
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self._lib = native.load()
        self._h = self._lib.pt_feed_create(
            "\n".join(files).encode(), schema.record_bytes, self.batch_size,
            int(num_workers), int(queue_capacity), 1 if shuffle else 0,
            int(seed), 1 if drop_last else 0)
        if not self._h:
            raise ValueError("invalid feed configuration")

    def _host_batches(self):
        self._lib.pt_feed_start_epoch(self._h)
        while True:
            out = ctypes.c_void_p()
            n = self._lib.pt_feed_next(self._h, ctypes.byref(out))
            if n == 0:
                return
            raw = torch.empty(n, dtype=torch.uint8)
            ctypes.memmove(raw.data_ptr(), out, n)
            self._lib.pt_buffer_free(out)
            yield self.schema.decode_batch(raw)

    def __iter__(self):
        if getattr(self, "_iterating", False):
            raise RuntimeError(
                "RecordFileLoader supports one active iterator: the native feed "
                "is a single stream; restarting it would corrupt the in-flight epoch")
        self._iterating = True
        try:
            yield from device_prefetch(self._host_batches(), self.device)
        finally:
            self._iterating = False

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pt_feed_destroy(self._h)
            self._h = None

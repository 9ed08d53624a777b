"""Checkpoint files of the port (``paddle_tpu/distributed/checkpoint.py``;
parity: auto_parallel/dist_saver.py + converter.py, fleet.save_persistables
fleet/base/fleet_base.py:833).

The reference writes its pytrees with orbax. The port writes a state (a
nested dict / list / tuple of tensors, numpy arrays and Python scalars,
or a :class:`~paddle_tpu_torch.jit.TrainStep`) as one file, ``state.pt``
under the checkpoint's directory: every tensor copied to the host, written
by ``torch.save`` and read back by ``torch.load(weights_only=True)``
(tensors and plain containers only, no pickled code). A numpy leaf is
written as a tensor and read back as one. A ``TrainStep`` is written whole:
:func:`~.converter.gather_to_host` first joins its ZeRO blocks and its
model-parallel, pipeline and expert pieces, so a checkpoint does not
depend on the mesh it was written from (the converter places it onto the
restoring one).

Leaves are named by their key path in the reference's spelling
(``['params']['gpt.layers.qkv_w']``, ``['opt']['m'][0]``):
:func:`checksum_pytree` keys its CRC32s by them, and the converter's errors
name them.
"""
from __future__ import annotations

import os
import threading
import zlib
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["checksum_pytree", "save_state", "load_state", "save_train_step", "load_train_step",
           "flatten", "DATA_FILE"]

#: The file a checkpoint's arrays live in, under its directory.
DATA_FILE = "state.pt"


def _is_step(obj) -> bool:
    return hasattr(obj, "load_state") and hasattr(obj, "optimizer")


def flatten(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key path, leaf)`` of every leaf of a nested dict / list / tuple,
    in the order of the tree (dict keys in insertion order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaf_bytes(leaf) -> Tuple[np.ndarray, list, str]:
    """``(raw bytes as a contiguous numpy array, shape, dtype name)`` of a
    leaf on the host: a tensor's (bf16 viewed as int16: numpy has no bf16),
    an array's, a scalar's as a 0-d numpy array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        dtype = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().reshape(-1).view(np.uint8), list(leaf.shape), dtype
    arr = np.asarray(leaf)
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8), list(arr.shape), str(arr.dtype)


def checksum_pytree(state: Any) -> Dict[str, dict]:
    """Per-leaf content checksums: key path -> {crc32, shape, dtype}.

    The CheckpointManager (distributed/resilience.py) stores this in each
    checkpoint's manifest and re-computes it on restore, so a truncated or
    bit-flipped checkpoint is detected instead of silently resuming from
    garbage. CRC32 over the host bytes: integrity against torn writes, not
    an adversary."""
    out = {}
    for path, leaf in flatten(state):
        raw, shape, dtype = _leaf_bytes(leaf)
        out[path] = {"crc32": zlib.crc32(raw) & 0xFFFFFFFF, "shape": shape, "dtype": dtype}
    return out


def _to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.array(leaf))
    return leaf


def host_state(state: Any) -> Any:
    """What a checkpoint holds of ``state``: a ``TrainStep``'s whole state
    (gathered over its mesh), else the tree with every tensor and array
    copied to host tensors."""
    if _is_step(state):
        from .converter import gather_to_host

        return gather_to_host(state)
    return tree_map(_to_host, state)


class _Pending:
    """Handle of an asynchronous save: ``wait()`` returns when it is durable
    (and re-raises its error)."""

    def __init__(self, fn):
        self._err = None

        def run():
            try:
                fn()
            except BaseException as e:  # handed to wait()
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        self._thread.join()
        if self._err is not None:
            raise self._err


def _write(host, path):
    os.makedirs(path, exist_ok=True)
    fpath = os.path.join(path, DATA_FILE)
    with open(fpath, "wb") as f:
        torch.save(host, f)
        f.flush()
        os.fsync(f.fileno())


def save_state(state: Any, path: str, async_save: bool = False):
    """Write ``state`` (a tree, or a ``TrainStep`` written whole) under the
    directory ``path``. Returns when the file is durable; with
    ``async_save`` the host copy is made first and the write runs on a
    thread: the returned handle's ``wait()`` joins it. Under a mesh of
    several ranks every rank calls it and meets the others at one barrier
    before it returns, with or without ``async_save``; world rank 0 writes
    and alone gets a handle, and the file is whole once its ``wait()``
    returns."""
    path = os.path.abspath(path)
    host = host_state(state)
    if not _writes(state):  # another rank of the step's mesh writes the same bytes
        _mesh_barrier(state)
        return None
    if async_save:
        pending = _Pending(lambda: _write(host, path))
        _mesh_barrier(state)  # where the other ranks wait: the collectives after pair up
        return pending
    _write(host, path)
    _mesh_barrier(state)
    return None


def _writes(state) -> bool:
    """Whether this process writes ``state``'s checkpoint: always, except
    for a ``TrainStep`` over a mesh of several ranks, which world rank 0
    writes (every rank gathered the same whole state)."""
    if not (_is_step(state) and state.mesh is not None):
        return True
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _mesh_barrier(state):
    """After a mesh step's save: no rank reads the directory before rank 0
    has written it."""
    if _is_step(state) and state.mesh is not None:
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()


def load_state(path: str, target: Optional[Any] = None, shardings: Optional[Any] = None):
    """Read the state under ``path`` (host tensors). ``target`` (a tree of
    the expected leaves, or a ``TrainStep``) and ``shardings`` (a tree of
    devices) go through :func:`~.converter.convert`: the leaves are checked
    against the target's and placed onto its devices and mesh."""
    state = torch.load(os.path.join(os.path.abspath(path), DATA_FILE), map_location="cpu",
                       weights_only=True)
    if target is None and shardings is None:
        return state
    from .converter import convert

    return convert(state, target=target, shardings=shardings)


def save_train_step(train_step, path: str, async_save: bool = False):
    """Checkpoint a ``jit.TrainStep``'s whole state (params, optimizer
    moments and step, buffers, step count, skipped count, LR schedule,
    MoE generators)."""
    return save_state(train_step, path, async_save=async_save)


def load_train_step(train_step, path: str, shardings: Optional[Any] = None):
    """Restore a checkpoint into ``train_step``, placed onto its mesh."""
    load_state(path, target=train_step, shardings=shardings)
    return train_step

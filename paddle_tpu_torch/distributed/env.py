"""Process environment of the port's distributed layer
(``paddle_tpu/distributed/env.py``; parity: the env reading of
python/paddle/distributed/parallel.py and paddle.distributed.launch).

The reference is single-controller: one process per host drives every
local device, and its ``init_parallel_env`` is ``jax.distributed.initialize``
(a no-op on one host). The port is PyTorch's one process per device over
``torch.distributed``: :func:`init_parallel_env` joins this process to the
world with ``init_process_group``, on one device. Rank, world size and
master come from the reference's ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM`` and ``PADDLE_MASTER`` (``host:port``), or from
torch's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; with
neither, the process makes a world of one.

The backend follows the device: NCCL for a CUDA device, gloo only when
the caller asks for the CPU (``device="cpu"``) or names gloo itself. It is
never chosen by what happens to be installed, and with no CUDA device and
no ``device="cpu"`` the call raises, as the port's entry points do.
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from ..framework.device import resolve_device

_DEVICE = [None]


def _env_int(*names, default):
    for name in names:
        if os.environ.get(name, "") != "":
            return int(os.environ[name])
    return default


def _master():
    """``host:port`` of the rendezvous, or None."""
    if os.environ.get("PADDLE_MASTER"):
        return os.environ["PADDLE_MASTER"]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def init_parallel_env(backend=None, device=None, timeout=None):
    """Join this process to the ``torch.distributed`` world, once (later
    calls return at once). ``device`` defaults to ``cuda:<local rank>`` (the
    local rank from ``PADDLE_LOCAL_RANK`` or ``LOCAL_RANK``, else the rank
    modulo the card count); ``backend`` to NCCL on a CUDA device and gloo
    on the CPU. ``timeout`` (seconds) bounds every collective. Returns the
    device."""
    if dist.is_available() and dist.is_initialized():
        return get_device()
    rank = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    world = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    if device is None:
        resolve_device(None)  # raises without CUDA
        local = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=rank % torch.cuda.device_count())
        dev = torch.device("cuda", local)
    else:
        dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timedelta(seconds=float(timeout))}
    master = _master()
    if world > 1:
        if master is None:
            raise RuntimeError(
                f"init_parallel_env: a world of {world} needs PADDLE_MASTER (host:port) or "
                "MASTER_ADDR and MASTER_PORT")
        dist.init_process_group(backend, init_method=f"tcp://{master}", rank=rank,
                                world_size=world, **kw)
    else:
        # a world of one needs no rendezvous: an in-process store
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    _DEVICE[0] = dev
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_device() -> torch.device:
    """The device :func:`init_parallel_env` put this process on."""
    if _DEVICE[0] is None:
        raise RuntimeError("init_parallel_env() has not run in this process")
    return _DEVICE[0]


def get_rank() -> int:
    """This process's rank in the world (0 before :func:`init_parallel_env`).
    The reference's is the host index of its single controller."""
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    """The number of processes in the world (1 before
    :func:`init_parallel_env`). The reference's counts hosts."""
    return dist.get_world_size() if is_initialized() else 1


class ParallelEnv:
    """``paddle.distributed.ParallelEnv``: this process's rank, world size
    and local rank (the index of its card on the host)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    nranks = world_size

    @property
    def local_rank(self):
        if _DEVICE[0] is not None and _DEVICE[0].type == "cuda":
            return _DEVICE[0].index
        return _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=get_rank())

    device_id = local_rank

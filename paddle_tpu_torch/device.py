"""The device surface of the port (``paddle_tpu/device.py`` and the
device half of ``paddle_tpu/framework/core.py``; parity:
python/paddle/device).

- :func:`set_device`/:func:`get_device` name the device on which the
  functions that make a tensor from no tensor input place it (``zeros``,
  ``arange``, ``to_tensor``, the random functions, ``load``):
  ``"gpu"``, ``"gpu:N"`` or ``"cpu"``. With none set that is the CUDA
  card, and with no CUDA device those functions raise
  (:func:`paddle_tpu_torch.framework.device.resolve_device`): the port
  never drops to the CPU unless asked. torch's own current device is not
  changed.
- The memory functions read ``torch.cuda``'s caching allocator under the
  reference's key names (``bytes_in_use``, ``peak_bytes_in_use``,
  ``bytes_limit``, ``largest_alloc_size``; ``pool_bytes`` and
  ``peak_pool_bytes`` for what the allocator holds). On the CPU they raise:
  torch keeps no registry of live tensors, where the reference's CPU
  fallback sums the live JAX arrays (``paddle_tpu/device.py:32-60``).
- The ``is_compiled_with_*`` predicates answer for this torch build.
"""
from __future__ import annotations

import torch

from .framework.device import resolve_device
from .framework.param_attr import (CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace,  # noqa: F401
                                   TPUPlace)

__all__ = ["set_device", "get_device", "current_device", "memory_stats", "memory_allocated",
           "max_memory_allocated", "memory_reserved", "max_memory_reserved",
           "device_memory_limit", "empty_cache", "device_count", "get_device_properties",
           "is_compiled_with_cuda", "is_compiled_with_rocm", "is_compiled_with_xpu",
           "is_compiled_with_npu", "is_compiled_with_mlu", "is_compiled_with_ipu",
           "is_compiled_with_cinn", "is_compiled_with_tpu", "get_cudnn_version",
           "get_all_device_type", "get_all_custom_device_type", "get_available_device",
           "get_available_custom_device", "cuda", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
           "TPUPlace", "NPUPlace", "XPUPlace", "MLUPlace", "IPUPlace"]

_DEVICE = [None]  # the torch.device set_device named, or None (the CUDA card)


def _parse(device) -> torch.device:
    if isinstance(device, torch.device):
        return device
    if hasattr(device, "device") and not isinstance(device, str):  # a Place
        return device.device
    if isinstance(device, int):
        return torch.device("cuda", device)
    name, _, index = str(device).partition(":")
    if name in ("gpu", "cuda"):
        return torch.device("cuda", int(index) if index else 0)
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unsupported device {device!r}: use 'gpu', 'gpu:N' or 'cpu'")


def set_device(device):
    """Name the device of new tensors (``"gpu"``, ``"gpu:N"``, ``"cpu"``);
    returns ``device``. A GPU with no CUDA device raises."""
    dev = _parse(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"set_device({device!r}): no CUDA device is available")
    _DEVICE[0] = dev
    return device


def get_device() -> str:
    """``"gpu:N"`` or ``"cpu"``: the device :func:`set_device` named, else
    torch's current CUDA device, else ``"cpu"``."""
    dev = _DEVICE[0]
    if dev is None:
        return f"gpu:{torch.cuda.current_device()}" if torch.cuda.is_available() else "cpu"
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


def current_device() -> torch.device:
    """The torch device of a tensor made from no tensor input."""
    return resolve_device(_DEVICE[0])


def _cuda(device=None) -> torch.device:
    dev = current_device() if device is None else _parse(device)
    if dev.type != "cuda":
        raise RuntimeError(
            f"device memory is read from torch.cuda's allocator; {dev} has none "
            "(torch keeps no registry of live CPU tensors)")
    return dev


def memory_stats(device=None) -> dict:
    """The caching allocator's figures under the reference's key names."""
    dev = _cuda(device)
    s = torch.cuda.memory_stats(dev)
    live = [b["size"] for seg in torch.cuda.memory_snapshot()
            if seg.get("device", dev.index) == dev.index
            for b in seg["blocks"] if b["state"] == "active_allocated"]
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
            # torch keeps no record of past allocations: the largest live one
            "largest_alloc_size": int(max(live, default=0)),
            "pool_bytes": int(s.get("reserved_bytes.all.current", 0)),
            "peak_pool_bytes": int(s.get("reserved_bytes.all.peak", 0)),
            "num_allocs": int(s.get("allocation.all.allocated", 0)),
            "source": "torch.cuda"}


def memory_allocated(device=None) -> int:
    return int(torch.cuda.memory_allocated(_cuda(device)))


def max_memory_allocated(device=None) -> int:
    return int(torch.cuda.max_memory_allocated(_cuda(device)))


def memory_reserved(device=None) -> int:
    return int(torch.cuda.memory_reserved(_cuda(device)))


def max_memory_reserved(device=None) -> int:
    return int(torch.cuda.max_memory_reserved(_cuda(device)))


def device_memory_limit(device=None) -> int:
    return int(torch.cuda.get_device_properties(_cuda(device)).total_memory)


def empty_cache():
    """Return the allocator's unused cached blocks to the card."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_count() -> int:
    return torch.cuda.device_count()


def get_device_properties(device=None) -> dict:
    dev = _cuda(device)
    p = torch.cuda.get_device_properties(dev)
    return {"name": p.name, "platform": "gpu", "id": dev.index or 0, "process_index": 0,
            "total_memory": int(p.total_memory), "major": p.major, "minor": p.minor,
            "multi_processor_count": p.multi_processor_count}


class XPUPlace(TPUPlace):
    _kind = "xpu"


class MLUPlace(TPUPlace):
    _kind = "mlu"


class IPUPlace(TPUPlace):
    _kind = "ipu"


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_rocm() -> bool:
    return getattr(torch.version, "hip", None) is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_mlu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False


def get_cudnn_version():
    """cuDNN's version as an int, or ``None`` in a build without it."""
    return torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else None


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_all_custom_device_type():
    return []


def get_available_device():
    if torch.cuda.is_available():
        return [f"gpu:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu"]


def get_available_custom_device():
    return []


class _CudaNamespace:
    """``paddle.device.cuda``: the memory queries above and
    :meth:`synchronize`."""

    max_memory_allocated = staticmethod(max_memory_allocated)
    max_memory_reserved = staticmethod(max_memory_reserved)
    memory_allocated = staticmethod(memory_allocated)
    memory_reserved = staticmethod(memory_reserved)
    memory_stats = staticmethod(memory_stats)
    empty_cache = staticmethod(empty_cache)
    device_count = staticmethod(device_count)
    get_device_properties = staticmethod(get_device_properties)

    @staticmethod
    def synchronize(device=None):
        torch.cuda.synchronize(_cuda(device))


cuda = _CudaNamespace()

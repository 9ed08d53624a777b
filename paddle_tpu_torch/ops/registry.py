"""Kernel registry of the port: transparent kernel selection with a plain
fallback.

Same contract as ``paddle_tpu/ops/registry.py``. A kernel name maps to an
ORDERED list of implementations, each with an availability predicate over
the actual call (shapes, dtypes, devices, flags); the first accepting
implementation wins, and the registered fallback (the plain PyTorch
composite) sorts last and accepts unconditionally.

Selection is cached per call signature: tensor arguments are abstracted to
``(shape, dtype, device type)`` (where the reference folds in JAX's backend),
other arguments ride along verbatim, and the key also holds the kernel's
watched flag values and ``FLAGS_kernel_overrides``, so ``set_flags`` takes
effect with no invalidation hook. The predicate walk runs once per distinct
signature, so the ``kernels.<name>.{picked,fallback}`` counters count one
selection per signature.

``FLAGS_kernel_overrides`` (e.g. ``"attention_core=xla"``) forces a named
implementation per kernel, bypassing availability.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..framework.flags import flag
from ..observability import metrics as _metrics

__all__ = [
    "define_kernel", "register", "select", "dispatch", "kernels",
    "implementations", "kernel_table", "clear_cache", "KernelImpl",
]


class KernelImpl:
    """One implementation of a kernel: ``fn`` plus its availability predicate
    (called with the exact dispatch arguments; ``None`` accepts
    unconditionally). ``fallback=True`` marks the always-safe composite: it
    sorts last and never consults a predicate."""

    __slots__ = ("name", "fn", "available", "fallback", "doc")

    def __init__(self, name: str, fn: Callable, available: Optional[Callable] = None,
                 fallback: bool = False, doc: str = ""):
        self.name = name
        self.fn = fn
        self.available = available
        self.fallback = bool(fallback)
        self.doc = doc

    def __repr__(self):
        return f"KernelImpl({self.name!r}{', fallback' if self.fallback else ''})"


class Kernel:
    __slots__ = ("name", "impls", "flags")

    def __init__(self, name: str, flags: Tuple[str, ...] = ()):
        self.name = name
        self.impls: List[KernelImpl] = []
        self.flags = tuple(flags)


_KERNELS: Dict[str, Kernel] = {}
_CACHE: Dict[tuple, KernelImpl] = {}


def define_kernel(name: str, flags: Tuple[str, ...] = ()) -> Kernel:
    """Declare kernel ``name``. ``flags`` lists flag names whose values feed
    the selection-cache key. Idempotent: re-defining keeps already-registered
    implementations."""
    k = _KERNELS.get(name)
    if k is None:
        k = _KERNELS[name] = Kernel(name, flags)
    else:
        k.flags = tuple(flags)
    _metrics.declare_counter(f"kernels.{name}.picked")
    _metrics.declare_counter(f"kernels.{name}.fallback")
    return k


def register(kernel: str, impl_name: str, fn: Optional[Callable] = None, *,
             available: Optional[Callable] = None, fallback: bool = False, doc: str = ""):
    """Register ``fn`` as implementation ``impl_name`` of ``kernel``
    (decorator form when ``fn`` is omitted). Implementations are tried in
    registration order with fallbacks sorted last; re-registering a name
    replaces it in place."""

    def _do(f):
        k = _KERNELS.get(kernel) or define_kernel(kernel)
        impl = KernelImpl(impl_name, f, available, fallback, doc)
        for i, existing in enumerate(k.impls):
            if existing.name == impl_name:
                k.impls[i] = impl
                break
        else:
            k.impls.append(impl)
        k.impls.sort(key=lambda im: im.fallback)  # stable: fallbacks last
        clear_cache(kernel)
        return f

    return _do if fn is None else _do(fn)


def _abstract(v: Any):
    """Tensors become (shape, dtype, device type), a random generator its
    device type (a fresh one per call must not grow the cache); anything
    else must already be hashable."""
    if isinstance(v, torch.Tensor):
        return ("tensor", tuple(v.shape), str(v.dtype), v.device.type)
    if isinstance(v, torch.Generator):
        return ("generator", v.device.type)
    return v


def _parse_overrides(s: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in (s or "").split(","):
        part = part.strip()
        if part and "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def select(kernel: str, *args, **kwargs) -> KernelImpl:
    """The implementation that will serve this call (cached per signature).
    Bumps ``kernels.<kernel>.picked``/``.fallback`` once per new signature."""
    k = _KERNELS[kernel]
    overrides = flag("FLAGS_kernel_overrides")
    key = (
        kernel,
        overrides,
        tuple(flag(f) for f in k.flags),
        tuple(_abstract(a) for a in args),
        tuple(sorted((kw, _abstract(v)) for kw, v in kwargs.items())),
    )
    impl = _CACHE.get(key)
    if impl is not None:
        return impl
    forced = _parse_overrides(overrides).get(kernel)
    if forced is not None:
        for impl in k.impls:
            if impl.name == forced:
                break
        else:
            raise KeyError(
                f"FLAGS_kernel_overrides: kernel {kernel!r} has no implementation "
                f"{forced!r} (registered: {[im.name for im in k.impls]})")
    else:
        impl = None
        for cand in k.impls:
            if cand.fallback or cand.available is None or cand.available(*args, **kwargs):
                impl = cand
                break
        if impl is None:
            raise RuntimeError(
                f"kernel {kernel!r}: no implementation available for this call "
                "and no fallback registered")
    _CACHE[key] = impl
    _metrics.counter_inc(f"kernels.{kernel}." + ("fallback" if impl.fallback else "picked"))
    return impl


def dispatch(kernel: str, *args, **kwargs):
    """Select (cached) and call the winning implementation."""
    return select(kernel, *args, **kwargs).fn(*args, **kwargs)


def kernels() -> List[str]:
    return sorted(_KERNELS)


def implementations(kernel: str) -> List[str]:
    return [im.name for im in _KERNELS[kernel].impls]


def kernel_table() -> List[dict]:
    """One row per (kernel, implementation)."""
    rows = []
    for name in sorted(_KERNELS):
        for im in _KERNELS[name].impls:
            rows.append({"kernel": name, "impl": im.name, "fallback": im.fallback,
                         "flags": list(_KERNELS[name].flags), "doc": im.doc})
    return rows


def clear_cache(kernel: Optional[str] = None) -> None:
    """Drop cached selections (all kernels, or just ``kernel``). Counters are
    not reset: a re-selection after an explicit clear counts again."""
    if kernel is None:
        _CACHE.clear()
        return
    for key in [key for key in _CACHE if key[0] == kernel]:
        del _CACHE[key]

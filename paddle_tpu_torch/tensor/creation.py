"""Tensor creation (``paddle_tpu/tensor/creation.py``; parity:
python/paddle/tensor/creation.py and random.py).

A function that makes a tensor from no tensor input places it on the
default device (:func:`paddle_tpu_torch.device.set_device`; the CUDA card
when none is set). One with a tensor input follows that tensor. The random
functions draw from the port's stream through explicit generators
(:func:`paddle_tpu_torch.framework.random.next_generator`): one fresh key
per call, never torch's global default generator, so ``paddle.seed``
replays them and ``torch.random.get_rng_state()`` does not move.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework import random as _random
from ._helpers import cast, default_float, ensure_tensor, new_device, shape_list, to_torch_dtype

__all__ = ["to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
           "empty_like", "arange", "linspace", "logspace", "eye", "diag", "diagflat", "tril",
           "triu", "meshgrid", "clone", "assign", "tril_indices", "triu_indices", "complex",
           "rand", "randn", "standard_normal", "normal", "uniform", "randint", "randint_like",
           "randperm", "bernoulli", "poisson", "multinomial", "uniform_", "exponential_"]


def _dtype(dtype, default=None):
    return to_torch_dtype(dtype) if dtype is not None else default


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor holding ``data`` (a tensor, a numpy array, a Python
    scalar or nested list), on ``place`` or the default device (a tensor's
    own device when it is one); ``requires_grad = not stop_gradient`` for a
    float or complex result."""
    dt = _dtype(dtype)
    if isinstance(data, torch.Tensor):
        dev = new_device(place) if place is not None else data.device
        t = data.detach().to(device=dev, dtype=dt or data.dtype, copy=True)
    elif isinstance(data, (list, tuple)) and data and any(isinstance(d, torch.Tensor) for d in data):
        t = torch.stack([to_tensor(d, dtype, place) for d in data])
    else:
        t = ensure_tensor(data, device=new_device(place))
        if dt is not None:
            t = t.to(dt)
    if not stop_gradient and (t.is_floating_point() or t.is_complex()):
        t.requires_grad_(True)
    return t


def zeros(shape, dtype=None, name=None):
    return torch.zeros(shape_list(shape), dtype=_dtype(dtype, default_float()),
                       device=new_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(shape_list(shape), dtype=_dtype(dtype, default_float()), device=new_device())


def _fill_dtype(fill):
    if isinstance(fill, torch.Tensor):
        return fill.dtype
    if isinstance(fill, (bool, np.bool_)):
        return torch.bool
    if isinstance(fill, (int, np.integer)):
        return torch.int64
    if isinstance(fill, builtins.complex):
        return torch.complex64
    return default_float()


def full(shape, fill_value, dtype=None, name=None):
    fill = fill_value.item() if isinstance(fill_value, torch.Tensor) else fill_value
    return torch.full(shape_list(shape), fill, dtype=_dtype(dtype, _fill_dtype(fill_value)),
                      device=new_device())


def empty(shape, dtype=None, name=None):
    """Zeros, as the reference's (a deterministic ``empty``)."""
    return zeros(shape, dtype=dtype)


def zeros_like(x, dtype=None, name=None):
    (x,) = cast("zeros_like", ensure_tensor(x))
    return torch.zeros_like(x, dtype=_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    (x,) = cast("ones_like", ensure_tensor(x))
    return torch.ones_like(x, dtype=_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    (x,) = cast("full_like", ensure_tensor(x))
    fill = fill_value.item() if isinstance(fill_value, torch.Tensor) else fill_value
    return torch.full_like(x, fill, dtype=_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype=dtype)


def _value(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    start, end, step = _value(start), _value(end), _value(step)
    ints = all(isinstance(v, (int, np.integer)) for v in (start, end, step))
    return torch.arange(start, end, step, dtype=_dtype(dtype, torch.int64 if ints else default_float()),
                        device=new_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_value(start), _value(stop), int(_value(num)),
                          dtype=_dtype(dtype, default_float()), device=new_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(_value(start), _value(stop), int(_value(num)), base=base,
                          dtype=_dtype(dtype, default_float()), device=new_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return torch.eye(int(num_rows), int(num_columns if num_columns is not None else num_rows),
                     dtype=_dtype(dtype, default_float()), device=new_device())


def diag(x, offset=0, padding_value=0, name=None):
    (x,) = cast("diag", ensure_tensor(x))
    out = torch.diag(x, offset)
    if x.ndim == 1 and padding_value != 0:
        on = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        out = torch.where(on, out, torch.full((), padding_value, dtype=out.dtype, device=x.device))
    return out


def diagflat(x, offset=0, name=None):
    (x,) = cast("diagflat", ensure_tensor(x))
    return torch.diagflat(x, offset)


def tril(x, diagonal=0, name=None):
    (x,) = cast("tril", ensure_tensor(x))
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None):
    (x,) = cast("triu", ensure_tensor(x))
    return torch.triu(x, diagonal)


def meshgrid(*args, **kwargs):
    tensors = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) else args
    tensors = cast("meshgrid", *[ensure_tensor(t) for t in tensors])
    return list(torch.meshgrid(*tensors, indexing="ij"))


def clone(x, name=None):
    (x,) = cast("clone", ensure_tensor(x))
    return x.clone()


def assign(x, output=None):
    """A detached copy of ``x``, or ``x`` copied into ``output``."""
    val = x.detach().clone() if isinstance(x, torch.Tensor) else ensure_tensor(
        x, device=output.device if output is not None else None)
    if output is not None:
        with torch.no_grad():
            output.copy_(val)
        return output
    return val


def tril_indices(row, col, offset=0, dtype="int64"):
    return torch.tril_indices(int(row), int(col), int(offset), dtype=to_torch_dtype(dtype),
                              device=new_device())


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return torch.triu_indices(int(row), int(col or row), int(offset), dtype=to_torch_dtype(dtype),
                              device=new_device())


def complex(real, imag, name=None):
    real, imag = cast("complex", ensure_tensor(real), ensure_tensor(imag))
    return torch.complex(real, imag)


# ---- random creation (parity: python/paddle/tensor/random.py) ------------


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype=dtype)


def standard_normal(shape, dtype=None, name=None):
    dev = new_device()
    return torch.randn(shape_list(shape), generator=_random.next_generator(dev),
                       dtype=_dtype(dtype, default_float()), device=dev)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        ref = mean if isinstance(mean, torch.Tensor) else std
        m = mean if isinstance(mean, torch.Tensor) else float(mean)
        s = std if isinstance(std, torch.Tensor) else float(std)
        shp = torch.broadcast_shapes(tuple(getattr(m, "shape", ())), tuple(getattr(s, "shape", ())))
        dt = ref.dtype if ref.is_floating_point() else torch.float32
        noise = torch.randn(shp, generator=_random.next_generator(ref.device), dtype=dt,
                            device=ref.device)
        return m + s * noise
    dev = new_device()
    noise = torch.randn(shape_list(shape or [1]), generator=_random.next_generator(dev),
                        dtype=default_float(), device=dev)
    return mean + std * noise


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    """Uniform draws in ``[min, max)``; a non-zero ``seed`` draws from that
    seed's own stream (the same draws every call), as the reference's."""
    dev = new_device()
    gen = _random.generator(_random.fold_in(_random._root_key(seed), 0), dev) if seed else \
        _random.next_generator(dev)
    out = torch.empty(shape_list(shape), dtype=_dtype(dtype, default_float()), device=dev)
    return out.uniform_(float(min), float(max), generator=gen)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = new_device()
    return torch.randint(int(low), int(high), shape_list(shape), generator=_random.next_generator(dev),
                         dtype=to_torch_dtype(dtype or "int64"), device=dev)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = ensure_tensor(x)
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), tuple(x.shape),
                         generator=_random.next_generator(x.device),
                         dtype=_dtype(dtype, x.dtype), device=x.device)


def randperm(n, dtype="int64", name=None):
    dev = new_device()
    return torch.randperm(int(n), generator=_random.next_generator(dev),
                          dtype=to_torch_dtype(dtype), device=dev)


def bernoulli(x, name=None):
    x = ensure_tensor(x)
    return torch.bernoulli(x.detach(), generator=_random.next_generator(x.device))


def poisson(x, name=None):
    x = ensure_tensor(x)
    return torch.poisson(x.detach(), generator=_random.next_generator(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    x = ensure_tensor(x)
    return torch.multinomial(x.detach(), int(num_samples), replacement,
                             generator=_random.next_generator(x.device))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    """In-place uniform refill (reference ``paddle.Tensor.uniform_``)."""
    gen = _random.generator(_random.fold_in(_random._root_key(seed), 0), x.device) if seed else \
        _random.next_generator(x.device)
    return x.uniform_(float(min), float(max), generator=gen)


def exponential_(x, lam=1.0, name=None):
    """In-place Exponential(lam) refill (reference ``paddle.Tensor.exponential_``)."""
    return x.exponential_(float(lam), generator=_random.next_generator(x.device))

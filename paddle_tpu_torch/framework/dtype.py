"""Dtype registry of the port (``paddle_tpu/framework/dtype.py``; parity:
the dtype strings of ``VarDesc.VarType``).

Paddle's dtype names map onto torch dtypes one to one. The reference
computes ``int64`` as ``int32`` and ``float64`` as ``float32`` when JAX's
x64 mode is off; the port keeps what is asked for (``to_torch_dtype``
never narrows), so indices are ``int64`` and a ``float64`` is real.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "to_torch_dtype", "get_default_dtype", "set_default_dtype",
           "is_floating"]

# canonical name -> torch dtype
_DTYPES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

_ALIASES = {
    "fp16": "float16",
    "bf16": "bfloat16",
    "fp32": "float32",
    "fp64": "float64",
    "half": "float16",
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
}

_FLOATING = ("float16", "bfloat16", "float32", "float64")

_default_dtype = "float32"


def convert_dtype(dtype):
    """A dtype spec (a name, an alias, a torch or numpy dtype, a Python
    scalar type) as its canonical name."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype.replace("torch.", ""))
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = np.dtype(dtype).name if not hasattr(dtype, "name") else dtype.name
    name = _ALIASES.get(name, name)
    if name in _DTYPES:
        return name
    raise ValueError(f"unsupported dtype {dtype!r}")


def to_torch_dtype(dtype):
    """The torch dtype of a dtype spec (``None`` stays ``None``)."""
    if dtype is None:
        return None
    return _DTYPES[convert_dtype(dtype)]


def get_default_dtype():
    return _default_dtype


def set_default_dtype(dtype):
    global _default_dtype
    name = convert_dtype(dtype)
    if name not in _FLOATING:
        raise TypeError(f"set_default_dtype only accepts floating dtypes, got {dtype!r}")
    _default_dtype = name


def is_floating(dtype) -> bool:
    return convert_dtype(dtype) in _FLOATING

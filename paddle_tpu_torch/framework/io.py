"""``paddle.save``/``paddle.load`` of the port (``paddle_tpu/framework/io.py``;
parity: python/paddle/framework/io.py:574,791), in the reference's file
format: a pickle (protocol 4) in which each tensor is
``("__tensor__", numpy array, stop_gradient)``, dicts as plain dicts. So a
file that ``paddle_tpu.save`` wrote loads here and one written here loads
there.

``save`` copies each tensor to the host once (``.cpu()`` then its numpy
view). A bfloat16 tensor has no numpy dtype without ``ml_dtypes``: with
it, its bits go across as ``ml_dtypes.bfloat16``; without it, ``save``
raises a ``TypeError`` that names the tensor (it never widens one
silently). ``load`` makes each tensor on the default device
(``paddle.set_device``), or gives the numpy arrays (``return_numpy=True``).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..device import current_device
from ..tensor._helpers import from_numpy

__all__ = ["save", "load"]


def _host_array(t: torch.Tensor, where: str) -> np.ndarray:
    t = t.detach().resolve_conj().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            raise TypeError(f"paddle.save: tensor {where} is bfloat16, which numpy holds only "
                            "with the ml_dtypes package; install it or cast the tensor") from None
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _to_saveable(obj, where="obj"):
    if isinstance(obj, torch.Tensor):
        return ("__tensor__", _host_array(obj, where), not obj.requires_grad)
    if isinstance(obj, dict):
        return {k: _to_saveable(v, f"{where}[{k!r}]") for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v, f"{where}[{i}]") for i, v in enumerate(obj))
    return obj


def _is_tensor_record(obj):
    return isinstance(obj, tuple) and len(obj) == 3 and isinstance(obj[0], str) and \
        obj[0] == "__tensor__"


def _from_saved(obj, return_numpy, device):
    if _is_tensor_record(obj):
        if return_numpy:
            return obj[1]
        t = from_numpy(np.asarray(obj[1]), device)
        if not obj[2] and (t.is_floating_point() or t.is_complex()):
            t.requires_grad_(True)
        return t
    if isinstance(obj, dict):
        return {k: _from_saved(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saved(v, return_numpy, device) for v in obj)
    return obj


def save(obj, path, protocol=4):
    """Write ``obj`` (nested dicts, lists and tuples of tensors and Python
    values) to ``path``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    saveable = _to_saveable(obj)
    with open(path, "wb") as f:
        pickle.dump(saveable, f, protocol=protocol)


def load(path, return_numpy=False, **config):
    """Read a file :func:`save` (or the reference's) wrote."""
    device = None if return_numpy else current_device()
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_saved(obj, return_numpy, device)

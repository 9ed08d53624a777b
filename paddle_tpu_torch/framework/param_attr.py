"""Parameter attributes and device places of the port
(``paddle_tpu/framework/param_attr.py``). A place names a torch device
(``CPUPlace``, ``CUDAPlace(i)``; ``CUDAPinnedPlace`` is the CPU); the
reference's accelerator places have none here and raise where used.

A :class:`ParamAttr` bundles what a layer's parameter is made with. The
port's layers honour what the reference's ``Layer.create_parameter``
honours (``paddle_tpu/nn/layer/base.py:52-75``): ``initializer`` (before
the global initialiser of ``nn.initializer.set_global_initializer``, which
comes before the layer's default), ``name`` (the parameter's ``param_name``: a
tensor's ``name`` is torch's own and cannot be set) and
``trainable=False`` (``requires_grad=False``). ``learning_rate``,
``regularizer``, ``do_model_average`` and ``need_clip`` are stored and not
read, as in the reference, whose ``create_parameter`` and optimizers never
read them (ROADMAP.md, "Faults in the reference").
"""
from __future__ import annotations

from typing import Any, Optional

__all__ = ["ParamAttr", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace", "NPUPlace"]


class ParamAttr:
    """The reference's parameter attribute bundle (its fields and
    defaults)."""

    def __init__(self, name: Optional[str] = None, initializer: Any = None,
                 learning_rate: float = 1.0, regularizer: Any = None, trainable: bool = True,
                 do_model_average: bool = True, need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    def __repr__(self):
        return (f"ParamAttr(name={self.name!r}, initializer={self.initializer!r}, "
                f"learning_rate={self.learning_rate}, trainable={self.trainable})")


class _Place:
    """A device place (``paddle_tpu/framework/param_attr.py``'s; parity: the
    pybind ``Place`` types). :attr:`device` is the torch device it names; a
    place of a device this build has no counterpart for raises there."""

    _kind = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    @property
    def device(self):
        import torch

        if self._kind == "cpu":
            return torch.device("cpu")
        if self._kind == "gpu":
            return torch.device("cuda", self.device_id)
        raise ValueError(f"{self!r} names no device of this build (CPU and CUDA only)")


class CPUPlace(_Place):
    _kind = "cpu"

    def __init__(self):
        super().__init__(0)

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace(_Place):
    _kind = "gpu"


class CUDAPinnedPlace(_Place):
    _kind = "cpu"

    def __init__(self):
        super().__init__(0)


class TPUPlace(_Place):
    _kind = "tpu"


class NPUPlace(_Place):
    _kind = "npu"

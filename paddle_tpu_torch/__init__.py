"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu`` for NVIDIA
Hopper (H100).

It mirrors ``paddle_tpu``'s subpackage layout so each module has one
counterpart there, and it never imports ``jax`` or ``paddle_tpu``. Every
Pallas kernel of a ported path is a hand-written CUDA kernel under ``csrc/``,
built by ``nvcc`` at first use. Entry points (``models.gpt.GPTForPretraining``,
``models.bert.BertForPretraining``, ``models.ernie.ErnieForPretraining``,
``vision.models.resnet50`` and the other ResNets, ``models.lenet.LeNet``,
``models.dlrm.DLRM``, ``inference.DecodeEngine``, ``io.DataLoader``,
``io.RecordFileLoader``) run on ``cuda`` unless the caller passes
``device="cpu"``; hapi's ``Model`` runs where its network lives.

As ``paddle_tpu/__init__.py`` does for ``paddle.*``, the root holds the
tensor functions flattened (``paddle.add``, ``paddle.to_tensor``, ...), the
dtype names, the framework core (``seed``, ``set_device``, ``save``/``load``,
``grad``, ``no_grad``, ...) and the ported subpackages::

    import paddle_tpu_torch as paddle

    paddle.set_device("cpu")        # the CUDA card when none is set
    x = paddle.to_tensor([[1.0, 2.0]], stop_gradient=False)
    (g,) = paddle.grad(paddle.sum(paddle.exp(x)), x)

``paddle_tpu_torch.Tensor`` is ``torch.Tensor``; torch's own methods are not
changed.
"""
from __future__ import annotations

__version__ = "0.1.0"

import builtins as _builtins

import numpy as _np
import torch as _torch

from .framework.dtype import convert_dtype, get_default_dtype, set_default_dtype  # noqa: F401
from .framework.dtype import to_torch_dtype as _to_torch_dtype
from .framework.flags import get_flags, set_flags  # noqa: F401
from .framework.random import get_rng_state, seed, set_rng_state  # noqa: F401
from .device import get_device, is_compiled_with_tpu, set_device  # noqa: F401
from .tensor import *  # noqa: F401,F403  (the tensor functions, flattened)
from .tensor import to_tensor  # noqa: F401
from . import tensor  # noqa: F401
from .tensor import linalg  # noqa: F401  (paddle.linalg)
from . import amp  # noqa: F401,E402
from . import autograd  # noqa: F401,E402
from . import device  # noqa: F401,E402
from . import distributed  # noqa: F401,E402
from . import inference  # noqa: F401,E402
from . import jit  # noqa: F401,E402
from . import nn  # noqa: F401,E402
from . import observability  # noqa: F401,E402
from . import optimizer  # noqa: F401,E402
from . import quantization  # noqa: F401,E402
from . import regularizer  # noqa: F401,E402
from . import stability  # noqa: F401,E402
from . import analysis  # noqa: F401,E402
from . import utils  # noqa: F401,E402
from . import vision  # noqa: F401,E402
from . import io  # noqa: F401,E402
from . import metric  # noqa: F401,E402
from . import hapi  # noqa: F401,E402
from . import callbacks  # noqa: F401,E402
from .hapi.dynamic_flops import flops  # noqa: F401,E402
from .hapi.model import Model  # noqa: F401,E402
from .autograd import backward  # noqa: F401,E402
from .distributed import DataParallel  # noqa: F401,E402
from .framework.io import load, save  # noqa: F401,E402
from .framework.param_attr import (CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace,  # noqa: F401
                                   ParamAttr, TPUPlace)
from .nn.layer.container import ParameterList  # noqa: F401,E402

Tensor = _torch.Tensor
no_grad = _torch.no_grad
enable_grad = _torch.enable_grad
set_grad_enabled = _torch.set_grad_enabled
is_grad_enabled = _torch.is_grad_enabled


def set_printoptions(precision=None, threshold=None, edgeitems=None, sci_mode=None,
                     linewidth=None):
    """torch's print options (the reference sets numpy's, which print its
    tensors)."""
    _torch.set_printoptions(precision=precision, threshold=threshold, edgeitems=edgeitems,
                            linewidth=linewidth, sci_mode=sci_mode)


def batch(reader, batch_size, drop_last=False):
    """Batch a sample generator (reference ``paddle.batch``)."""

    def gen():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return gen


def summary(net, input_size=None, dtypes=None):
    """``paddle.summary``: hapi ``Model.summary`` of a bare network."""
    return Model(net).summary(input_size)


def check_shape(shape):
    """Validate a shape argument (reference fluid/layers/utils.py:378)."""
    if isinstance(shape, _torch.Tensor):
        return
    for d in shape:
        if not isinstance(d, (int, _np.integer, _torch.Tensor)):
            raise TypeError(f"shape entries must be ints or Tensors, got {type(d).__name__}")
        if isinstance(d, (int, _np.integer)) and d < -1:
            raise ValueError(f"shape dims must be >= -1, got {d}")


def disable_signal_handler():
    """No-op: the port installs no signal handlers of its own."""


def get_cuda_rng_state():
    """The port's stream state (its generators are made from it per draw)."""
    return get_rng_state()


def set_cuda_rng_state(state):
    set_rng_state(state)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None, create_graph=False,
         allow_unused=False):
    """The gradients of ``outputs`` with respect to ``inputs``, as a list
    (ones where ``grad_outputs`` gives none). No ``.grad`` is touched: the
    reference's clears the inputs' ``.grad`` and accumulates into every
    other leaf's (ROADMAP.md, "Faults in the reference"); Paddle's leaves
    them alone, and so does the port. An input the outputs do not reach
    raises ``ValueError`` unless ``allow_unused`` (then its gradient is
    ``None``)."""
    outs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]
    ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    seeds = [_torch.ones_like(o) if g is None else g for o, g in zip(outs, grad_outputs)]
    grads = _torch.autograd.grad(outs, ins, seeds, retain_graph=retain_graph,
                                 create_graph=create_graph, allow_unused=True)
    if not allow_unused and _builtins.any(g is None for g in grads):
        raise ValueError("input tensor unused in graph; pass allow_unused=True")
    return list(grads)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False, default_initializer=None):
    """A standalone parameter on the current device (``set_device``), made
    as a layer's ``create_parameter`` makes one: ``attr``'s initializer,
    else the global one, else ``default_initializer``, else zeros for a
    bias and XavierNormal for a weight; ``name`` (or ``attr.name``) as its
    ``param_name``, ``attr.trainable=False`` as ``requires_grad=False``."""
    from .device import current_device
    from .nn import initializer as _init
    from .nn.layer._attr import finish

    default = default_initializer or (_init.Constant(0.0) if is_bias else _init.XavierNormal())
    value = _init.make(shape, attr, default, None, current_device(), is_bias=is_bias)
    p = finish(_torch.nn.Parameter(value.to(_to_torch_dtype(dtype))), attr)
    if name:
        p.param_name = name
    return p


def device_count() -> int:
    return _torch.cuda.device_count()


# dtype names (reference: paddle.float32 etc.); here the torch dtypes
dtype = _torch.dtype
bool = _torch.bool  # noqa: A001
uint8 = _torch.uint8
int8 = _torch.int8
int16 = _torch.int16
int32 = _torch.int32
int64 = _torch.int64
float16 = _torch.float16
bfloat16 = _torch.bfloat16
float32 = _torch.float32
float64 = _torch.float64
complex64 = _torch.complex64
complex128 = _torch.complex128

"""Activation layers of the port (``paddle_tpu/nn/layer/activation.py``):
modules over the functionals of :mod:`paddle_tpu_torch.nn.functional.activation`,
with the reference's names and arguments."""
from __future__ import annotations

from torch import nn

from ...framework.device import resolve_device
from .. import functional as F
from .. import initializer as I
from ._attr import param


def _simple(name, fn_name, **fixed):
    def __init__(self, name=None):
        nn.Module.__init__(self)

    def forward(self, x):
        return getattr(F, fn_name)(x, **fixed)

    return type(name, (nn.Module,), {"__init__": __init__, "forward": forward,
                                     "__doc__": f"``paddle.nn.{name}``: :func:`{fn_name}`."})


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
Tanh = _simple("Tanh", "tanh")
Hardswish = _simple("Hardswish", "hardswish")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
Mish = _simple("Mish", "mish")
Softsign = _simple("Softsign", "softsign")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")


class _Args(nn.Module):
    """A layer whose forward is one functional with fixed keyword
    arguments, stored as attributes."""

    fn = None
    arg_names = ()

    def __init__(self, *args, **kwargs):
        super().__init__()
        kwargs.pop("name", None)
        for n, v in zip(self.arg_names, args):
            kwargs.setdefault(n, v)
        for n in self.arg_names:
            setattr(self, n, kwargs.get(n, self.defaults[n]))

    def forward(self, x):
        return getattr(F, self.fn)(x, **{n: getattr(self, n) for n in self.arg_names})


def _args(name, fn, **defaults):
    return type(name, (_Args,), {"fn": fn, "arg_names": tuple(defaults), "defaults": defaults,
                                 "__doc__": f"``paddle.nn.{name}``: :func:`{fn}`."})


GELU = _args("GELU", "gelu", approximate=False)
LeakyReLU = _args("LeakyReLU", "leaky_relu", negative_slope=0.01)
ELU = _args("ELU", "elu", alpha=1.0)
SELU = _args("SELU", "selu", scale=1.0507009873554805, alpha=1.6732632423543772)
CELU = _args("CELU", "celu", alpha=1.0)
Hardtanh = _args("Hardtanh", "hardtanh", min=-1.0, max=1.0)
Hardshrink = _args("Hardshrink", "hardshrink", threshold=0.5)
Softshrink = _args("Softshrink", "softshrink", threshold=0.5)
Softplus = _args("Softplus", "softplus", beta=1, threshold=20)
Softmax = _args("Softmax", "softmax", axis=-1)
LogSoftmax = _args("LogSoftmax", "log_softmax", axis=-1)
GLU = _args("GLU", "glu", axis=-1)


class Maxout(nn.Module):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class RReLU(nn.Module):
    """Random leaky ReLU: slopes drawn Uniform(lower, upper) in training
    (from the current random stream), their mean in eval."""

    def __init__(self, lower=0.125, upper=0.3333333, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class PReLU(nn.Module):
    """``paddle.nn.PReLU``: a learnt negative slope (one, or one per
    channel), initialised to ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None, data_format="NCHW", name=None,
                 *, device=None):
        super().__init__()
        self.data_format = data_format
        self.weight = param((num_parameters,), weight_attr, I.Constant(init), None,
                            resolve_device(device), layer="PReLU")

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


__all__ = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Hardswish", "Hardsigmoid", "Silu", "Swish", "Mish",
           "Softsign", "Tanhshrink", "LogSigmoid", "GELU", "LeakyReLU", "ELU", "SELU", "CELU",
           "Hardtanh", "Hardshrink", "Softshrink", "Softplus", "Softmax", "LogSoftmax", "GLU",
           "Maxout", "RReLU", "PReLU"]

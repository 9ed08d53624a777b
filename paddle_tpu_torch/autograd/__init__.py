"""User-facing autograd (``paddle_tpu/autograd``; parity:
python/paddle/autograd): ``PyLayer`` custom functions over
``torch.autograd.Function``, the functional ``vjp``/``jvp``/``jacobian``/
``hessian`` over ``torch.autograd.functional``, and ``backward``."""
from __future__ import annotations

from .functional import hessian, jacobian, jvp, vjp  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401

__all__ = ["backward", "PyLayer", "PyLayerContext", "hessian", "jacobian", "jvp", "vjp"]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of ``tensors`` into the leaves' ``.grad``
    (ones where ``grad_tensors`` gives none, whatever the shape, as the
    reference seeds them)."""
    import torch

    tensors = list(tensors) if isinstance(tensors, (list, tuple)) else [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    grads = [torch.ones_like(t) if g is None else g for t, g in zip(tensors, grad_tensors)]
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph)

"""``PyLayer``: a user's forward and backward pair (``paddle_tpu/autograd/py_layer.py``;
parity: python/paddle/autograd/py_layer.py), over ``torch.autograd.Function``.

The reference's contract (``paddle_tpu/autograd/py_layer.py:80-180``):

- ``ctx.save_for_backward(*tensors)`` / ``ctx.saved_tensor()``, and any
  attribute set on ``ctx`` in forward is there in backward;
- ``ctx.mark_non_differentiable(*outputs)``;
- ``ctx.set_materialize_grads(False)`` passes ``None`` for the gradient of
  an output that received none (zeros otherwise);
- ``backward`` returns one gradient per *tensor* input, or one per
  *differentiable* input (a float tensor that requires grad), in order;
- a tensor passed at two positions gets both partials, summed;
- keyword tensors take part like positional ones (``Function.apply`` takes
  no keywords, so they are bound to positions after the positional ones).
"""
from __future__ import annotations

import torch

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    """Handed to forward and backward: saved tensors and the user's
    attributes."""

    def __init__(self):
        self._saved = []
        self._materialize_grads = True
        self._non_diff = []

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    def saved_tensor(self):
        return list(self._saved)

    def mark_not_inplace(self, *args):
        pass

    def mark_non_differentiable(self, *args):
        self._non_diff = list(args)

    def set_materialize_grads(self, value: bool):
        self._materialize_grads = bool(value)


def _is_diff(t):
    return isinstance(t, torch.Tensor) and t.requires_grad and (t.is_floating_point()
                                                                or t.is_complex())


class _Function(torch.autograd.Function):
    """One ``PyLayer`` call. ``forward`` gets the layer's class, its
    context, the argument layout and then every tensor input, so torch
    routes a gradient to each of them."""

    @staticmethod
    def forward(ctx, layer, pctx, layout, *tensors):
        args, kwargs = _rebuild(layout, tensors)
        out = layer.forward(pctx, *args, **kwargs)
        multi = isinstance(out, (tuple, list))
        outs = tuple(out) if multi else (out,)
        for o in outs:
            if not isinstance(o, torch.Tensor):
                raise TypeError(f"PyLayer.forward must return Tensor(s), got {type(o)}")
        saved = [s for s in pctx._saved if isinstance(s, torch.Tensor)]
        ctx.save_for_backward(*saved)
        ctx.saved_layout = [isinstance(s, torch.Tensor) for s in pctx._saved]
        ctx.saved_other = [s for s in pctx._saved if not isinstance(s, torch.Tensor)]
        pctx._saved = []
        ids = {id(t) for t in pctx._non_diff}
        if ids:
            ctx.mark_non_differentiable(*[o for o in outs if id(o) in ids])
        ctx.set_materialize_grads(pctx._materialize_grads)
        ctx.layer, ctx.pctx, ctx.multi = layer, pctx, multi
        ctx.diff = [_is_diff(t) for t in tensors]
        return outs if multi else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        pctx = ctx.pctx
        it_t, it_o = iter(ctx.saved_tensors), iter(ctx.saved_other)
        pctx._saved = [next(it_t) if is_t else next(it_o) for is_t in ctx.saved_layout]
        gin = ctx.layer.backward(pctx, *grads)
        gin = list(gin) if isinstance(gin, (tuple, list)) else [gin]
        n_diff = sum(ctx.diff)
        if len(gin) == len(ctx.diff):
            per_tensor = gin
        elif len(gin) == n_diff:
            it = iter(gin)
            per_tensor = [next(it) if d else None for d in ctx.diff]
        else:
            raise ValueError(f"PyLayer.backward returned {len(gin)} grads for "
                             f"{len(ctx.diff)} tensor inputs")
        per_tensor = [g if d else None for g, d in zip(per_tensor, ctx.diff)]
        return (None, None, None, *per_tensor)


def _rebuild(layout, tensors):
    """``(args, kwargs)`` from ``layout`` (each argument a tensor slot or
    its value) and the tensors."""
    pos, kw = layout
    args = [tensors[v] if is_t else v for is_t, v in pos]
    kwargs = {k: tensors[v] if is_t else v for k, (is_t, v) in kw.items()}
    return args, kwargs


class PyLayer:
    """The base of a custom autograd function::

        class Cube(PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * x * x

            @staticmethod
            def backward(ctx, dy):
                (x,) = ctx.saved_tensor()
                return 3 * x * x * dy

        y = Cube.apply(x)
    """

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError("PyLayer subclasses must implement forward")

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError("PyLayer subclasses must implement backward")

    @classmethod
    def apply(cls, *args, **kwargs):
        tensors = []

        def slot(v):
            if isinstance(v, torch.Tensor):
                tensors.append(v)
                return True, len(tensors) - 1
            return False, v

        layout = ([slot(a) for a in args], {k: slot(v) for k, v in kwargs.items()})
        return _Function.apply(cls, PyLayerContext(), layout, *tensors)

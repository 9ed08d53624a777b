"""Dynamic FLOPs counter of the port (``paddle_tpu/hapi/dynamic_flops.py``;
reference python/paddle/hapi/dynamic_flops.py:25): forward hooks on the
leaf modules add up multiply-adds of one forward at ``input_size``;
``paddle.flops(net, input_size)`` returns the total. Conv2D, Linear and the
batch norms are counted as the reference counts them; ``custom_ops`` maps a
module type to ``fn(module, x_shape, y_shape)``."""
from __future__ import annotations

import numpy as np
import torch


def _count(layer, x_shape, y_shape, custom_ops=None):
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import Conv2D
    from ..nn.layer.norm import _BatchNormBase

    if custom_ops and type(layer) in custom_ops:
        return int(custom_ops[type(layer)](layer, x_shape, y_shape))
    if isinstance(layer, Conv2D):
        w = layer.weight
        # the weight is [out_c, in_c // groups, kh, kw]: cin is already per group
        kh, kw, cin = int(w.shape[2]), int(w.shape[3]), int(w.shape[1])
        return int(np.prod(y_shape)) * cin * kh * kw
    if isinstance(layer, Linear):
        w = layer.weight  # [in, out]
        batch_elems = int(np.prod(x_shape)) // int(w.shape[0])
        return batch_elems * int(w.shape[0]) * int(w.shape[1])
    if isinstance(layer, _BatchNormBase):
        return 2 * int(np.prod(y_shape))
    return 0


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Multiply-adds of one forward at ``input_size`` (the batch dim
    included), counted on the network's device with the real forward, so
    dynamic control flow is honoured."""
    from ..framework.dtype import get_default_dtype, to_torch_dtype

    rows = []
    handles = []

    def hook(name):
        def fn(layer, inputs, output):
            xs = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
            n = _count(layer, tuple(xs.shape),
                       tuple(output.shape) if hasattr(output, "shape") else (), custom_ops)
            if n:
                rows.append((name, type(layer).__name__, n))

        return fn

    for name, sub in net.named_modules():
        if name and next(sub.children(), None) is None:  # the leaves
            handles.append(sub.register_forward_hook(hook(name)))
    was_training = net.training
    net.eval()
    param = next(net.parameters(), None)
    device = param.device if param is not None else torch.device("cpu")
    x = torch.zeros(tuple(input_size), dtype=to_torch_dtype(get_default_dtype()), device=device)
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in handles:
            h.remove()
        net.train(was_training)
    total = sum(n for _, _, n in rows)
    if print_detail:
        for name, kind, n in rows:
            print(f"{name:<40} {kind:<16} {n:>14,}")
        print(f"{'total':<40} {'':<16} {total:>14,}")
    return total

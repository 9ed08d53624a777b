"""Container layers of the port (``paddle_tpu/nn/layer/container.py``):
Paddle's names and call signatures over ``torch.nn``'s containers, which
name their children ``"0"``, ``"1"``, ... as the reference's do, so a state
carries across by name."""
from __future__ import annotations

from collections import OrderedDict

from torch import nn


class Sequential(nn.Sequential):
    """``paddle.nn.Sequential(*layers)``: the layers in order, or
    ``(name, layer)`` pairs (as arguments, or one list of them) named as
    given."""

    def __init__(self, *layers):
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple)) and layers[0]
                and isinstance(layers[0][0], tuple)):
            layers = tuple(layers[0])
        if layers and all(isinstance(layer, tuple) for layer in layers):
            super().__init__(OrderedDict(layers))
        else:
            super().__init__()
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_module(layer[0], layer[1])
                else:
                    self.add_module(str(i), layer)


class LayerList(nn.ModuleList):
    """``paddle.nn.LayerList``: ``append``, ``extend``, ``insert``, indexing
    (negative too) and slicing, as ``nn.ModuleList``."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(nn.ParameterList):
    """``paddle.nn.ParameterList``."""

    def __init__(self, parameters=None):
        super().__init__(parameters)


class LayerDict(nn.ModuleDict):
    """``paddle.nn.LayerDict``: a dict of layers (or ``(name, layer)``
    pairs), iterated by name."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)

"""Paddle-named tensor functions over torch tensors (``paddle_tpu/tensor``;
parity: python/paddle/tensor).

The reference's 281 public functions in its seven modules: ``creation``
(with the random functions), ``math``, ``manipulation``, ``logic``,
``search``, ``stat`` and ``linalg``. Each takes and returns
``torch.Tensor``s with the reference's signature and casts its inputs at
entry under the reference's op name (:func:`paddle_tpu_torch.amp.cast_inputs`),
so an ``auto_cast`` scope's lists, custom ones included, act on every
function as the reference's dispatcher hook makes them act. There is no
``Tensor`` wrapper and ``torch.Tensor`` is not patched: ``x.add(y)`` is
torch's method, ``paddle.add(x, y)`` the reference's function.
"""
from __future__ import annotations

from . import creation, linalg, logic, manipulation, math, search, stat
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403

_MODULES = (creation, math, manipulation, logic, search, stat, linalg)

__all__ = list(dict.fromkeys(n for m in _MODULES for n in m.__all__))


def _public_funcs():
    """Every public function by name."""
    return {n: globals()[n] for n in __all__}

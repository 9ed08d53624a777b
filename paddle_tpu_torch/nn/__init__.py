"""``paddle.nn`` of the port (``paddle_tpu/nn/__init__.py``): every layer of
:mod:`paddle_tpu_torch.nn.layer`, the gradient clips, ``functional`` and
``initializer``. Not here, by decision: ``Layer`` and ``Parameter`` (the
port's layers are ``torch.nn.Module``s with ``torch.nn.Parameter``s) and
the reference's ``functional_call``/``unwrap_tree`` (torch differentiates
modules directly); ``quant`` waits for ROADMAP.md item 14."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_  # noqa: F401
from .layer import *  # noqa: F401,F403

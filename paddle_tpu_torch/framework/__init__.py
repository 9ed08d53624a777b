"""The framework core of the port (``paddle_tpu/framework/``), with the names
the reference's ``framework/__init__.py`` re-exports. Not here: the
reference's tape and JAX machinery (``primitive``, ``unwrap``,
``to_jax_dtype``, ``jax_compat``; torch's tensors and autograd stand in,
and ``to_torch_dtype`` for the last), and ``StringTensor`` and
``FasterTokenizer`` (ROADMAP.md, Queue 1 item 12 part d)."""
import torch as _torch

from ..autograd import backward  # noqa: F401
from ..device import get_device, is_compiled_with_tpu, set_device  # noqa: F401
from .dtype import convert_dtype, get_default_dtype, set_default_dtype, to_torch_dtype  # noqa: F401
from .flags import define_flag, flag, get_flags, set_flags  # noqa: F401
from .random import (get_rng_state, host_generator, rng_scope, seed, set_rng_state,  # noqa: F401
                     split_key)
from .selected_rows import SelectedRows  # noqa: F401

Tensor = _torch.Tensor
no_grad = _torch.no_grad
enable_grad = _torch.enable_grad
set_grad_enabled = _torch.set_grad_enabled
is_grad_enabled = _torch.is_grad_enabled

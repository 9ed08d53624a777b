"""Flag registry of the port: the flags its ported modules read, with the
names and defaults of ``paddle_tpu/framework/flags.py``. A flag is
overridable from the environment (``FLAGS_*``) when it is defined."""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default, help_str: str = ""):
    env = os.environ.get(name)
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _REGISTRY[name] = value
    return value


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        if k not in _REGISTRY:
            raise KeyError(f"unknown flag {k!r}")
        _REGISTRY[k] = v


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    return {k: _REGISTRY[k] for k in flags}


def flag(name: str):
    return _REGISTRY[name]


define_flag("FLAGS_use_flash_attention", True, "use the hand-written flash-attention kernel where it takes the call")
define_flag("FLAGS_flash_flat", False, "route masked/GQA sdpa (impl flash_flat_gqa) and attention_core (impl flash_packed) to the flat flash kernels K3/K3b; off by default, as in the reference")
define_flag("FLAGS_kernel_overrides", "", "force kernel-registry implementations per kernel, e.g. 'attention_core=xla' (see paddle_tpu_torch.ops.registry); forced impls bypass availability predicates; unknown impl names raise at dispatch")
define_flag("FLAGS_remat_policy", "none", "default rematerialization policy for jit steps: any value but 'none' turns TrainStep's remat on")

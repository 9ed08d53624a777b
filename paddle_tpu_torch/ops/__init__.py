"""The port's ops. Each hand-written kernel has a wrapper whose
``launches`` attribute counts the kernel's launches in this process."""
from __future__ import annotations

from typing import Callable, Dict, Tuple


def kernel_wrappers() -> Tuple[Callable, ...]:
    """The wrapper of every hand-written kernel: K1, K2 (flash attention
    forward and backward), K3, K3b (flat flash) and K4, K4b (the grouped
    expert FFN)."""
    from .flash_attention import flash_attention_bwd, flash_attention_fwd
    from .flash_attention_flat import flash_flat_bwd, flash_flat_fwd
    from .moe_pallas import moe_grouped_ffn_bwd, moe_grouped_ffn_fwd

    return (flash_attention_fwd, flash_attention_bwd, flash_flat_fwd, flash_flat_bwd,
            moe_grouped_ffn_fwd, moe_grouped_ffn_bwd)


def kernel_launches() -> Dict[str, int]:
    """Each kernel's launches in this process, by its wrapper's name."""
    return {w.__name__: int(w.launches) for w in kernel_wrappers()}

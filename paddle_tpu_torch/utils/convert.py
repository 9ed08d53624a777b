"""Weights from ``paddle_tpu`` to the port.

The port's ``GPTForPretraining`` keeps the reference's parameter names
(``gpt.embeddings.word_embeddings.weight``, ``gpt.layers.qkv_w``,
``gpt.final_norm.bias``, ...) and its ``[in, out]`` weight layout, so the
mapping is by name with no transposes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_STACK = ("norm1_w", "norm1_b", "qkv_w", "qkv_b", "out_w", "out_b",
          "norm2_w", "norm2_b", "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b")
# paddle_tpu GPTForPretraining state_dict name -> the port's name
GPT_NAMES: Dict[str, str] = {
    "gpt.embeddings.word_embeddings.weight": "gpt.embeddings.word_embeddings.weight",
    "gpt.embeddings.position_embeddings.weight": "gpt.embeddings.position_embeddings.weight",
    **{f"gpt.layers.{n}": f"gpt.layers.{n}" for n in _STACK},
    "gpt.final_norm.weight": "gpt.final_norm.weight",
    "gpt.final_norm.bias": "gpt.final_norm.bias",
}


def _expected_shapes(np_state) -> Dict[str, tuple]:
    V, D = np_state["gpt.embeddings.word_embeddings.weight"].shape
    S = np_state["gpt.embeddings.position_embeddings.weight"].shape[0]
    L = np_state["gpt.layers.qkv_w"].shape[0]
    Ff = np_state["gpt.layers.ffn1_w"].shape[-1]
    stack = {"norm1_w": (L, D), "norm1_b": (L, D), "qkv_w": (L, D, 3 * D), "qkv_b": (L, 3 * D),
             "out_w": (L, D, D), "out_b": (L, D), "norm2_w": (L, D), "norm2_b": (L, D),
             "ffn1_w": (L, D, Ff), "ffn1_b": (L, Ff), "ffn2_w": (L, Ff, D), "ffn2_b": (L, D)}
    return {"gpt.embeddings.word_embeddings.weight": (V, D),
            "gpt.embeddings.position_embeddings.weight": (S, D),
            **{f"gpt.layers.{n}": shape for n, shape in stack.items()},
            "gpt.final_norm.weight": (D,), "gpt.final_norm.bias": (D,)}


def state_dict_from_paddle_tpu(np_state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A ``paddle_tpu`` ``GPTForPretraining`` state_dict (stacked trunk, as
    numpy arrays) as the port's state_dict (CPU tensors; ``load_state_dict``
    copies them to the model's device). Raises ``KeyError`` on a missing or
    extra name and ``ValueError`` on a shape that does not fit the others."""
    missing = sorted(set(GPT_NAMES) - set(np_state))
    extra = sorted(set(np_state) - set(GPT_NAMES))
    if missing or extra:
        raise KeyError(f"paddle_tpu GPT state_dict does not match: missing {missing}, extra {extra}")
    out = {}
    for name, shape in _expected_shapes(np_state).items():
        arr = np.asarray(np_state[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[GPT_NAMES[name]] = torch.tensor(arr)
    return out

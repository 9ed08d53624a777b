"""Weights from ``paddle_tpu`` to the port.

The port's ``GPTForPretraining`` keeps the reference's parameter names and
its ``[in, out]`` weight layout, so a state converts name for name with no
transposes; what is checked is that the names and shapes fit one model.
Both trunks convert:

- stacked (``GPTConfig(stacked=True)``): ``gpt.layers.qkv_w`` etc.,
  ``[L, ...]``;
- per layer (``stacked=False``, and GPT-MoE): ``gpt.layers.N.norm1.weight``,
  ``gpt.layers.N.attn.qkv_proj.weight``, ``gpt.layers.N.ffn1.weight``, ...,
  and in a MoE block ``gpt.layers.N.moe.gate.weight`` and
  ``gpt.layers.N.moe.w1|b1|w2|b2`` in place of the dense FFN.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_STACK = ("norm1_w", "norm1_b", "qkv_w", "qkv_b", "out_w", "out_b",
          "norm2_w", "norm2_b", "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b")
_OUTER = ("gpt.embeddings.word_embeddings.weight", "gpt.embeddings.position_embeddings.weight",
          "gpt.final_norm.weight", "gpt.final_norm.bias")
_LAYER_KEY = re.compile(r"gpt\.layers\.(\d+)\.")


def _outer_shapes(np_state, V, D):
    S = np.asarray(np_state["gpt.embeddings.position_embeddings.weight"]).shape[0]
    return {"gpt.embeddings.word_embeddings.weight": (V, D),
            "gpt.embeddings.position_embeddings.weight": (S, D),
            "gpt.final_norm.weight": (D,), "gpt.final_norm.bias": (D,)}


def _stacked_shapes(np_state) -> Dict[str, tuple]:
    V, D = np_state["gpt.embeddings.word_embeddings.weight"].shape
    L = np_state["gpt.layers.qkv_w"].shape[0]
    Ff = np_state["gpt.layers.ffn1_w"].shape[-1]
    stack = {"norm1_w": (L, D), "norm1_b": (L, D), "qkv_w": (L, D, 3 * D), "qkv_b": (L, 3 * D),
             "out_w": (L, D, D), "out_b": (L, D), "norm2_w": (L, D), "norm2_b": (L, D),
             "ffn1_w": (L, D, Ff), "ffn1_b": (L, Ff), "ffn2_w": (L, Ff, D), "ffn2_b": (L, D)}
    return {**_outer_shapes(np_state, V, D),
            **{f"gpt.layers.{n}": shape for n, shape in stack.items()}}


# the names under gpt.layers.N. of a per-layer block: attention and norms,
# then either the dense FFN or the MoE layer
_BLOCK = ("norm1.weight", "norm1.bias", "attn.qkv_proj.weight", "attn.qkv_proj.bias",
          "attn.out_proj.weight", "attn.out_proj.bias", "norm2.weight", "norm2.bias")
_FFN = ("ffn1.weight", "ffn1.bias", "ffn2.weight", "ffn2.bias")
_MOE = ("moe.gate.weight", "moe.w1", "moe.b1", "moe.w2", "moe.b2")


def _leaf_shape(leaf, D, Ff, E):
    return {"attn.qkv_proj.weight": (D, 3 * D), "attn.qkv_proj.bias": (3 * D,),
            "attn.out_proj.weight": (D, D), "ffn1.weight": (D, Ff), "ffn1.bias": (Ff,),
            "ffn2.weight": (Ff, D), "moe.gate.weight": (D, E), "moe.w1": (E, D, Ff),
            "moe.b1": (E, 1, Ff), "moe.w2": (E, Ff, D), "moe.b2": (E, 1, D)}.get(leaf, (D,))


def _per_layer_shapes(np_state) -> Dict[str, tuple]:
    """The names a per-layer state must hold, with their shapes: L from the
    highest layer index present, a layer is MoE when any of its names is
    under ``moe.``, E from its gate and the FFN width from the first
    ``ffn1``/``moe.w1`` present."""
    V, D = np.asarray(np_state["gpt.embeddings.word_embeddings.weight"]).shape
    layers = {int(m.group(1)) for k in np_state if (m := _LAYER_KEY.match(k))}
    moe = {int(m.group(1)) for k in np_state if (m := _LAYER_KEY.match(k)) and ".moe." in k}
    widths = [np.asarray(v).shape[-1] for k, v in np_state.items()
              if k.endswith((".ffn1.weight", ".moe.w1"))]
    Ff = widths[0] if widths else 4 * D
    shapes = _outer_shapes(np_state, V, D)
    for i in range(max(layers) + 1 if layers else 0):
        p = f"gpt.layers.{i}."
        gate = np_state.get(p + "moe.gate.weight")
        E = np.asarray(gate).shape[-1] if gate is not None else 0
        for leaf in _BLOCK + (_MOE if i in moe else _FFN):
            shapes[p + leaf] = _leaf_shape(leaf, D, Ff, E)
    return shapes


def state_dict_from_paddle_tpu(np_state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A ``paddle_tpu`` ``GPTForPretraining`` state_dict (as numpy arrays),
    of either trunk, as the port's state_dict (CPU tensors;
    ``load_state_dict`` copies them to the model's device). The trunk is the
    stacked one when any stacked name is present. Raises ``KeyError`` on a
    missing or extra name and ``ValueError`` on a shape that does not fit
    the others."""
    stacked = any(f"gpt.layers.{n}" in np_state for n in _STACK) or not any(
        _LAYER_KEY.match(k) for k in np_state)
    if stacked:
        expected = set(_OUTER) | {f"gpt.layers.{n}" for n in _STACK}
    else:
        expected = set(_per_layer_shapes(np_state))
    missing = sorted(expected - set(np_state))
    extra = sorted(set(np_state) - expected)
    if missing or extra:
        raise KeyError(f"paddle_tpu GPT state_dict does not match: missing {missing}, extra {extra}")
    shapes = _stacked_shapes(np_state) if stacked else _per_layer_shapes(np_state)
    out = {}
    for name, shape in shapes.items():
        arr = np.asarray(np_state[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = torch.tensor(arr)
    return out

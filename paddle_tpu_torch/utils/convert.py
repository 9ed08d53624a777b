"""Weights from ``paddle_tpu`` to the port.

The port's ``GPTForPretraining`` and ``BertForPretraining`` keep the
reference's parameter names and its ``[in, out]`` weight layout, so a state
converts name for name with no transposes; what is checked is that the
names and shapes fit one model. Both GPT trunks convert:

- stacked (``GPTConfig(stacked=True)``): ``gpt.layers.qkv_w`` etc.,
  ``[L, ...]``;
- per layer (``stacked=False``, and GPT-MoE): ``gpt.layers.N.norm1.weight``,
  ``gpt.layers.N.attn.qkv_proj.weight``, ``gpt.layers.N.ffn1.weight``, ...,
  and in a MoE block ``gpt.layers.N.moe.gate.weight`` and
  ``gpt.layers.N.moe.w1|b1|w2|b2`` in place of the dense FFN.

BERT's names: ``bert.embeddings.{word,position,token_type}_embeddings.weight``,
``bert.embeddings.norm.*``, ``bert.layers.N.attn.qkv_proj.weight`` etc. (the
per-layer block names of GPT), ``bert.pooler.*``, ``transform.*``,
``transform_norm.*`` and ``nsp.*``. ERNIE's are BERT's under ``ernie.``, plus
``ernie.embeddings.task_type_embeddings.weight`` (where the config uses task
ids), with ``sop.*`` in place of ``nsp.*``.

A GPT state converts the same whatever its config's recompute settings:
recompute changes no parameter.

The vision models (``vision.models.resnet``'s family and ``models.lenet``)
keep the reference's module names, its ``[out, in / groups, kh, kw]``
convolution weights and ``[in, out]`` ``Linear`` weights, and its batch-norm
buffers ``_mean`` and ``_variance``; :func:`state_dict_by_name` carries
such a state across name for name, checked against the target model.
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


# encoder family -> (its trunk's prefix, its sentence-level head)
_ENCODERS = {"BERT": ("bert", "nsp"), "ERNIE": ("ernie", "sop")}
_TASK_TABLE = "ernie.embeddings.task_type_embeddings.weight"


def _encoder_shapes(np_state, family) -> Dict[str, tuple]:
    """The names a ``BertForPretraining`` or ``ErnieForPretraining`` state
    must hold, with their shapes: L from the highest layer index present,
    the embedding tables' rows and the FFN width from the state; ERNIE's
    task-type table where the state has one."""
    pre, head = _ENCODERS[family]
    V, D = np.asarray(np_state[f"{pre}.embeddings.word_embeddings.weight"]).shape
    tables = ("position", "token_type") + (("task_type",) if _TASK_TABLE in np_state else ())
    rows = {name: np.asarray(np_state[key]).shape[0] for name in tables
            if (key := f"{pre}.embeddings.{name}_embeddings.weight") in np_state}
    layer_key = re.compile(pre + r"\.layers\.(\d+)\.")
    layers = {int(m.group(1)) for k in np_state if (m := layer_key.match(k))}
    widths = [np.asarray(v).shape[-1] for k, v in np_state.items() if k.endswith(".ffn1.weight")]
    Ff = widths[0] if widths else 4 * D
    shapes = {f"{pre}.embeddings.word_embeddings.weight": (V, D),
              **{f"{pre}.embeddings.{name}_embeddings.weight": (rows.get(name, 0), D)
                 for name in tables},
              f"{pre}.embeddings.norm.weight": (D,), f"{pre}.embeddings.norm.bias": (D,),
              f"{pre}.pooler.weight": (D, D), f"{pre}.pooler.bias": (D,),
              "transform.weight": (D, D), "transform.bias": (D,),
              "transform_norm.weight": (D,), "transform_norm.bias": (D,),
              f"{head}.weight": (D, 2), f"{head}.bias": (2,)}
    for i in range(max(layers) + 1 if layers else 0):
        for leaf in _BLOCK + _FFN:
            shapes[f"{pre}.layers.{i}.{leaf}"] = _leaf_shape(leaf, D, Ff, 0)
    return shapes


def state_dict_from_paddle_tpu(np_state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A ``paddle_tpu`` ``GPTForPretraining`` state_dict (as numpy arrays),
    of either trunk, or a ``BertForPretraining`` or ``ErnieForPretraining``
    one, as the port's state_dict (CPU tensors; ``load_state_dict`` copies
    them to the model's device). BERT and ERNIE are recognised by their word
    table's name; a GPT trunk is the stacked one when any stacked name is
    present. Raises ``KeyError`` on a missing or extra name and
    ``ValueError`` on a shape that does not fit the others."""
    encoders = [f for f, (pre, _) in _ENCODERS.items()
                if f"{pre}.embeddings.word_embeddings.weight" in np_state]
    if encoders:
        family = encoders[0]
        shapes_of = lambda state: _encoder_shapes(state, family)  # noqa: E731
        expected = set(shapes_of(np_state))
    elif any(f"gpt.layers.{n}" in np_state for n in _STACK) or not any(
            _LAYER_KEY.match(k) for k in np_state):
        family, shapes_of = "GPT", _stacked_shapes
        expected = set(_OUTER) | {f"gpt.layers.{n}" for n in _STACK}
    else:
        family, shapes_of, expected = "GPT", _per_layer_shapes, set(_per_layer_shapes(np_state))
    missing = sorted(expected - set(np_state))
    extra = sorted(set(np_state) - expected)
    if missing or extra:
        raise KeyError(f"paddle_tpu {family} state_dict does not match: missing {missing}, "
                       f"extra {extra}")
    shapes = shapes_of(np_state)
    out = {}
    for name, shape in shapes.items():
        arr = np.asarray(np_state[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = torch.tensor(arr)
    return out


def state_dict_by_name(np_state: Dict[str, np.ndarray],
                       model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A ``paddle_tpu`` state_dict (parameters and buffers, as numpy
    arrays) as ``model``'s state_dict (CPU tensors), tensor for tensor as
    it is: a ResNet or LeNet, whose names and layouts are the reference's.
    Raises ``KeyError`` unless the names are exactly ``model``'s and
    ``ValueError`` on a shape that differs from ``model``'s."""
    want = model.state_dict()
    missing = sorted(set(want) - set(np_state))
    extra = sorted(set(np_state) - set(want))
    if missing or extra:
        raise KeyError(f"paddle_tpu state_dict does not match {type(model).__name__}: "
                       f"missing {missing}, extra {extra}")
    out = {}
    for name, t in want.items():
        arr = np.asarray(np_state[name])
        if arr.shape != tuple(t.shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(t.shape)}")
        out[name] = torch.tensor(arr)
    return out

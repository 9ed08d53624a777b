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
such a state across name for name, checked against the target model, and
DLRM's the same way (``bottom.N.*``, ``embedding.weight`` padded to
``pad_multiple`` rows, ``top.N.*``; the model's offset and interaction
index buffers are not part of the state).
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..models.gpt import STACK_MP_SPLITS

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
    it is: a ResNet, LeNet or DLRM, whose names and layouts are the
    reference's.
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


# The tensor-parallel layout: (axis, blocks) of each sharded leaf. BERT's
# (and ERNIE's) fused qkv projection splits each of its q, k and v column
# blocks on its own, so a rank holds whole heads, as GPT's stacked qkv_w and
# qkv_b do (models.gpt.STACK_MP_SPLITS); every name not listed is
# replicated.
_BERT_SHARDS = {"attn.qkv_proj.weight": (1, 3), "attn.qkv_proj.bias": (0, 3),
                "attn.out_proj.weight": (0, 1), "ffn1.weight": (1, 1), "ffn1.bias": (0, 1),
                "ffn2.weight": (0, 1)}
_BERT_LAYER_KEY = re.compile(r"(?:bert|ernie)\.layers\.\d+\.(.+)$")
_WORD_TABLES = ("bert.embeddings.word_embeddings.weight", "ernie.embeddings.word_embeddings.weight",
                "gpt.embeddings.word_embeddings.weight")
_GPT_STACK_KEY = re.compile(r"gpt\.layers\.([a-z0-9_]+)$")


def _mp_spec(name):
    """``(axis, blocks)`` of a tensor-parallel leaf, or None."""
    if name in _WORD_TABLES:
        return 0, 1
    m = _GPT_STACK_KEY.match(name)
    if m:
        return STACK_MP_SPLITS.get(m.group(1))
    m = _BERT_LAYER_KEY.match(name)
    return _BERT_SHARDS.get(m.group(1)) if m else None


_EXPERT_KEY = re.compile(r"gpt\.layers\.\d+\.moe\.(w1|b1|w2|b2)$")


def _expert(name):
    """Whether ``name`` is a GPT-MoE expert weight, split over the expert
    group along dim 0."""
    return bool(_EXPERT_KEY.match(name))


def _stacked(name):
    m = _GPT_STACK_KEY.match(name)
    return bool(m) and m.group(1) in _STACK


def _on_stage(name, pp_rank, pp_degree):
    """Whether GPT's pipeline stage ``pp_rank`` holds ``name``: the word
    table on the first and the last, the position table on the first, the
    final LayerNorm on the last, the trunk's slice on every stage."""
    first, last = pp_rank == 0, pp_rank == pp_degree - 1
    if name == "gpt.embeddings.word_embeddings.weight":
        return first or last
    if name == "gpt.embeddings.position_embeddings.weight":
        return first
    if name.startswith("gpt.final_norm."):
        return last
    return True


def _check_mp(cfg, mp_degree):
    if cfg.num_heads % mp_degree or cfg.vocab_size % mp_degree or cfg.ffn_hidden_size % mp_degree:
        raise ValueError(f"{type(cfg).__name__} (heads {cfg.num_heads}, vocab {cfg.vocab_size}, "
                         f"FFN {cfg.ffn_hidden_size}) does not split over mp degree {mp_degree}")


def _array(x):
    """A tensor as it is, anything else as a numpy array."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _contiguous(x):
    return x.contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)


def _cat(parts):
    return torch.cat(parts) if isinstance(parts[0], torch.Tensor) else np.concatenate(parts)


def _split(arr, axis, blocks, n, r):
    """Piece ``r`` of ``n`` of each of the ``blocks`` blocks along ``axis``
    (of a numpy array or a tensor, returned as the same)."""
    size = arr.shape[axis]
    if size % (blocks * n):
        raise ValueError(f"dim {axis} of size {size} does not split into {blocks} x {n}")
    head, tail = tuple(arr.shape[:axis]), tuple(arr.shape[axis + 1:])
    parts = arr.reshape(head + (blocks, n, size // (blocks * n)) + tail)
    piece = (parts.select(axis + 1, r) if isinstance(parts, torch.Tensor)
             else np.take(parts, r, axis=axis + 1))
    return piece.reshape(head + (size // n,) + tail)


def _join(parts, axis, blocks):
    """:func:`_split`'s inverse over the pieces in rank order."""
    local = parts[0].shape[axis]
    head, tail = tuple(parts[0].shape[:axis]), tuple(parts[0].shape[axis + 1:])
    split = [p.reshape(head + (blocks, local // blocks) + tail) for p in parts]
    # [.., blocks, n, local / blocks, ..]
    full = (torch.stack(split, dim=axis + 1) if isinstance(split[0], torch.Tensor)
            else np.stack(split, axis=axis + 1))
    return full.reshape(head + (local * len(parts),) + tail)


def shard_state(np_state: Dict[str, np.ndarray], mp_rank: int = 0, mp_degree: int = 1, cfg=None,
                *, pp_rank: int = 0, pp_degree: int = 1, sdp_rank: int = 0, sdp_degree: int = 1,
                sdp_dims=None, ep_rank: int = 0, ep_degree: int = 1) -> Dict[str, np.ndarray]:
    """What the rank at (``pp_rank``, ``sdp_rank``, ``mp_rank``) of a fleet
    grid holds of a full state (numpy arrays or tensors, returned as they
    came; the reference's names; BERT, ERNIE or stacked GPT): its
    model-parallel shard of each tensor-parallel leaf (the vocabulary rows of the word table, the q, k
    and v columns of the rank's heads in the qkv projection, the column
    shards of the first FFN layer and the row shards of the output and
    second FFN layers), for GPT its pipeline stage's layers and tables, and
    with ``sdp_dims`` (a parameter's ZeRO split dim by name, as
    ``sharding.state_shardings`` gives it) its ZeRO block (stage 3's
    parameters, any stage's moments); for GPT-MoE, at expert degree
    ``ep_degree`` (the ``dp`` degree), its experts: rows ``[ep_rank * E /
    ep, (ep_rank + 1) * E / ep)`` of each expert weight (``moe.w1``,
    ``b1``, ``w2``, ``b2``)."""
    if cfg is not None:
        _check_mp(cfg, mp_degree)
    out = {}
    for name, arr in np_state.items():
        if not _on_stage(name, pp_rank, pp_degree):
            continue
        arr = _array(arr)
        try:
            if pp_degree > 1 and _stacked(name):
                arr = _split(arr, 0, 1, pp_degree, pp_rank)
            spec = _mp_spec(name) if mp_degree > 1 else None
            if spec is not None:
                arr = _split(arr, spec[0], spec[1], mp_degree, mp_rank)
            dim = (sdp_dims or {}).get(name)
            if dim is not None and sdp_degree > 1:
                arr = _split(arr, dim, 1, sdp_degree, sdp_rank)
            if ep_degree > 1 and _expert(name):
                arr = _split(arr, 0, 1, ep_degree, ep_rank)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
        out[name] = _contiguous(arr)
    return out


def gather_state(states, cfg=None, sdp_dims=None) -> Dict[str, np.ndarray]:
    """The full state from the ranks' (numpy arrays or tensors):
    :func:`shard_state`'s inverse. ``states`` is a list in mp rank order, or a dict of them by
    ``(pp_rank, sdp_rank, mp_rank)`` or ``(pp_rank, sdp_rank, mp_rank,
    ep_rank)``; with ``sdp_dims`` the entries split over ``sdp`` are joined
    from every sdp rank's block, the rest taken from sdp rank 0 (and the
    replicated ones from mp rank 0, the tied word table from the first
    stage); GPT-MoE's expert weights are joined from every ep rank's, the
    rest taken from ep rank 0."""
    if not isinstance(states, dict):
        states = {(0, 0, m): st for m, st in enumerate(states)}
    if len(next(iter(states))) == 4:
        by_ep = [gather_state({k[:3]: st for k, st in states.items() if k[3] == e}, cfg, sdp_dims)
                 for e in range(1 + max(k[3] for k in states))]
        return {n: _contiguous(_cat([_array(part[n]) for part in by_ep])) if _expert(n) else v
                for n, v in by_ep[0].items()}
    pp = 1 + max(k[0] for k in states)
    sdp = 1 + max(k[1] for k in states)
    mp = 1 + max(k[2] for k in states)
    if cfg is not None:
        _check_mp(cfg, mp)
    names = []
    for key in sorted(states):
        names += [n for n in states[key] if n not in names]
    out = {}
    for name in names:
        stages = []
        for s in range(pp):
            if name not in states[(s, 0, 0)]:
                continue
            by_mp = []
            for m in range(mp):
                dim = (sdp_dims or {}).get(name)
                if dim is not None and sdp > 1:
                    by_mp.append(_join([_array(states[(s, d, m)][name]) for d in range(sdp)],
                                       dim, 1))
                else:
                    by_mp.append(_array(states[(s, 0, m)][name]))
            spec = _mp_spec(name) if mp > 1 else None
            stages.append(_join(by_mp, spec[0], spec[1]) if spec is not None else by_mp[0])
        out[name] = _contiguous(_cat(stages) if pp > 1 and _stacked(name) else stages[0])
    return out

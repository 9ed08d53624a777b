"""Cross-mesh checkpoint conversion of the port
(``paddle_tpu/distributed/converter.py``; parity: auto_parallel/converter.py,
SURVEY §7's "hard part": restore a checkpoint saved under mesh A onto mesh B).

The reference's checkpoint leaf is a global array, and a conversion is one
``device_put`` under the target's sharding. A rank of the port holds only
its pieces, so the two halves are explicit here:

- **writing** (:func:`gather_to_host`): a ``TrainStep``'s state joined
  whole on the host: the experts over their group, the ZeRO blocks over
  ``sdp`` (the step's :class:`~.sharding.ZeroPlan`: a stage-3 parameter's
  block, any stage's moments), the model-parallel shards over ``mp``, and
  the pipeline stages' pieces (:func:`~paddle_tpu_torch.utils.convert.gather_state`).
  Every rank computes the same whole state.
- **restoring** (:func:`convert` onto a ``TrainStep``): the rank's pieces
  cut from the whole state by
  :func:`~paddle_tpu_torch.utils.convert.shard_state` (the stage's layers,
  the mp shard, the ZeRO block of the target's plan, the experts), checked
  against the step's own leaves and loaded into it.

Which leaf is split, along which dim and in how many column blocks, is
``utils.convert``'s rule alone: both halves join and cut by it. So a checkpoint written at sdp 2 restores at world 1, and one
  written at world 1 restores at sdp 2.

What the module adds over a bare copy, as the reference's does:

- **Validation first.** A checkpoint that cannot be converted (missing
  leaf, extra leaf, shape or dtype drift: a model whose config changed
  between save and resume) raises :class:`CheckpointConversionError`
  naming the first mismatched leaf.
- **Accounting.** Conversions are counted (``converter.reshards``,
  ``converter.bytes``) and logged (``reshard`` run-log events with leaf
  count, bytes and seconds).
- **CRC safety.** ``CheckpointManager._load_verified`` verifies the
  manifest's checksums on the host bytes before conversion, so mesh A ->
  save -> restore on mesh B -> save -> restore on mesh A is bitwise.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..observability import runlog as _runlog
from ..observability.metrics import counter_inc as _counter_inc
from .checkpoint import _is_step, flatten, tree_map

__all__ = ["CheckpointConversionError", "convert", "tree_shardings", "gather_to_host"]


class CheckpointConversionError(RuntimeError):
    """A checkpoint cannot be converted onto the requested target: the
    trees disagree (missing/extra leaf) or a leaf's shape/dtype changed.
    Carries ``.leaf``, the key path of the first mismatch."""

    def __init__(self, message: str, leaf: Optional[str] = None):
        super().__init__(message)
        self.leaf = leaf


def _flat(tree) -> Dict[str, Any]:
    return dict(flatten(tree))


def tree_shardings(tree) -> Dict[str, Any]:
    """Key path -> the device of each tensor leaf (None for host arrays
    and scalars); for a ``TrainStep``, of its own (local) state. The
    inverse question of ``convert``: where does this target live?"""
    if _is_step(tree):
        tree = tree.state
    return {k: (leaf.device if isinstance(leaf, torch.Tensor) else None)
            for k, leaf in _flat(tree).items()}


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return np.array(leaf)
    return leaf


def gather_to_host(tree):
    """Every leaf as a host value (tensors as CPU tensors, arrays as numpy):
    the first half of a cross-mesh conversion. A ``TrainStep``'s state is
    joined whole over its mesh (a collective: every rank of the mesh calls
    it)."""
    if _is_step(tree):
        return _gather_step(tree)
    return tree_map(_host, tree)


# -- a TrainStep's pieces ------------------------------------------------------
def _layout(step):
    """``(groups, coords, sdp_dims)`` of ``step``'s mesh: the ``mp``,
    ``sdp`` and ``ep`` groups of more than one rank (else None), this
    rank's coordinates as ``utils.convert.shard_state``'s keywords, and
    each parameter's ZeRO split dim by name. Which leaf is split over mp
    or over the experts, and how, is ``utils.convert``'s rule by name; a
    parameter the mesh splits that the rule does not name raises."""
    from ..utils.convert import _expert, _mp_spec

    hcg, zero = step.mesh, step._zero
    mp = hcg.get_model_parallel_group()
    sdp = zero.sdp if zero is not None and zero.sdp.nranks > 1 else None
    ep, dims = None, {}
    for name, p in step.model.named_parameters():
        dims[name] = zero.part(p) if zero is not None else None
        held_by = getattr(p, "mp_group", None)
        if held_by is not None and held_by.nranks > 1 and _mp_spec(name) is None:
            raise NotImplementedError(f"{name}: split over mp by a layout utils.convert does "
                                      "not name; a checkpoint cannot join it")
        experts = getattr(p, "expert_group", None)
        if experts is not None and experts.nranks > 1:
            if not _expert(name):
                raise NotImplementedError(f"{name}: split over an expert group by a layout "
                                          "utils.convert does not name")
            ep = experts
    groups = dict(mp=mp if mp.nranks > 1 else None, sdp=sdp, ep=ep)
    coords = dict(mp_rank=mp.rank, mp_degree=mp.nranks,
                  pp_rank=hcg.get_pipe_parallel_rank(),
                  pp_degree=hcg.get_pipe_parallel_world_size(),
                  sdp_rank=sdp.rank if sdp else 0, sdp_degree=sdp.nranks if sdp else 1,
                  ep_rank=ep.rank if ep else 0, ep_degree=ep.nranks if ep else 1)
    return groups, coords, dims


def _whole(name, t, groups, sdp_dim):
    """One leaf joined over the groups holding the rest of it: the experts,
    then the ZeRO blocks (``sdp_dim``), then the mp shards
    (``utils.convert.shard_state``'s cuts in reverse, by its ``_join``)."""
    from ..utils.convert import _expert, _join, _mp_spec
    from . import collective as C

    t = t.detach().contiguous()
    if groups["ep"] is not None and _expert(name):
        t = _join(C.all_gather([], t, group=groups["ep"]), 0, 1)
    if groups["sdp"] is not None and sdp_dim is not None:
        t = _join(C.all_gather([], t, group=groups["sdp"]), sdp_dim, 1)
    spec = _mp_spec(name)
    if groups["mp"] is not None and spec is not None:
        t = _join(C.all_gather([], t.contiguous(), group=groups["mp"]), *spec)
    return t.to("cpu", copy=True)


def _gather_step(step):
    """The whole host state of ``step`` (see :func:`gather_to_host`)."""
    local = step.state
    hcg = step.mesh
    if hcg is None:
        return tree_map(_host, local)
    groups, coords, dims = _layout(step)
    stage3 = step._zero is not None and step._zero.stage == 3
    out = {k: tree_map(_host, v) for k, v in local.items() if k not in ("params", "opt")}
    out["params"] = {n: _whole(n, t, groups, dims[n] if stage3 else None)
                     for n, t in local["params"].items()}
    out["opt"] = {k: {n: _whole(n, t, groups, dims[n]) for n, t in tree.items()}
                  for k, tree in local["opt"].items()}
    if coords["pp_degree"] > 1:
        out = _join_stages(out, hcg)
    return out


def _join_stages(out, hcg):
    """The pipeline stages' whole states joined by
    ``utils.convert.gather_state``: the stacked trunk's layers in stage
    order, every other leaf from the first stage that holds it."""
    import torch.distributed as dist

    from ..utils.convert import gather_state

    group = hcg.get_pipe_parallel_group()
    stages = [None] * group.nranks
    dist.all_gather_object(stages, out, group=group.process_group)

    def join(pick):
        return gather_state({(s, 0, 0): pick(st) for s, st in enumerate(stages)})

    joined = dict(stages[0])
    joined["params"] = join(lambda st: st["params"])
    joined["buffers"] = join(lambda st: st["buffers"])
    joined["opt"] = {k: join(lambda st, k=k: st["opt"][k]) for k in stages[0]["opt"]}
    return joined


def _place_step(step, state, label):
    """``state`` (a whole checkpoint) cut to ``step``'s pieces by
    ``utils.convert.shard_state``, checked against its leaves and loaded
    into it; returns the rank's state."""
    from ..utils.convert import shard_state

    local = step.state
    cut = dict(state)
    if step.mesh is not None:
        _, coords, dims = _layout(step)
        stage3 = step._zero is not None and step._zero.stage == 3

        def pieces(tree, path, sdp_dims):
            if not isinstance(tree, dict):
                return tree
            out = {}
            for n, leaf in tree.items():
                try:
                    out.update(shard_state({n: leaf}, sdp_dims=sdp_dims, **coords))
                except ValueError as e:
                    raise CheckpointConversionError(
                        f"{label}: cannot cut leaf {path}[{n!r}] for this mesh ({e}); did the "
                        "model config change?", leaf=f"{path}[{n!r}]") from None
            return out

        cut["params"] = pieces(state.get("params"), "['params']", dims if stage3 else None)
        cut["buffers"] = pieces(state.get("buffers"), "['buffers']", None)
        if isinstance(state.get("opt"), dict):
            cut["opt"] = {k: pieces(v, f"['opt'][{k!r}]", dims) for k, v in state["opt"].items()}
    _check(cut, local, label)
    step.load_state(cut)
    return cut


# -- validation ----------------------------------------------------------------
def _leaf_sig(leaf):
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, (np.ndarray, np.generic)):
        return tuple(leaf.shape), str(leaf.dtype)
    return (), type(leaf).__name__


def _check(state, target, label):
    """Raise :class:`CheckpointConversionError` at the first leaf (in key
    order) that ``target`` expects and ``state`` lacks, that ``state`` has
    and ``target`` does not, or whose shape or dtype differ."""
    flat_state, flat_target = _flat(state), _flat(target)
    missing = sorted(set(flat_target) - set(flat_state))
    if missing:
        raise CheckpointConversionError(
            f"{label}: cannot convert — target expects leaf {missing[0]!r} which the checkpoint "
            f"does not contain ({len(missing)} missing leaf/leaves total)", leaf=missing[0])
    extra = sorted(set(flat_state) - set(flat_target))
    if extra:
        raise CheckpointConversionError(
            f"{label}: cannot convert — checkpoint contains leaf {extra[0]!r} which the target "
            f"does not expect ({len(extra)} extra leaf/leaves total)", leaf=extra[0])
    for key in sorted(flat_target):
        want, got = _leaf_sig(flat_target[key]), _leaf_sig(flat_state[key])
        if want != got:
            raise CheckpointConversionError(
                f"{label}: cannot convert leaf {key!r} — checkpoint has {got[1]}{list(got[0])}, "
                f"target expects {want[1]}{list(want[0])}; resharding changes placement, never "
                "shapes/dtypes (did the model config change?)", leaf=key)


# -- conversion ----------------------------------------------------------------
def _unflat_like(structure, flat, prefix=""):
    if isinstance(structure, dict):
        return {k: _unflat_like(v, flat, f"{prefix}[{k!r}]") for k, v in structure.items()}
    if isinstance(structure, (list, tuple)):
        return type(structure)(_unflat_like(v, flat, f"{prefix}[{i}]")
                               for i, v in enumerate(structure))
    return flat[prefix]


def _place(leaf, like, device):
    """``leaf`` (host) as the target leaf ``like`` holds it, on ``device``."""
    if isinstance(like, np.ndarray):
        return leaf.numpy().copy() if isinstance(leaf, torch.Tensor) else np.array(leaf)
    if isinstance(like, torch.Tensor) or device is not None:
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        dev = device if device is not None else like.device
        return t.to(dev, copy=True)
    if isinstance(leaf, torch.Tensor) and like is not None and not isinstance(like, torch.Tensor):
        return leaf.item() if leaf.ndim == 0 else leaf
    return leaf


def _nbytes(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(getattr(leaf, "nbytes", 0))


def convert(state: Any, target: Optional[Any] = None, shardings: Optional[Any] = None,
            label: str = "checkpoint") -> Any:
    """Convert ``state`` (a loaded checkpoint, host) onto a new placement.

    ``target`` gives the expected structure, shapes and dtypes, and the
    placement: a tree (each leaf placed as the target's: a tensor onto its
    device, an array as numpy), or a ``TrainStep`` (the rank's pieces of
    the whole state cut for its mesh and loaded into it; the rank's state
    is returned). ``shardings``, a tree of devices matching ``target``,
    overrides a leaf's device. Validation happens before any placement: a
    structure or shape/dtype mismatch raises
    :class:`CheckpointConversionError` naming the first offending leaf."""
    t0 = time.perf_counter()
    if _is_step(target):
        out = _place_step(target, state, label)
        leaves = [leaf for _, leaf in flatten(out) if isinstance(leaf, torch.Tensor)]
        _account(label, len(leaves), sum(_nbytes(x) for x in leaves), t0)
        return out
    if target is None:
        target = state
    else:
        _check(state, target, label)
    flat_state, flat_target = _flat(state), _flat(target)
    flat_shardings = _flat(shardings) if shardings is not None else {}
    out, placed, nbytes = {}, 0, 0
    for key, like in flat_target.items():
        device = flat_shardings.get(key)
        leaf = flat_state[key]
        out[key] = _place(leaf, like, device)
        if isinstance(out[key], torch.Tensor) and (device is not None
                                                   or isinstance(like, torch.Tensor)):
            placed += 1
            nbytes += _nbytes(out[key])
    if placed:
        _account(label, placed, nbytes, t0)
    return _unflat_like(target, out)


def _account(label, leaves, nbytes, t0):
    _counter_inc("converter.reshards")
    _counter_inc("converter.bytes", nbytes)
    _runlog.emit("reshard", label=label, leaves=leaves, bytes=nbytes,
                 seconds=time.perf_counter() - t0)

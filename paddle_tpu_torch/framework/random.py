"""Random streams of the port (``paddle_tpu/framework/random.py``).

The reference threads JAX PRNG keys: a root key from ``seed`` with a host
counter folded in by ``split_key``, or, under ``rng_scope``, a traced key
with its own counter. Here a key is a 64-bit integer, ``fold_in`` mixes
integers into it (splitmix64), and a key becomes a ``torch.Generator`` on a
device only where a draw is made (:func:`generator`), seeded with the key.
So a stream is named by numbers, not by a generator's moving state: the
same key gives the same draws wherever and however often it is re-derived,
which is what lets a recompute draw exactly the masks its forward drew
(:func:`dropout_replay`).

The device side:

- :func:`seed`, :func:`get_rng_state`/:func:`set_rng_state` and
  :func:`split_key` over the global stream (a root key and a counter), as
  the reference's;
- :func:`rng_scope` installs a stream for the code inside it (the
  ``TrainStep``'s per-step stream); :func:`split_key` draws from the
  innermost one. Its key may be given lazily (a callable), resolved at the
  scope's first draw, so a step with no dropout never computes it;
- :func:`step_key` names the stream of a training step by ``(seed, step,
  micro-batch, rank)`` as the reference's ``TrainStep`` folds them;
  :func:`site_generator` gives the generator of one dropout site of a
  stacked trunk under the trunk's key, and :func:`dropout_generator` that
  of the stream named by ``(seed, step, micro-batch, layer, site[, rank])``
  through it.

Masks under model parallelism keep the reference's global-program
semantics (its models are one program under GSPMD, so a rank's mask is
the part its shard covers of the mask the one-device program draws):

- along the model axes (mp, sep, pp) a site draws the mask the one-process
  port draws for the same (seed, step, micro-batch, layer, site) key. A
  site whose activation is replicated over an axis (the residual stream
  and the embeddings after a model-parallel reduce) draws the whole mask
  on every rank of that axis; a site whose activation is sharded over an
  axis (the residual stream at sep > 1; the attention probabilities, whose
  heads are split over mp and, after ``seq_to_heads``, over sep) draws the
  global shape and keeps its block (:class:`Shard`, :func:`site_mask`). So
  a world at mp 2 x sep 2 or mp 2 x pp 2 draws the one process's masks.
  A sharded site draws mp or sep times the entries it keeps;
- along the data axes (dp, sdp, and the data axis that carries GPT-MoE's
  experts) each rank holds its own rows and draws only their masks, from
  a stream with its data rank folded in (:func:`step_key`).

The host side (``host_generator``) gives ``numpy`` generators for retry
jitter and trace ids, derived from the same seed and a tag.
"""
from __future__ import annotations

import contextlib
import zlib

import numpy as np
import torch

__all__ = ["seed", "seed_value", "host_generator", "get_rng_state", "set_rng_state",
           "split_key", "fold_in", "generator", "next_generator", "rng_scope", "step_key",
           "site_generator", "dropout_generator", "dropout_replay", "fold_scope", "Shard",
           "shard", "site_mask"]

_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_in(key: int, *data) -> int:
    """``key`` with each integer of ``data`` mixed in, in order (the
    counterpart of ``jax.random.fold_in``)."""
    for d in data:
        key = _mix(key ^ _mix(int(d) & _M64))
    return key


def _root_key(value: int) -> int:
    return fold_in(0x5EED, int(value))


class _Stream:
    """A key and the number of keys split from it. ``key`` may be a
    callable, resolved at the first split."""

    __slots__ = ("_key", "counter")

    def __init__(self, key, counter=0):
        self._key, self.counter = key, counter

    @property
    def key(self) -> int:
        if callable(self._key):
            self._key = int(self._key())
        return self._key

    def split(self) -> int:
        k = self.key
        self.counter += 1
        return fold_in(k, self.counter)


_SEED = [0]
_ROOT = [_Stream(_root_key(0))]
_SCOPES: list = []


def seed(value: int) -> int:
    """Reset the global stream to the root key of ``value`` (counter 0) and
    the host seed that :func:`host_generator` derives from."""
    _SEED[0] = int(value)
    _ROOT[0] = _Stream(_root_key(value))
    return value


def seed_value() -> int:
    return _SEED[0]


def host_generator(tag: str = "") -> np.random.Generator:
    """A ``numpy`` generator derived from the host seed and ``tag``: same
    seed and tag give the same stream; distinct tags, independent ones."""
    return np.random.default_rng(zlib.crc32(f"{_SEED[0]}/{tag}".encode()))


def get_rng_state():
    """The global stream as ``(root key, counter)``."""
    return (_ROOT[0].key, _ROOT[0].counter)


def set_rng_state(state):
    key, counter = state
    _ROOT[0] = _Stream(int(key), int(counter))


def _current() -> _Stream:
    return _SCOPES[-1] if _SCOPES else _ROOT[0]


def split_key() -> int:
    """A fresh key: the innermost :func:`rng_scope`'s, else the global
    stream's, with its counter advanced."""
    return _current().split()


def generator(key: int, device=None) -> torch.Generator:
    """The ``torch.Generator`` of ``key`` on ``device``: a fresh generator
    seeded with it, so the same key always gives the same draws."""
    return torch.Generator(device=torch.device(device or "cpu")).manual_seed(
        int(key) & ((1 << 63) - 1))


def next_generator(device=None) -> torch.Generator:
    """The generator of :func:`split_key`'s next key on ``device``."""
    return generator(split_key(), device)


@contextlib.contextmanager
def rng_scope(key):
    """Draw from the stream of ``key`` (an int, or a callable giving one at
    the first draw) inside the context."""
    _SCOPES.append(_Stream(key))
    try:
        yield _SCOPES[-1]
    finally:
        _SCOPES.pop()


@contextlib.contextmanager
def fold_scope(*data):
    """A scope whose key is the next key of the current stream with
    ``data`` folded in (e.g. a data-parallel rank), split lazily: the
    enclosing stream moves only if something inside draws."""
    parent = _current()
    with rng_scope(lambda: fold_in(parent.split(), *data)) as s:
        yield s


def step_key(seed: int, step: int, micro=None, rank=None) -> int:
    """The key of training step ``step``'s stream: the root key of ``seed``
    with the step folded in, then the micro-batch (with gradient merge) and
    the data-parallel rank (at dp > 1), where given, each after a tag of
    its own (so micro-batch 0 and rank 0 name different streams)."""
    key = fold_in(_root_key(seed), step)
    if micro is not None:
        key = fold_in(key, 1, micro)
    if rank is not None:
        key = fold_in(key, 2, rank)
    return key


def site_generator(key: int, layer: int, site: int, device=None) -> torch.Generator:
    """The generator of dropout site ``site`` of layer ``layer`` in a
    stacked trunk whose key is ``key``: the layer folded in, then the site,
    as the reference's trunk folds them."""
    return generator(fold_in(key, layer, site), device)


def dropout_generator(seed, step, layer, site, *, draw, micro=None, rank=None, device=None):
    """The generator of the stream ``(seed, step, micro-batch, layer, site[,
    rank])``: the trunk whose key is the ``draw``-th key split from training
    step ``step``'s stream (:func:`step_key`), at ``layer`` and ``site``
    (:func:`site_generator`). ``draw`` is the trunk's place among the
    model's draws in a step."""
    return site_generator(fold_in(step_key(seed, step, micro, rank), draw), layer, site, device)


class Shard:
    """A dropout site's generator and this rank's block of the site's global
    mask: ``blocks`` is ``((dim, index, count), ...)``, the rank holding
    block ``index`` of ``count`` equal blocks along ``dim``. Taken where a
    generator is (by :func:`site_mask` and so by every dropout of the port);
    the registry keys a call by its device and blocks, not by the object."""

    __slots__ = ("generator", "blocks")

    def __init__(self, generator, blocks):
        self.generator, self.blocks = generator, tuple(blocks)

    def _key(self):
        return ("shard", self.generator.device.type, self.blocks)

    def __eq__(self, other):
        return isinstance(other, Shard) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


def shard(generator, blocks):
    """``generator`` with this rank's ``blocks`` (``(dim, index, count)``
    triples); those of count 1 are left out, and with none left the
    generator itself is returned (None stays None)."""
    blocks = tuple((int(d), int(i), int(n)) for d, i, n in blocks if n > 1)
    return generator if generator is None or not blocks else Shard(generator, blocks)


def site_mask(shape, p, site, device=None):
    """The keep mask of ``shape`` at a dropout site: ``site`` a generator
    (the mask of ``shape``), or a :class:`Shard`, which draws the global
    shape (each blocked dim ``count`` times longer) from its generator and
    returns this rank's block of it. Every draw goes through
    :func:`~paddle_tpu_torch.nn.functional.common.dropout_mask`."""
    from ..nn.functional import common

    if not isinstance(site, Shard):
        return common.dropout_mask(shape, p, site, device)
    shape = list(shape)
    full = list(shape)
    for dim, _, n in site.blocks:
        full[dim] *= n
    keep = common.dropout_mask(full, p, site.generator, device)
    for dim, i, _ in site.blocks:
        keep = keep.narrow(dim, i * shape[dim], shape[dim])
    return keep


def dropout_replay():
    """The ``(forward, recompute)`` context pair that makes a recompute
    draw the keys its forward drew: the forward context notes the current
    stream and its counter on entry; the recompute context draws from that
    stream from that counter on and, on leaving (also when the checkpoint
    stops the recompute early), puts back the counter the stream had when
    the recompute began. A recompute does not move the stream: the backward
    recomputes blocks in reverse order, and whatever draws after it (the
    next step's dropouts outside a ``TrainStep``) goes on from where the
    forward left the stream."""
    mark = {}

    @contextlib.contextmanager
    def forward():
        stream = _current()
        mark["stream"], mark["start"] = stream, stream.counter
        yield

    @contextlib.contextmanager
    def recompute():
        stream = mark["stream"]
        before, stream.counter = stream.counter, mark["start"]
        _SCOPES.append(stream)
        try:
            yield
        finally:
            _SCOPES.pop()
            stream.counter = before

    return forward(), recompute()

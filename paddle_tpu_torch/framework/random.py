"""Host-side random streams of the port (``paddle_tpu/framework/random.py``'s
``host_generator``).

The port's device randomness takes explicit ``torch.Generator``s. This module
keeps only the host side: ``numpy`` generators for retry-backoff jitter and
trace ids, derived from one host seed (``seed``, 0 until set) and a tag, so
the same seed and tag replay the same stream and distinct tags (a rank
folded in) de-correlate.
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["seed", "seed_value", "host_generator"]

_SEED = [0]


def seed(value: int) -> int:
    """Set the host seed that :func:`host_generator` derives from."""
    _SEED[0] = int(value)
    return value


def seed_value() -> int:
    return _SEED[0]


def host_generator(tag: str = "") -> np.random.Generator:
    """A ``numpy`` generator derived from the host seed and ``tag``: same
    seed and tag give the same stream; distinct tags, independent ones."""
    return np.random.default_rng(zlib.crc32(f"{_SEED[0]}/{tag}".encode()))

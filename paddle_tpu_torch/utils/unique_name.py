"""Unique names (``paddle_tpu/utils/unique_name.py``; parity:
python/paddle/fluid/unique_name.py).

``generate(key)`` gives ``key_0``, ``key_1``, ... from the current
generator. ``guard(new_generator)`` installs a fresh generator inside its
scope, whose names carry ``new_generator`` as a prefix when it is a
string, and puts the old one back after: Paddle's contract. The
reference's ``guard`` is a no-op, so inside it names go on counting
(ROADMAP.md, "Faults in the reference").
"""
from __future__ import annotations

import contextlib
import itertools
from collections import defaultdict

__all__ = ["generate", "guard", "switch"]


class _Generator:
    def __init__(self, prefix=""):
        self.prefix = prefix
        self.counters = defaultdict(itertools.count)

    def __call__(self, key):
        return f"{self.prefix}{key}_{next(self.counters[key])}"


_CURRENT = [_Generator()]


def generate(key="tmp"):
    return _CURRENT[0](key)


def switch(new_generator=None):
    """Install ``new_generator`` (a fresh one by default) and return the
    old one."""
    old = _CURRENT[0]
    _CURRENT[0] = new_generator if isinstance(new_generator, _Generator) else \
        _Generator(new_generator if isinstance(new_generator, str) else "")
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)

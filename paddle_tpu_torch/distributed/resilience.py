"""Store hardening of the port: the store half of
``paddle_tpu/distributed/resilience.py``.

- **retry** decorates transient store/IO calls with bounded
  exponential-backoff retries. ``FLAGS_store_retry_jitter`` (default on)
  applies capped FULL jitter — uniform(0, cap) — seeded through
  ``framework.random.host_generator``, so N replicas retrying one dead
  store de-correlate while injected-fault tests still replay exactly.
- **RetryingStore** wraps a :class:`~.store.TCPStore`'s transient ops in
  ``retry``.

The reference's ``CheckpointManager``, ``watchdog`` and ``run_resilient``
are not ported (ROADMAP.md, Queue 1 item 13).
"""
from __future__ import annotations

import functools
import os
import time
from typing import Callable, Optional, Tuple

from ..framework.flags import flag

__all__ = ["retry", "RetryingStore"]


def retry(max_attempts: int = 3, base_delay: float = 0.05,
          max_delay: float = 2.0,
          retry_on: Tuple[type, ...] = (OSError, TimeoutError),
          jitter: Optional[bool] = None,
          deadline_s: Optional[float] = None):
    """Bounded exponential-backoff retry for transient store/IO failures.

    Attempt i's backoff cap is ``min(max_delay, base_delay * 2**i)``; after
    ``max_attempts`` failures the last exception propagates unchanged.

    ``deadline_s`` adds an overall wall-clock budget per CALL (measured
    from its first attempt): once the budget is spent no further attempt
    is made and the last exception propagates unchanged — the bound a
    caller's SLA actually needs, where ``max_attempts x max_delay`` only
    bounds the sleep time and says nothing about how long the attempts
    themselves block. A backoff sleep is clamped to the remaining budget,
    so the final retry fires just before the deadline instead of
    overshooting it. None (the default) keeps the attempts-only bound.

    ``jitter`` selects the sleep inside that cap (None defers to
    ``FLAGS_store_retry_jitter``, read per call so ``set_flags`` applies to
    already-decorated functions):

    - **full jitter** (the AWS discipline): sleep ``uniform(0, cap)``. N
      replicas hammering a dead store spread their retries across the whole
      window instead of thundering-herding on the same schedule. The stream
      comes from :func:`framework.random.host_generator` seeded on
      (the host seed, the decorated function's name, PADDLE_TRAINER_ID) —
      bitwise-replayable under chaos tests, de-correlated across ranks.
    - **off**: the pre-jitter deterministic sleeps (exactly ``cap``).
    """
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
    if deadline_s is not None and deadline_s <= 0:
        raise ValueError(f"deadline_s must be > 0, got {deadline_s}")

    def deco(fn: Callable):
        from ..framework import random as _random

        tag = (f"retry/{getattr(fn, '__qualname__', fn)}"
               f"/{os.environ.get('PADDLE_TRAINER_ID', '0')}")
        rng_box: list = []  # created lazily so a host seed set later applies

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.monotonic() if deadline_s is not None else 0.0
            for attempt in range(max_attempts):
                try:
                    return fn(*args, **kwargs)
                except retry_on:
                    if attempt == max_attempts - 1:
                        raise
                    cap = min(max_delay, base_delay * (2 ** attempt))
                    use = flag("FLAGS_store_retry_jitter") if jitter is None else jitter
                    if use:
                        if not rng_box:
                            rng_box.append(_random.host_generator(tag))
                        cap = float(rng_box[0].uniform(0.0, cap))
                    if deadline_s is not None:
                        remaining = deadline_s - (time.monotonic() - t0)
                        if remaining <= 0:
                            raise  # budget spent: last exception unchanged
                        cap = min(cap, remaining)
                    time.sleep(cap)

        return wrapper

    return deco


class RetryingStore:
    """Proxy wrapping a TCPStore's transient-failure-prone ops (set/get/
    add/wait/delete_key/num_keys) in the ``retry`` decorator; everything
    else passes through. ``jitter`` has :func:`retry` semantics (None
    defers to ``FLAGS_store_retry_jitter`` — full jitter by default, so a
    fleet of replicas retrying one dead store doesn't thundering-herd);
    ``deadline_s`` is the per-call wall-clock retry budget (None keeps the
    attempts-only bound)."""

    _RETRIED = ("set", "get", "add", "wait", "delete_key", "num_keys")

    def __init__(self, store, max_attempts: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, jitter: Optional[bool] = None,
                 deadline_s: Optional[float] = None):
        self._store = store
        deco = retry(max_attempts=max_attempts, base_delay=base_delay,
                     max_delay=max_delay, retry_on=(OSError,), jitter=jitter,
                     deadline_s=deadline_s)
        for name in self._RETRIED:
            setattr(self, name, deco(getattr(store, name)))

    def __getattr__(self, name):
        return getattr(self._store, name)

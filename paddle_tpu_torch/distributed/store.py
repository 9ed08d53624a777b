"""TCPStore of the port: key-value rendezvous with the API of
``paddle_tpu/distributed/store.py``, built on ``torch.distributed.TCPStore``.

The reference wraps its own native store (``csrc/tcp_store.cc``); PyTorch
ships one, so the port maps the reference's Python API onto it:

- ``get(key, timeout)``: torch's store has no per-call timeout on ``get``
  (a missing key blocks for the store's whole timeout), so the wrapper
  polls ``check`` until the key exists or the timeout passes, then raises
  ``TimeoutError`` as the reference does (polling also keeps c10d's
  timeout warnings off stderr);
- errors: c10d raises ``DistNetworkError`` / ``DistStoreError`` (both
  ``RuntimeError``s); the wrapper re-raises a lost connection as
  ``ConnectionError`` and any other store fault as ``OSError``, the types
  the reference's callers and :class:`~.resilience.RetryingStore` retry on;
- ``port=0`` on the master binds a free port, read back as ``.port``;
- ``close()`` drops this process's handle; on the master that stops the
  server. Clients in other processes see their next op fail with
  ``ConnectionError``, which their retry and liveness paths absorb.

Every op passes the ``chaos.store_op`` seam first (``FLAGS_chaos_store_*``),
and ops on one handle are serialised by a lock (a replica's heartbeat thread
shares its serving loop's handle).
"""
from __future__ import annotations

import datetime
import threading
import time
from typing import List, Optional

import torch.distributed as dist

from ..testing import chaos

__all__ = ["TCPStore", "BarrierTimeoutError"]


class BarrierTimeoutError(TimeoutError):
    """A diagnostic barrier expired; names exactly which ranks never
    arrived (``missing_ranks``) instead of a bare TimeoutError."""

    def __init__(self, name: str, missing_ranks: List[int], arrived: List[int],
                 timeout: float):
        self.name = name
        self.missing_ranks = list(missing_ranks)
        self.arrived = list(arrived)
        super().__init__(
            f"barrier {name!r} timed out after {timeout:g}s: "
            f"rank(s) {self.missing_ranks} never arrived "
            f"(arrived: {self.arrived})")


class TCPStore:
    """Client handle to a TCP key-value store; the master also hosts the
    server. Arguments as in the reference: ``host``, ``port`` (0 on the
    master: a free port, read back as ``.port``), ``is_master``,
    ``world_size`` (the participants of :meth:`barrier`), ``timeout``
    (seconds: connecting, and the default of every blocking op)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, is_master: bool = False,
                 world_size: int = 1, timeout: float = 300.0):
        self.world_size = int(world_size)
        self.timeout = float(timeout)
        self._lock = threading.Lock()
        try:
            self._store = dist.TCPStore(host, int(port), None, bool(is_master),
                                        datetime.timedelta(seconds=self.timeout),
                                        wait_for_workers=False)
        except dist.DistError as exc:
            raise ConnectionError(f"TCPStore: cannot connect to {host}:{port}: {exc}") from exc
        self.host, self.port = host, int(self._store.port)

    def _op(self, fn, *args):
        """One torch store call under the handle's lock, its c10d errors
        mapped to the reference's types."""
        store = self._store
        if store is None:
            raise OSError("TCPStore: handle is closed")
        try:
            with self._lock:
                return getattr(store, fn)(*args)
        except dist.DistNetworkError as exc:
            raise ConnectionError(f"TCPStore.{fn} failed: {exc}") from exc
        except dist.DistError as exc:
            raise OSError(f"TCPStore.{fn} failed: {exc}") from exc

    # ------------------------------------------------------------- basic ops
    def set(self, key: str, value) -> None:
        chaos.store_op("set", key)
        self._op("set", key, value.encode() if isinstance(value, str) else bytes(value))

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        """Blocks until the key exists (reference Store::get semantics), at
        most ``timeout`` seconds (the store's timeout when None), then raises
        ``TimeoutError``."""
        chaos.store_op("get", key)
        deadline = time.monotonic() + (self.timeout if timeout is None else float(timeout))
        pause = 5e-4
        while not self._op("check", [key]):
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"TCPStore.get({key!r}) timed out")
            time.sleep(min(pause, left))
            pause = min(2 * pause, 0.01)
        return self._op("get", key)

    def add(self, key: str, amount: int = 1) -> int:
        """Adds ``amount`` to the integer under ``key`` (0 when absent) and
        returns the new value."""
        chaos.store_op("add", key)
        return int(self._op("add", key, int(amount)))

    def delete_key(self, key: str) -> bool:
        return bool(self._op("delete_key", key))

    def num_keys(self) -> int:
        return int(self._op("num_keys"))

    def wait(self, keys: List[str], timeout: Optional[float] = None) -> None:
        for k in keys:
            self.get(k, timeout=timeout)

    # ------------------------------------------------------------ rendezvous
    def barrier(self, name: str = "default", timeout: Optional[float] = None) -> None:
        """All ``world_size`` participants block until everyone arrives."""
        arrived = self.add(f"__barrier__/{name}/count", 1)
        round_ = (arrived - 1) // self.world_size  # store survives reuse
        target = (round_ + 1) * self.world_size
        if arrived == target:
            self.set(f"__barrier__/{name}/release/{round_}", b"1")
        self.get(f"__barrier__/{name}/release/{round_}", timeout=timeout)

    def diagnostic_barrier(self, rank: int, name: str = "default",
                           timeout: Optional[float] = None,
                           poll: float = 0.05) -> None:
        """Barrier with per-rank arrival keys: a timeout raises
        BarrierTimeoutError naming exactly the ranks that never showed up.
        Arrival keys persist, so each synchronization point needs its own
        ``name``."""
        self.set(f"__dbarrier__/{name}/arrived/{rank}", b"1")
        tmo = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + tmo
        missing = set(range(self.world_size))
        while missing:
            for r in sorted(missing):
                try:
                    self.get(f"__dbarrier__/{name}/arrived/{r}", timeout=poll)
                    missing.discard(r)
                except TimeoutError:
                    pass
            if missing and time.monotonic() >= deadline:
                arrived = sorted(set(range(self.world_size)) - missing)
                raise BarrierTimeoutError(name, sorted(missing), arrived, tmo)

    def close(self) -> None:
        """Drop this handle (on the master: stop the server)."""
        with self._lock:
            self._store = None

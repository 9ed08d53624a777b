"""Elastic membership of the port (``paddle_tpu/distributed/elastic.py``):
TCPStore heartbeats + watch loop + rank rescaling.

Parity: fleet/elastic/manager.py — ElasticManager (init:131) keeps node
membership in etcd (heartbeat lease per node), its watch loop (:577)
detects join/leave and answers HOLD (pause) → RESTART with **rescaled
ranks** when membership settles inside the allowed np range.

etcd is replaced by the port's :class:`~.store.TCPStore` (over
``torch.distributed.TCPStore``). A node's identity is an atomic counter
ticket (``store.add``); liveness is a timestamp key refreshed by a daemon
thread; membership = tickets whose timestamp is fresh. The launcher-side
manager (launch/main.py) terminates local workers on any membership
change and respawns them with recomputed PADDLE_NNODES / node rank —
training resumes from the job's checkpoints
(:class:`~.resilience.CheckpointManager`).
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from ..testing import chaos

_PREFIX = "elastic"


class ElasticNode:
    """This host's membership handle: registers a node ticket and keeps its
    heartbeat fresh; can enumerate the alive set."""

    def __init__(self, store, heartbeat_interval: float = 0.5, timeout: float = 3.0):
        self.store = store
        self.interval = heartbeat_interval
        self.timeout = timeout
        self.node_id = store.add(f"{_PREFIX}/next_id", 1) - 1
        self._beat()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _beat(self):
        if chaos.heartbeat_frozen(self.node_id):
            return  # injected zombie: process lives, membership sees it die
        self.store.set(f"{_PREFIX}/hb/{self.node_id}", repr(time.time()))

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self._beat()
            except OSError:
                return  # store gone (job teardown)

    def leave(self):
        """Graceful departure: stop beating and mark the ticket dead."""
        self._stop.set()
        try:
            self.store.set(f"{_PREFIX}/hb/{self.node_id}", "0.0")
        except OSError:
            pass

    def alive_nodes(self) -> List[int]:
        """Ticket ids with a fresh heartbeat, ascending (their index in this
        list is the node's rescaled rank — reference manager re-sorts hosts
        the same way on RESTART)."""
        n = self.store.add(f"{_PREFIX}/next_id", 0)
        now = time.time()
        alive = []
        for i in range(n):
            try:
                ts = float(self.store.get(f"{_PREFIX}/hb/{i}", timeout=0.25))
            except (TimeoutError, ValueError, OSError):
                continue
            if now - ts < self.timeout:
                alive.append(i)
        return alive

    def wait_for(self, min_nodes: int, max_nodes: Optional[int] = None,
                 settle: float = 1.0, deadline: float = 60.0) -> List[int]:
        """Block until the alive set has >= min_nodes and is stable for
        ``settle`` seconds (the reference's HOLD debounce before RESTART)."""
        t0 = time.time()
        last, last_change = None, time.time()
        while True:
            cur = self.alive_nodes()
            if cur != last:
                last, last_change = cur, time.time()
            ok_count = len(cur) >= min_nodes and (max_nodes is None or len(cur) <= max_nodes)
            if ok_count and time.time() - last_change >= settle:
                return cur
            if time.time() - t0 > deadline:
                raise TimeoutError(
                    f"elastic: membership never reached [{min_nodes}, {max_nodes}] "
                    f"(alive={cur}) within {deadline}s")
            time.sleep(self.interval)


def parse_np_range(spec: str) -> Tuple[int, Optional[int]]:
    """'2' -> (2, 2); '1:4' -> (1, 4) (reference --np / PADDLE_ELASTIC_NP)."""
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        return int(lo), (int(hi) if hi else None)
    n = int(spec)
    return n, n

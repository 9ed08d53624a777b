"""Request router of the port's serving fleet (a copy of
``paddle_tpu/inference/router.py``): prefix-cache affinity first,
load-aware placement second.

A fleet of engine replicas each keeps its own :class:`~.prefix_cache.\
PrefixCache` of chunk-aligned prompt-prefix KV segments. Two requests that
share a system prompt therefore decode fastest on the SAME replica — the
second skips the shared chunks entirely. The router exploits that without
asking the replicas anything: it remembers, per chunk-aligned prefix chain,
which replica last prefilled it, keyed on the **exact token ids of the whole
chain** — the same byte keys :class:`~.prefix_cache.PrefixCache` uses, so a
router hit is (modulo that replica's LRU eviction) a prefix-cache hit.

Placement discipline:

1. **affinity** — walk the prompt's chunk chain longest-first; the first
   chain some healthy replica is known to hold wins, UNLESS that replica is
   overloaded relative to the fleet (its load exceeds the least-loaded
   replica's by more than ``affinity_load_slack`` in-flight requests —
   reusing a few cached chunks never justifies queueing behind a long line);
2. **least load** — otherwise the healthy replica with the fewest in-flight
   requests (ties break on replica id for determinism).

The router is host-side bookkeeping only: no device memory, no launches.
``forget_replica`` drops a dead replica's chains so affinity can't route
into a corpse; the requeue path then re-registers chains on the survivors
as they re-prefill.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["Router"]


class Router:
    """Prefix-affinity + load-aware placement over fleet replica ids.

    ``chunk`` is the prefix-chain granularity (the engines'
    ``prefill_chunk``); None disables affinity entirely (bucketed engines
    keep no reusable prefix segments), leaving pure least-load placement.
    """

    def __init__(self, chunk: Optional[int] = None,
                 affinity_load_slack: int = 2):
        self.chunk = int(chunk) if chunk else None
        self.affinity_load_slack = int(affinity_load_slack)
        self._chains: Dict[bytes, int] = {}   # chain byte key -> replica id
        self.affinity_hits = 0
        self.load_placements = 0

    # ------------------------------------------------------------------ keys
    def _key(self, prompt: np.ndarray, k: int) -> bytes:
        """Chain key of the first ``k`` chunks — the PrefixCache byte-key
        discipline: exact token ids of the whole prefix, no hashing."""
        return np.ascontiguousarray(prompt[: k * self.chunk], np.int32).tobytes()

    # ------------------------------------------------------------- placement
    def place(self, prompt, loads: Dict[int, int]) -> Tuple[int, str]:
        """Pick a replica for ``prompt`` among ``loads`` (healthy replica id
        -> in-flight request count). Returns ``(replica_id, reason)`` with
        reason ``"affinity"`` or ``"load"``; raises when ``loads`` is empty
        (no healthy replica — the fleet's no-capacity fault)."""
        if not loads:
            raise RuntimeError("router: no healthy replicas to place on")
        floor = min(loads.values())
        if self.chunk is not None:
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            # longest-first: the deepest cached chain wins (most reuse);
            # cap at n-1 tokens — the last prompt token always re-runs
            for k in range(max(0, (int(prompt.shape[0]) - 1) // self.chunk), 0, -1):
                rid = self._chains.get(self._key(prompt, k))
                if rid is None or rid not in loads:
                    continue
                if loads[rid] - floor > self.affinity_load_slack:
                    break  # holder is drowning; cheaper to re-prefill elsewhere
                self.affinity_hits += 1
                return rid, "affinity"
        rid = min(loads, key=lambda r: (loads[r], r))
        self.load_placements += 1
        return rid, "load"

    # ---------------------------------------------------------- registration
    def register(self, prompt, replica_id: int) -> int:
        """Record that ``replica_id`` is prefilling ``prompt``: every
        chunk-aligned prefix chain of it now routes there (last writer wins —
        the newest prefill is the one whose cache entries are freshest).
        Returns the number of chains registered."""
        if self.chunk is None:
            return 0
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n_chains = max(0, (int(prompt.shape[0]) - 1) // self.chunk)
        for k in range(1, n_chains + 1):
            self._chains[self._key(prompt, k)] = int(replica_id)
        return n_chains

    def forget_replica(self, replica_id: int) -> int:
        """Drop every chain owned by ``replica_id`` (replica death: its KV
        cache is gone, affinity to it would be worse than useless). Returns
        the number of chains dropped."""
        dead = [k for k, rid in self._chains.items() if rid == int(replica_id)]
        for k in dead:
            del self._chains[k]
        return len(dead)

    def stats(self) -> dict:
        return {
            "chains": len(self._chains),
            "affinity_hits": self.affinity_hits,
            "load_placements": self.load_placements,
        }

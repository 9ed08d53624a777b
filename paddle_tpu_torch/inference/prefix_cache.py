"""Prompt-prefix KV cache of the port (``paddle_tpu/inference/prefix_cache.py``):
chunk reuse with LRU eviction under a byte budget.

Many serving streams share prompt prefixes (system prompts, few-shot
headers). The cache stores the KV segments of CHUNK-aligned prompt
prefixes, one entry per ``[L, 1, H, C, dh]`` chunk, keyed on the token ids
of the WHOLE prefix up to that chunk's end (the KV at a position depends on
every earlier token, so the chain key is exact; byte keys mean no hash
collisions). A new request walks its longest cached chain and the engine
copies each matched chunk into its slot: no prefill compute for the shared
portion.

Entries are device tensors the engine extracted as copies (a view of the
cache would change under the next request in that slot). Eviction is LRU
over whole chunks, so the budget (``prefix_cache_mb``) bounds device memory.
A chunk is stored once per distinct prefix chain; a match refreshes recency.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["PrefixCache"]


def _seg_bytes(seg) -> Optional[int]:
    """Stored bytes of one segment, leaf by leaf: a tensor, or an int8 pack
    ``{"q", "s"}`` (payload plus scales). None for anything else (the
    caller falls back to its estimate)."""
    if isinstance(seg, dict):
        parts = [_seg_bytes(v) for v in seg.values()]
        return None if any(p is None for p in parts) else sum(parts)
    if isinstance(seg, torch.Tensor):
        return seg.numel() * seg.element_size()
    return None


class PrefixCache:
    """LRU cache of chunk-aligned prompt-prefix KV segments.

    ``chunk`` is the token granularity (the engine's ``prefill_chunk``);
    ``budget_bytes`` caps the summed bytes of the stored segments;
    ``entry_bytes`` is the caller's estimate of one chunk's K+V segment,
    used for a segment whose size cannot be read. Admission and eviction
    count each entry's stored bytes.
    """

    def __init__(self, chunk: int, budget_bytes: int, entry_bytes: int):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.chunk = int(chunk)
        self.budget_bytes = int(budget_bytes)
        self.entry_bytes = int(entry_bytes)
        self._entries: "OrderedDict[bytes, Tuple]" = OrderedDict()
        self._sizes: dict = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def key(self, prompt: np.ndarray, i: int) -> bytes:
        """Chain key of chunk ``i``: the token ids of the whole prefix up to
        and including that chunk (positions [0, (i+1)*chunk))."""
        return np.ascontiguousarray(prompt[: (i + 1) * self.chunk], np.int32).tobytes()

    def match(self, prompt: np.ndarray, max_tokens: int) -> List[Tuple]:
        """Longest chain of cached chunks covering at most ``max_tokens``
        prompt tokens (callers cap at n-1: the last prompt token always runs
        through the model, whose logits are not cached). Returns the entries
        ``[(seg_k, seg_v), ...]`` in position order and refreshes them."""
        prompt = np.asarray(prompt).reshape(-1)
        k = 0
        while (k + 1) * self.chunk <= max_tokens and self.key(prompt, k) in self._entries:
            k += 1
        out = []
        for i in range(k):
            key = self.key(prompt, i)
            self._entries.move_to_end(key)
            out.append(self._entries[key])
        if k:
            self.hits += 1
        else:
            self.misses += 1
        return out

    def has(self, key: bytes) -> bool:
        return key in self._entries

    def put(self, key: bytes, seg_k, seg_v) -> bool:
        """Insert one chunk segment under its chain key, evicting the least
        recently used entries until the budget holds. A segment larger than
        the whole budget is not stored. Returns whether the key is held."""
        sk, sv = _seg_bytes(seg_k), _seg_bytes(seg_v)
        size = self.entry_bytes if (sk is None or sv is None) else sk + sv
        if size > self.budget_bytes:
            return False
        if key in self._entries:
            self._entries.move_to_end(key)
            return True
        self._entries[key] = (seg_k, seg_v)
        self._sizes[key] = size
        self._bytes += size
        while self._bytes > self.budget_bytes:
            old, _ = self._entries.popitem(last=False)
            self._bytes -= self._sizes.pop(old)
            self.evictions += 1
        return key in self._entries

    def bytes_used(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "bytes_used": self.bytes_used(),
            "budget_bytes": self.budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }

"""Static KV-cache decode engine of the port (``paddle_tpu/inference/engine.py``).

A preallocated ``[L, B, H, S, dh]`` cache on the device, updated in place:

- **prefill**: bucketed. A prompt pads to the smallest bucket that fits, runs
  through the model against a scratch cache of the bucket's length, and the
  scratch rows are copied into the slot's lanes of the big cache; the first
  token is chosen from the last prompt row's logits.
- **decode step**: advances every occupied slot one token with per-slot
  positions, in one forward over all B slots; a slot that hits eos or its
  token limit deactivates.

The reference's other serving knobs (``int8``, ``kv_dtype``, ``fuse > 1``,
``prefill_chunk``, ``prefix_cache_mb``, ``draft``) are not ported yet and
raise ``NotImplementedError``. Prefill attends in plain PyTorch as the
reference does; routing it through the flash kernel is queued in
``ROADMAP.md``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.gpt import (
    _cache_forward,
    _kv_zeros,
    _kvc_copy,
    _position_generator,
    _select_token,
    _select_token_rows,
    _slot_decode_forward,
)
from ..observability.metrics import counter_inc, gauge_set, observe

__all__ = ["DecodeEngine", "default_buckets"]


def default_buckets(max_seq: int, start: int = 16) -> Tuple[int, ...]:
    """Power-of-two prompt-padding buckets up to ``max_seq``."""
    out: List[int] = []
    b = start
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(sorted(set(out)))


def _not_ported(knob: str) -> NotImplementedError:
    return NotImplementedError(
        f"DecodeEngine({knob}) is not ported to paddle_tpu_torch yet; it is queued in "
        "ROADMAP.md (Queue 1, serving knobs)")


class _PrefillJob:
    """Host-side state of one prompt admission."""

    __slots__ = ("slot", "prompt", "n", "eos", "limit", "seed", "done", "first", "more")

    def __init__(self, slot, prompt, n, eos, limit, seed):
        self.slot = slot
        self.prompt = prompt
        self.n = n
        self.eos = eos
        self.limit = limit
        self.seed = seed
        self.done = False
        self.first: Optional[int] = None
        self.more: Optional[bool] = None


class DecodeEngine:
    """Slot-based autoregressive decode over a static KV cache.

    ``model`` is a :class:`~paddle_tpu_torch.models.gpt.GPTForPretraining`;
    the engine serves on the model's device. ``max_batch_slots`` fixes the
    decode batch width B: each slot holds one in-flight request, and requests
    are admitted into free slots mid-stream (continuous batching).
    Per-request randomness comes from the request's ``seed`` and the
    position, so a request's tokens never depend on its slot or neighbours.
    """

    def __init__(self, model, max_batch_slots: int = 4, max_seq_len: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 int8: bool = False, fuse: int = 1, prefill_chunk: Optional[int] = None,
                 prefix_cache_mb: float = 0.0, draft=None, kv_dtype: Optional[str] = None):
        for knob, unported in (("int8=True", int8), (f"fuse={fuse}", int(fuse) != 1),
                               ("prefill_chunk", prefill_chunk),
                               ("prefix_cache_mb", prefix_cache_mb and float(prefix_cache_mb) > 0),
                               ("draft", draft is not None), ("kv_dtype", kv_dtype is not None)):
            if unported:
                raise _not_ported(knob)
        cfg = model.gpt.cfg
        S = int(max_seq_len) if max_seq_len is not None else int(cfg.max_seq_len)
        if S > cfg.max_seq_len:
            raise ValueError(f"max_seq_len {S} exceeds the model's positional table {cfg.max_seq_len}")
        self.cfg = cfg
        self.max_seq_len = S
        self.max_batch_slots = B = int(max_batch_slots)
        self.buckets = tuple(sorted(int(b) for b in prefill_buckets)) if prefill_buckets else default_buckets(S)
        if any(b > S for b in self.buckets):
            raise ValueError(f"prefill bucket larger than max_seq_len {S}: {self.buckets}")
        self._sample = (bool(do_sample), float(temperature), int(top_k), float(top_p))
        self._params = model._decode_params()
        wte = self._params[1]
        self.device = wte.device
        L, H = cfg.num_layers, cfg.num_heads
        self._dh = cfg.hidden_size // H
        self._ck = _kv_zeros((L, B, H, S, self._dh), wte.dtype, self.device)
        self._cv = _kv_zeros((L, B, H, S, self._dh), wte.dtype, self.device)
        # slot state lives on the host: every step needs it there anyway
        self._pos = np.zeros((B,), np.int64)
        self._tok = np.zeros((B,), np.int64)
        self._active = np.zeros((B,), bool)
        self._occupied = np.zeros((B,), bool)
        self._eos = np.full((B,), -1, np.int64)
        self._limit = np.zeros((B,), np.int64)
        self._seed = np.zeros((B,), np.int64)
        gauge_set("infer.kv_bytes_per_slot", self.kv_bytes_per_slot())

    # ------------------------------------------------------------ slot API
    def bucket_for(self, prompt_len: int) -> int:
        """The padded prefill length for a prompt: its bucket."""
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(f"prompt of {prompt_len} tokens exceeds the largest "
                         f"prefill bucket {self.buckets[-1]}")

    def free_slots(self) -> List[int]:
        return [i for i in range(self.max_batch_slots) if not self._occupied[i]]

    # ----------------------------------------------------------- prefill
    def begin_prefill(self, prompt, slot: int, max_new_tokens: int,
                      eos_token_id: Optional[int] = None, seed: int = 0) -> _PrefillJob:
        """Claim ``slot`` for one prompt; drive the job with :meth:`prefill_step`."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        n = int(prompt.shape[0])
        if n < 1:
            raise ValueError("empty prompt")
        if self._occupied[slot]:
            raise ValueError(f"slot {slot} is occupied; free it first")
        if n + int(max_new_tokens) > self.max_seq_len:
            raise ValueError(f"prompt {n} + max_new_tokens {max_new_tokens} "
                             f"exceeds max_seq_len {self.max_seq_len}")
        self.bucket_for(n)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        job = _PrefillJob(slot, prompt, n, eos, n + int(max_new_tokens), int(seed))
        self._occupied[slot] = True
        self._eos[slot] = eos
        self._limit[slot] = job.limit
        self._seed[slot] = job.seed
        return job

    @torch.no_grad()
    def prefill_step(self, job: _PrefillJob) -> bool:
        """Run the prefill of ``job`` (one bucket-padded forward). Returns True;
        ``job.first``/``job.more`` are then set and the slot decodes on the
        next decode step."""
        if job.done:
            return True
        n, slot = job.n, job.slot
        P = self.bucket_for(n)
        ids = torch.zeros((1, P), dtype=torch.long)
        ids[0, :n] = torch.from_numpy(job.prompt)
        ids = ids.to(self.device)
        params, wte, wpe, fnw, fnb = self._params
        L, H = self.cfg.num_layers, self.cfg.num_heads
        sk = _kv_zeros((L, 1, H, P, self._dh), wte.dtype, self.device)
        sv = _kv_zeros((L, 1, H, P, self._dh), wte.dtype, self.device)
        logits = _cache_forward(params, wte, wpe, fnw, fnb, ids, sk, sv, 0, num_heads=H)
        _kvc_copy(self._ck, sk, (0, slot, 0, 0, 0))
        _kvc_copy(self._cv, sv, (0, slot, 0, 0, 0))
        do_sample, temperature, top_k, top_p = self._sample
        gen = _position_generator(job.seed, n - 1, self.device) if do_sample else None
        first = int(_select_token(logits[:, n - 1].float(), gen, *self._sample)[0])
        more = not (job.eos >= 0 and first == job.eos) and n + 1 < job.limit
        self._pos[slot] = n
        self._tok[slot] = first
        self._active[slot] = more
        job.first, job.more, job.done = first, more, True
        counter_inc("infer.prefill_dispatches")
        counter_inc("infer.tokens")
        return True

    def prefill(self, prompt, slot: int, max_new_tokens: int, eos_token_id: Optional[int] = None,
                seed: int = 0) -> Tuple[int, bool]:
        """Admit one prompt into ``slot`` synchronously. Returns
        ``(first_token, more)``; ``more`` False means the request finished at
        its first token (eos or max_new_tokens == 1)."""
        job = self.begin_prefill(prompt, slot, max_new_tokens, eos_token_id=eos_token_id, seed=seed)
        self.prefill_step(job)
        return job.first, job.more

    # ------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, fuse: Optional[int] = None):
        """Advance every active slot one token in one forward. Returns
        ``(tokens[B], emitted[B], active[B])`` as numpy arrays."""
        if fuse is not None and int(fuse) != 1:
            raise _not_ported(f"fuse={fuse}")
        emitted = self._active.copy()
        params, wte, wpe, fnw, fnb = self._params
        dev = self.device
        tok = torch.from_numpy(self._tok).to(dev)
        pos = torch.from_numpy(self._pos).to(dev)
        active = torch.from_numpy(self._active).to(dev)
        logits = _slot_decode_forward(params, wte, wpe, fnw, fnb, tok, self._ck, self._cv, pos,
                                      num_heads=self.cfg.num_heads, active=active)
        gens = [_position_generator(self._seed[i], self._pos[i], dev) if self._active[i] else None
                for i in range(self.max_batch_slots)] if self._sample[0] else None
        nxt = _select_token_rows(logits.float(), gens, *self._sample).cpu().numpy()
        nxt = np.where(self._active, nxt, self._tok)  # free slots hold
        hit_eos = (self._eos >= 0) & (nxt == self._eos)
        self._pos = self._pos + self._active
        self._active = self._active & ~hit_eos & (self._pos + 1 < self._limit)
        self._tok = nxt
        counter_inc("infer.decode_dispatches")
        counter_inc("infer.tokens", int(emitted.sum()))
        observe("infer.tokens_per_decode_dispatch", float(emitted.sum()))
        return self._tok.copy(), emitted, self._active.copy()

    def free_slot(self, slot: int) -> None:
        """Release a slot for the next admission (cancels it if still live)."""
        self._active[slot] = False
        self._occupied[slot] = False

    def reset(self) -> None:
        """Drop every in-flight request and zero the slot state (the cache
        keeps its buffers: stale K/V is always overwritten before it can be
        attended)."""
        self._pos[:] = 0
        self._tok[:] = 0
        self._active[:] = False
        self._occupied[:] = False
        self._eos[:] = -1
        self._limit[:] = 0
        self._seed[:] = 0

    # ------------------------------------------------------------- helpers
    def generate(self, ids, max_new_tokens: int = 32, eos_token_id: Optional[int] = None,
                 seed: int = 0) -> np.ndarray:
        """Batch generate through the slot machinery: each row takes one
        slot, prefill once per row, then decode steps until every row
        finishes. Returns ``[b, s0 + max_new_tokens]`` int64 (rows that hit
        eos pad with it), the contract of ``GPTForPretraining.generate``."""
        ids = np.asarray(ids, np.int64)
        if ids.ndim == 1:
            ids = ids[None]
        b, s0 = ids.shape
        if b > self.max_batch_slots:
            raise ValueError(f"batch {b} exceeds max_batch_slots {self.max_batch_slots}")
        self.reset()
        rows = [[] for _ in range(b)]
        for i in range(b):
            tok, _more = self.prefill(ids[i], slot=i, max_new_tokens=max_new_tokens,
                                      eos_token_id=eos_token_id, seed=seed)
            rows[i].append(tok)
        while self._active.any():
            toks, emitted, _ = self.decode_step()
            for i in range(b):
                if emitted[i]:
                    rows[i].append(int(toks[i]))
        for i in range(b):
            self.free_slot(i)
        out = np.zeros((b, s0 + int(max_new_tokens)), np.int64)
        out[:, :s0] = ids
        for i, r in enumerate(rows):
            pad = r[-1] if eos_token_id is None else int(eos_token_id)
            r = r + [pad] * (int(max_new_tokens) - len(r))
            out[i, s0:] = r[:int(max_new_tokens)]
        return out

    def cache_bytes(self) -> int:
        """Device bytes held by the preallocated K/V cache."""
        return sum(t.numel() * t.element_size() for t in (self._ck, self._cv))

    def kv_bytes_per_slot(self) -> int:
        """Per-request device cost of admission (the
        ``infer.kv_bytes_per_slot`` gauge)."""
        return self.cache_bytes() // self.max_batch_slots

"""Static KV-cache decode engine of the port (``paddle_tpu/inference/engine.py``).

A preallocated ``[L, B, H, S, dh]`` cache on the device, updated in place
(the reference's ``donate=True``), with the slot state (positions, last
tokens, active flags, eos and limits) on the device beside it:

- **prefill**: bucketed (a prompt pads to the smallest bucket that fits,
  runs against a scratch cache of the bucket's length, whose rows are copied
  into the slot) or **chunked** (``prefill_chunk=C``: the prompt runs as
  C-token chunks directly against the big cache, one chunk per
  :meth:`DecodeEngine.prefill_step`, so a long admission interleaves with
  decode); the first token comes from the last prompt row's logits;
- **decode step**: advances every occupied slot one token in one forward
  over all B slots; ``fuse=D`` runs D such iterations with the slot state
  kept on the device and the eos/limit stops applied there, and reads the
  ``[D, B]`` tokens back to the host once per D tokens;
- **prefix reuse** (``prefix_cache_mb``, with ``prefill_chunk``): an LRU
  cache of chunk-aligned prompt-prefix KV segments
  (:mod:`.prefix_cache`); a request whose prefix matches copies the cached
  chunks into its slot instead of prefilling them;
- **int8**: ``int8=True`` stores the trunk's matmul weights as int8 with
  per-layer x per-output-channel scales (:mod:`..quantization`), each
  layer's dequantized right before its matmuls; ``kv_dtype="int8"`` stores
  the cache as int8 payload plus per-row f32 scales;
- **speculative decoding** (``draft``, ``spec_k``): a small draft model
  proposes ``spec_k`` tokens per slot, ONE (spec_k+1)-wide target forward
  verifies them, and the accept-longest-prefix ledger runs on the device.

Prefill and decode attend in plain PyTorch, as the reference's jnp does
(no Pallas kernel on this path); routing prefill through the flash kernel
is queued in ``ROADMAP.md``. An engine counts its first dispatch of each
program signature (``prefill/P64``, ``decode_x8``, ...) in
``infer.compiles``, as the reference counts each compile: the serving
fleet's heartbeat exempts the tick that paid that cold build. Not ported:
``donate=False`` (the port always
updates in place), the on-disk AOT cache (``FLAGS_compile_cache_dir``) and
``explain()``; each raises, citing ``ROADMAP.md``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..framework.flags import flag
from ..models.gpt import (
    GPTBlockStack,
    GPTConfig,
    GPTForPretraining,
    _cache_forward,
    _chunk_prefill_forward,
    _filtered_logits,
    _kv_bytes,
    _kv_zeros,
    _kvc_copy,
    _kvc_slice,
    _position_generator,
    _sample,
    _select_token,
    _select_token_rows,
    _slot_decode_forward,
    _slot_window_forward,
)
from ..observability.metrics import counter_inc, gauge_set, observe
from ..quantization import quant_abs_max
from .prefix_cache import PrefixCache

__all__ = ["DecodeEngine", "default_buckets"]

# the trunk weights int8=True quantizes, as in the reference
_QUANTIZED = ("qkv_w", "out_w", "ffn1_w", "ffn2_w")


def default_buckets(max_seq: int, start: int = 16) -> Tuple[int, ...]:
    """Power-of-two prompt-padding buckets up to ``max_seq``."""
    out: List[int] = []
    b = start
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(sorted(set(out)))


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch; it is queued in ROADMAP.md "
        "(Queue 1, item 4: the serving stack)")


def _pack_stack(order, params):
    """int8 weight packs ``{"q", "s"}`` for the quantized trunk weights:
    abs_max scales per layer and output channel over the ``[L, in, out]``
    stack (``channel_axis=(0, 2)``)."""
    packed = []
    for name, w in zip(order, params):
        if name in _QUANTIZED:
            q, s = quant_abs_max(w, channel_axis=(0, 2))
            packed.append({"q": torch.from_numpy(q).to(w.device),
                           "s": torch.from_numpy(s).to(w.device)})
        else:
            packed.append(w)
    return tuple(packed)


class _PrefillJob:
    """Host-side progress of one prompt admission: its slot, how far the
    cache is written (``next_pos``), how many rows the prefix cache
    supplied, and, once the last chunk ran, the first token."""

    __slots__ = ("slot", "prompt", "n", "eos", "limit", "seed",
                 "next_pos", "reused_tokens", "done", "first", "more")

    def __init__(self, slot, prompt, n, eos, limit, seed):
        self.slot = slot
        self.prompt = prompt
        self.n = n
        self.eos = eos
        self.limit = limit
        self.seed = seed
        self.next_pos = 0          # cache rows [0, next_pos) are written
        self.reused_tokens = 0     # rows supplied by the prefix cache
        self.done = False
        self.first: Optional[int] = None
        self.more: Optional[bool] = None


class DecodeEngine:
    """Slot-based autoregressive decode over a static KV cache.

    ``model`` is a :class:`~paddle_tpu_torch.models.gpt.GPTForPretraining`
    with the stacked trunk; the engine serves on the model's device.
    ``max_batch_slots`` fixes the decode batch width B: each slot holds one
    in-flight request, admitted into a free slot mid-stream (continuous
    batching). Knobs, as in the reference: ``fuse=D`` (decode iterations per
    :meth:`decode_step`), ``prefill_chunk=C`` (chunked prefill),
    ``prefix_cache_mb=M`` (prefix reuse under an M-MiB budget; needs
    ``prefill_chunk``), ``int8=True`` (int8 trunk weights),
    ``kv_dtype="int8"`` (int8 cache with per-row scales), and ``draft=``
    (a ``GPTConfig``, its dict, or a model) with ``spec_k`` and
    ``draft_seed`` (speculative decoding; needs ``fuse=1``; a config is
    built with ``GPTForPretraining(cfg, seed=draft_seed)`` on the engine's
    device).

    Per-request randomness comes from the request's ``seed`` and the
    position (and, in speculative sampling, the draw's purpose), so a
    request's tokens never depend on its slot, its neighbours or the fuse
    depth.
    """

    def __init__(self, model, max_batch_slots: int = 4, max_seq_len: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 int8: bool = False, donate: bool = True, fuse: int = 1,
                 prefill_chunk: Optional[int] = None, prefix_cache_mb: float = 0.0,
                 draft=None, spec_k: int = 4, draft_seed: int = 0,
                 kv_dtype: Optional[str] = None):
        if not donate:
            raise _not_ported("DecodeEngine(donate=False) (the port always updates its "
                              "cache in place)")
        if flag("FLAGS_compile_cache_dir"):
            raise _not_ported("the on-disk AOT cache of serving programs (FLAGS_compile_cache_dir)")
        if not isinstance(model.gpt.layers, GPTBlockStack):
            raise NotImplementedError("DecodeEngine requires the stacked trunk (GPTConfig(stacked=True))")
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
        self.int8 = bool(int8)
        self.fuse = int(fuse)
        if self.fuse < 1:
            raise ValueError(f"fuse depth must be >= 1, got {fuse}")
        self._chunk = int(prefill_chunk) if prefill_chunk else None
        if self._chunk is not None and not (1 <= self._chunk <= S):
            raise ValueError(f"prefill_chunk {prefill_chunk} must be in [1, max_seq_len={S}]")
        self._kv_dtype = None if kv_dtype is None else str(kv_dtype)
        if self._kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")

        stack, wte, wpe, fnw, fnb = model._decode_params()
        self.device = dev = wte.device
        dt = wte.dtype

        # --- draft model for speculative decoding ------------------------
        draft_model = None
        if draft is not None:
            if int(spec_k) < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if self.fuse != 1:
                raise ValueError("draft= requires fuse=1 (a speculative dispatch "
                                 "already emits up to spec_k+1 tokens)")
            if isinstance(draft, dict):
                draft = GPTConfig(**draft)
            if isinstance(draft, GPTConfig):
                # a seeded generator: every engine with the same draft_seed
                # holds the same draft weights
                draft_model = GPTForPretraining(draft, device=dev, seed=int(draft_seed)).eval()
            else:
                draft_model = draft
            if not isinstance(draft_model.gpt.layers, GPTBlockStack):
                raise NotImplementedError("draft model requires the stacked trunk")
            dcfg = draft_model.gpt.cfg
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(f"draft vocab {dcfg.vocab_size} != target vocab {cfg.vocab_size}")
            if dcfg.max_seq_len < S:
                raise ValueError(f"draft positional table {dcfg.max_seq_len} < max_seq_len {S}")
        self.draft_cfg = draft_model.gpt.cfg if draft_model is not None else None
        self.spec_k = int(spec_k) if draft is not None else 0
        self.draft_seed = int(draft_seed)

        if self.int8:
            stack = _pack_stack(GPTBlockStack._order, stack)
        self._params = (stack, wte, wpe, fnw, fnb)
        self._dparams = None
        if draft_model is not None:
            dstack, dwte, dwpe, dfnw, dfnb = draft_model._decode_params()
            if dwte.device != dev:
                raise ValueError(f"draft model is on {dwte.device}, the engine on {dev}")
            if self.int8:
                dstack = _pack_stack(GPTBlockStack._order, dstack)
            self._dparams = (dstack, dwte, dwpe, dfnw, dfnb)

        L, H = cfg.num_layers, cfg.num_heads
        self._dh = dh = cfg.hidden_size // H
        # spec_k slack rows past max_seq_len: a (spec_k+1)-wide window
        # written near the sequence limit stays inside the cache (the
        # reference's dynamic_update_slice would clamp back over committed
        # rows); no emitted token attends a slack row
        cache_S = S + self.spec_k
        self._ck = _kv_zeros((L, B, H, cache_S, dh), dt, dev, self._kv_dtype)
        self._cv = _kv_zeros((L, B, H, cache_S, dh), dt, dev, self._kv_dtype)
        self._dck = self._dcv = None
        if draft_model is not None:
            dcfg = self.draft_cfg
            dshape = (dcfg.num_layers, B, dcfg.num_heads, cache_S, dcfg.hidden_size // dcfg.num_heads)
            # the draft cache is small: it stays in the compute dtype
            self._dck = _kv_zeros(dshape, self._dparams[1].dtype, dev)
            self._dcv = _kv_zeros(dshape, self._dparams[1].dtype, dev)

        self.prefix_cache = None
        if prefix_cache_mb and float(prefix_cache_mb) > 0:
            if self._chunk is None:
                raise ValueError("prefix_cache_mb requires prefill_chunk= (prefix "
                                 "entries are chunk-aligned KV segments)")
            if self._kv_dtype == "int8":
                # int8 payload + one f32 scale per (layer, head, row)
                entry_bytes = 2 * L * H * self._chunk * (dh + 4)
            else:
                entry_bytes = 2 * L * H * self._chunk * dh * wte.element_size()
            self.prefix_cache = PrefixCache(self._chunk, int(float(prefix_cache_mb) * (1 << 20)),
                                            entry_bytes)

        # slot state on the device (decode reads and writes it there); the
        # host mirrors are kept from what each dispatch reads back
        self._pos = torch.zeros((B,), dtype=torch.long, device=dev)
        self._tok = torch.zeros((B,), dtype=torch.long, device=dev)
        self._active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._eos = torch.full((B,), -1, dtype=torch.long, device=dev)
        self._limit = torch.zeros((B,), dtype=torch.long, device=dev)
        self._pos_np = np.zeros((B,), np.int64)
        self._active_np = np.zeros((B,), bool)
        self._occupied = np.zeros((B,), bool)
        self._seed = np.zeros((B,), np.int64)
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._signatures = set()  # the program signatures dispatched so far
        gauge_set("infer.kv_bytes_per_slot", self.kv_bytes_per_slot())

    def _note_dispatch(self, signature: str) -> None:
        """Count this engine's first dispatch of ``signature`` (a program
        and the shape that varies, e.g. ``prefill/P64``) in
        ``infer.compiles``, once per signature as the reference's
        ``_dispatch`` counts a compile: the first use is where the port pays
        its cold build, and the fleet's heartbeat exempts the tick that did."""
        if signature not in self._signatures:
            self._signatures.add(signature)
            counter_inc("infer.compiles")

    # ------------------------------------------------------------ slot API
    def bucket_for(self, prompt_len: int) -> int:
        """The padded prefill length of a prompt: its bucket, or in chunked
        mode the chunk-rounded length (at most max_seq_len)."""
        if self._chunk is not None:
            if prompt_len > self.max_seq_len:
                raise ValueError(f"prompt of {prompt_len} tokens exceeds "
                                 f"max_seq_len {self.max_seq_len}")
            return min(self.max_seq_len, -(-prompt_len // self._chunk) * self._chunk)
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(f"prompt of {prompt_len} tokens exceeds the largest "
                         f"prefill bucket {self.buckets[-1]}")

    def free_slots(self) -> List[int]:
        return [i for i in range(self.max_batch_slots) if not self._occupied[i]]

    def _ids(self, tokens, width):
        """``tokens`` zero-padded to ``[1, width]`` on the device."""
        ids = torch.zeros((1, width), dtype=torch.long)
        ids[0, :len(tokens)] = torch.from_numpy(np.asarray(tokens, np.int64))
        return ids.to(self.device)

    # ----------------------------------------------------------- prefill
    @torch.no_grad()
    def begin_prefill(self, prompt, slot: int, max_new_tokens: int,
                      eos_token_id: Optional[int] = None, seed: int = 0) -> _PrefillJob:
        """Claim ``slot`` for one prompt and copy any prefix-cache hits into
        it (no model compute). Drive the returned job with
        :meth:`prefill_step`."""
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
        if self.prefix_cache is not None:
            # reuse at most n-1 tokens: the prompt's last token runs through
            # the model (its logits choose the first generated token)
            C = self._chunk
            matched = self.prefix_cache.match(prompt, max_tokens=n - 1)
            for i, (seg_k, seg_v) in enumerate(matched):
                self._note_dispatch("prefix_insert")
                _kvc_copy(self._ck, seg_k, (0, slot, 0, i * C, 0))
                _kvc_copy(self._cv, seg_v, (0, slot, 0, i * C, 0))
                counter_inc("infer.prefix_insert_dispatches")
            if matched and self._dparams is not None:
                # the prefix cache holds the target's KV only: the draft
                # prefills the matched chunks itself, in order
                for i in range(len(matched)):
                    self._note_dispatch("draft_chunk")
                    self._draft_chunk(prompt[i * C:(i + 1) * C], slot, i * C)
            job.next_pos = job.reused_tokens = len(matched) * C
            counter_inc("serving.prefix_hits" if matched else "serving.prefix_misses")
            counter_inc("serving.prefix_tokens_reused", job.reused_tokens)
            gauge_set("serving.prefix_cache_bytes", self.prefix_cache.bytes_used())
        return job

    def _draft_chunk(self, tokens, slot, start):
        """The draft model's prefill of one C-token window of ``slot``."""
        _chunk_prefill_forward(*self._dparams, self._ids(tokens, self._chunk), self._dck,
                               self._dcv, slot, start, num_heads=self.draft_cfg.num_heads)

    @torch.no_grad()
    def prefill_step(self, job: _PrefillJob) -> bool:
        """Run ONE prefill step of ``job``: the whole bucket in bucketed
        mode, one C-token chunk in chunked mode. Returns True when the prompt
        is prefilled (``job.first``/``job.more`` are then set and the slot
        decodes on the next decode step)."""
        if job.done:
            return True
        n, slot, H = job.n, job.slot, self.cfg.num_heads
        do_sample, temperature, top_k, top_p = self._sample
        if self._chunk is None:
            P = self.bucket_for(n)
            self._note_dispatch(f"prefill/P{P}")
            ids = self._ids(job.prompt, P)
            wte = self._params[1]
            L = self.cfg.num_layers
            sk = _kv_zeros((L, 1, H, P, self._dh), wte.dtype, self.device, self._kv_dtype)
            sv = _kv_zeros((L, 1, H, P, self._dh), wte.dtype, self.device, self._kv_dtype)
            logits = _cache_forward(*self._params, ids, sk, sv, 0, num_heads=H)[:, n - 1]
            _kvc_copy(self._ck, sk, (0, slot, 0, 0, 0))
            _kvc_copy(self._cv, sv, (0, slot, 0, 0, 0))
            if self._dparams is not None:
                dcfg = self.draft_cfg
                dshape = (dcfg.num_layers, 1, dcfg.num_heads, P, dcfg.hidden_size // dcfg.num_heads)
                dsk = _kv_zeros(dshape, self._dparams[1].dtype, self.device)
                dsv = _kv_zeros(dshape, self._dparams[1].dtype, self.device)
                _cache_forward(*self._dparams, ids, dsk, dsv, 0, num_heads=dcfg.num_heads)
                _kvc_copy(self._dck, dsk, (0, slot, 0, 0, 0))
                _kvc_copy(self._dcv, dsv, (0, slot, 0, 0, 0))
        else:
            C = self._chunk
            if job.next_pos + C < n:
                # an intermediate chunk: cache writes only, no logits
                tokens = job.prompt[job.next_pos:job.next_pos + C]
                self._note_dispatch(f"prefill_chunk/C{C}")
                _chunk_prefill_forward(*self._params, self._ids(tokens, C), self._ck, self._cv,
                                       slot, job.next_pos, num_heads=H)
                if self._dparams is not None:
                    self._draft_chunk(tokens, slot, job.next_pos)
                job.next_pos += C
                counter_inc("infer.prefill_chunk_dispatches")
                return False
            # the last chunk covers rows [next_pos, n) in one C-token window,
            # chunk-aligned unless the padded window would run past
            # max_seq_len: then it shifts back to [n-C, n) and writes a few
            # rows again
            w = job.next_pos if job.next_pos + C <= self.max_seq_len else n - C
            tokens = job.prompt[w:n]
            self._note_dispatch(f"prefill_final/C{C}")
            logits = _chunk_prefill_forward(*self._params, self._ids(tokens, C), self._ck,
                                            self._cv, slot, w, num_heads=H, last_row=n - 1 - w)
            if self._dparams is not None:
                self._draft_chunk(tokens, slot, w)
            counter_inc("infer.prefill_chunk_dispatches")
        gen = _position_generator(job.seed, n - 1, self.device) if do_sample else None
        first = int(_select_token(logits.float(), gen, *self._sample)[0])  # the prefill's host sync
        more = not (job.eos >= 0 and first == job.eos) and n + 1 < job.limit
        self._pos[slot] = n
        self._tok[slot] = first
        self._active[slot] = more
        self._pos_np[slot] = n
        self._active_np[slot] = more
        job.next_pos = n
        job.first, job.more, job.done = first, more, True
        counter_inc("infer.prefill_dispatches")
        counter_inc("infer.tokens")
        if self.prefix_cache is not None:
            self._store_prefix_chunks(job)
        return True

    def _store_prefix_chunks(self, job: _PrefillJob) -> None:
        """After a prefill, store every chunk-aligned prefix segment of the
        prompt not cached yet, as a copy (the slot's rows below n are final:
        decode writes only at positions >= n)."""
        cache = self.prefix_cache
        C, L, H = self._chunk, self.cfg.num_layers, self.cfg.num_heads
        for i in range(job.n // C):
            key = cache.key(job.prompt, i)
            if cache.has(key):
                continue
            size = (L, 1, H, C, self._dh)
            seg_k = _kvc_slice(self._ck, (0, job.slot, 0, i * C, 0), size)
            seg_v = _kvc_slice(self._cv, (0, job.slot, 0, i * C, 0), size)
            self._note_dispatch("prefix_extract")
            counter_inc("infer.prefix_extract_dispatches")
            cache.put(key, seg_k, seg_v)
        gauge_set("serving.prefix_cache_bytes", cache.bytes_used())

    def prefill(self, prompt, slot: int, max_new_tokens: int, eos_token_id: Optional[int] = None,
                seed: int = 0) -> Tuple[int, bool]:
        """Admit one prompt into ``slot`` synchronously (every chunk back to
        back). Returns ``(first_token, more)``; ``more`` False means the
        request finished at its first token (eos or max_new_tokens == 1)."""
        job = self.begin_prefill(prompt, slot, max_new_tokens, eos_token_id=eos_token_id, seed=seed)
        while not self.prefill_step(job):
            pass
        return job.first, job.more

    # ------------------------------------------------------------- decode
    def _generators(self, live, offset, purpose=0):
        """Per-slot generators of the draws at positions ``pos + offset`` of
        the slots in ``live`` (None elsewhere: their draws are not used)."""
        return [_position_generator(self._seed[i], self._pos_np[i] + offset, self.device, purpose)
                if live[i] else None for i in range(self.max_batch_slots)]

    def _read_back(self, toks, emits, active):
        """The dispatch's one device-to-host transfer: ``[D, B]`` tokens and
        emitted flags and the ``[B]`` active flags, as numpy."""
        D, B = toks.shape
        host = torch.cat([toks.reshape(-1), emits.long().reshape(-1), active.long()]).cpu().numpy()
        return (host[:D * B].reshape(D, B), host[D * B:2 * D * B].reshape(D, B).astype(bool),
                host[2 * D * B:].astype(bool))

    @torch.no_grad()
    def decode_step(self, fuse: Optional[int] = None):
        """Advance every active slot. At fuse depth 1 returns
        ``(tokens[B], emitted[B], active[B])``; at depth D > 1 it runs D
        decode iterations with the slot state on the device and returns
        ``(tokens[D, B], emitted[D, B], active[B])``: a slot that stops at
        iteration j (eos or its limit) deactivates on the device
        (``emitted[j+1:, slot]`` False). One host sync per call. With a
        draft model one call is one speculative step: ``[spec_k+1, B]``
        stacks whose emitted rows are the accepted run."""
        depth = self.fuse if fuse is None else int(fuse)
        if depth < 1:
            raise ValueError(f"fuse depth must be >= 1, got {depth}")
        if self._dparams is not None:
            if depth != 1:
                raise ValueError("speculative decode runs at fuse depth 1 (one "
                                 "dispatch already emits up to spec_k+1 tokens)")
            return self._spec_step()
        self._note_dispatch("decode" if depth == 1 else f"decode_x{depth}")
        live = self._active_np.copy()
        sample = self._sample
        pos, tok, active = self._pos, self._tok, self._active
        toks, emits = [], []
        for i in range(depth):
            logits = _slot_decode_forward(*self._params, tok, self._ck, self._cv, pos,
                                          num_heads=self.cfg.num_heads, active=active)
            # an active slot's position at iteration i is pos + i, known
            # on the host before the loop: its generator needs no sync
            gens = self._generators(live, i) if sample[0] else None
            nxt = torch.where(active, _select_token_rows(logits.float(), gens, *sample), tok)
            hit_eos = (self._eos >= 0) & (nxt == self._eos)
            new_pos = pos + active.long()
            toks.append(nxt)
            emits.append(active)
            active = active & ~hit_eos & (new_pos + 1 < self._limit)
            pos, tok = new_pos, nxt
        self._pos, self._tok, self._active = pos, tok, active
        toks, emitted, self._active_np = self._read_back(torch.stack(toks), torch.stack(emits), active)
        self._pos_np += emitted.sum(axis=0)
        counter_inc("infer.decode_dispatches")
        counter_inc("infer.tokens", int(emitted.sum()))
        observe("infer.tokens_per_decode_dispatch", float(emitted.sum()))
        if depth == 1:
            return toks[0], emitted[0], self._active_np.copy()
        return toks, emitted, self._active_np.copy()

    def _spec_step(self):
        """ONE speculative step: spec_k+1 chained draft forwards on the draft
        cache propose a window, ONE (spec_k+1)-wide target forward verifies
        it, and the accept-longest-prefix ledger (with the eos/limit stops
        inside the window) runs on the device. A rejected tail's K/V stays
        past the rolled-back position, to be overwritten before any emitted
        row attends it."""
        K = self.spec_k
        self._note_dispatch(f"spec_decode/K{K}")
        do_sample, temperature, top_k, top_p = self._sample
        live = self._active_np.copy()
        pos, tok, active = self._pos, self._tok, self._active
        dheads = self.draft_cfg.num_heads

        def draw(probs, gens, fallback):
            # one draw per live row from its own generator
            out = fallback.clone()
            for b, g in enumerate(gens):
                if g is not None:
                    out[b] = _sample(probs[b:b + 1], g)[0]
            return out

        # --- draft: iteration i consumes the token at pos+i and writes its
        # draft K/V there; iterations 0..K-1 propose d_1..d_K, iteration K
        # only writes the last proposal's K/V (no hole when all are accepted)
        props, dfilt = [], []
        dtok = tok
        for i in range(K + 1):
            dlogits = _slot_decode_forward(*self._dparams, dtok, self._dck, self._dcv, pos + i,
                                           num_heads=dheads, active=active)
            if i == K:
                break
            if do_sample:
                fl = _filtered_logits(dlogits.float(), temperature, top_k, top_p)
                nd = draw(torch.softmax(fl, dim=-1), self._generators(live, i, purpose=3), dtok)
                dfilt.append(fl)
            else:
                nd = dlogits.float().argmax(dim=-1)
            dtok = torch.where(active, nd, dtok)  # free slots hold
            props.append(dtok)
        # --- target: one (K+1)-wide window over [tok, d_1..d_K] at pos..pos+K
        ids = torch.stack([tok] + props, dim=1)
        vlogits = _slot_window_forward(*self._params, ids, self._ck, self._cv, pos,
                                       num_heads=self.cfg.num_heads, active=active)
        # --- row j scores the token at pos+j+1. Greedy: argmax and equality
        # accept. Sampled: accept d with probability min(1, p(d)/q(d)), else
        # draw from the residual max(P - Q, 0), both over the same filtered
        # distributions the sequential sampler uses; the bonus row draws
        # from the position's own generator, as sequential decode does.
        outs, accs = [], []
        for j in range(K + 1):
            lg = vlogits[:, j].float()
            if not do_sample:
                sel = lg.argmax(dim=-1)
                outs.append(sel)
                if j < K:
                    accs.append(sel == props[j])
                continue
            flp = _filtered_logits(lg, temperature, top_k, top_p)
            P_ = torch.softmax(flp, dim=-1)
            if j == K:
                outs.append(draw(P_, self._generators(live, j), tok))
                break
            Q_ = torch.softmax(dfilt[j], dim=-1)
            d = props[j]
            pd = P_.gather(1, d[:, None])[:, 0]
            qd = Q_.gather(1, d[:, None])[:, 0]
            u = torch.ones_like(pd)
            for b, g in enumerate(self._generators(live, j, purpose=1)):
                if g is not None:
                    u[b] = torch.rand((), generator=g, device=self.device)
            acc = u * qd <= pd
            res = (P_ - Q_).clamp_min(0.0)
            has = res.sum(dim=-1, keepdim=True) > 0
            res = torch.where(has, res, P_)  # P == Q: the residual falls back to the target
            corr = draw(res / res.sum(dim=-1, keepdim=True), self._generators(live, j, purpose=2), d)
            outs.append(torch.where(acc, d, corr))
            accs.append(acc)
        # --- emission ledger: the accepted run plus one token; eos and the
        # limit stop a row inside the window; a rejected tail rolls the slot
        # back by not advancing it
        win = torch.ones_like(active)
        act_s, pos_s, tok_s = active, pos, tok
        rows, emits = [], []
        for j in range(K + 1):
            emit = act_s & win
            row = torch.where(emit, outs[j], tok_s)
            tok_s = row
            pos_s = pos_s + emit.long()
            live_j = ~((self._eos >= 0) & (row == self._eos)) & (pos_s + 1 < self._limit)
            act_s = torch.where(emit, act_s & live_j, act_s)
            rows.append(row)
            emits.append(emit)
            if j < K:
                win = win & accs[j]
        self._pos, self._tok, self._active = pos_s, tok_s, act_s
        toks, emitted, self._active_np = self._read_back(torch.stack(rows), torch.stack(emits), act_s)
        self._pos_np += emitted.sum(axis=0)
        n_active = int(emitted[0].sum())  # row 0 emits once per live slot
        n_emitted = int(emitted.sum())
        self._spec_drafted += K * n_active
        self._spec_accepted += n_emitted - n_active
        counter_inc("infer.decode_dispatches")
        counter_inc("infer.tokens", n_emitted)
        counter_inc("infer.spec_draft_tokens", K * n_active)
        counter_inc("infer.spec_accepted_tokens", n_emitted - n_active)
        if self._spec_drafted:
            gauge_set("serving.spec_acceptance_rate", self._spec_accepted / self._spec_drafted)
        observe("infer.tokens_per_decode_dispatch", float(n_emitted))
        return toks, emitted, self._active_np.copy()

    def free_slot(self, slot: int) -> None:
        """Release a slot for the next admission (cancels it if still live)."""
        if self._active_np[slot]:
            self._active[slot] = False
            self._active_np[slot] = False
        self._occupied[slot] = False

    def reset(self) -> None:
        """Drop every in-flight request and zero the slot state (the cache
        keeps its buffers: stale K/V is always overwritten before it can be
        attended)."""
        for t in (self._pos, self._tok, self._active, self._limit):
            t.zero_()
        self._eos.fill_(-1)
        self._pos_np[:] = 0
        self._active_np[:] = False
        self._occupied[:] = False
        self._seed[:] = 0

    # ------------------------------------------------------------- helpers
    def generate(self, ids, max_new_tokens: int = 32, eos_token_id: Optional[int] = None,
                 seed: int = 0, fuse: Optional[int] = None) -> np.ndarray:
        """Batch generate through the slot machinery: each row takes one
        slot, prefill once per row, then decode steps (at ``fuse`` depth,
        default the engine's) until every row finishes. Returns
        ``[b, s0 + max_new_tokens]`` int64 (rows that hit eos pad with it),
        the contract of ``GPTForPretraining.generate``."""
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
        while self._active_np.any():
            toks, emitted, _ = self.decode_step(fuse=fuse)
            toks = np.atleast_2d(toks)
            emitted = np.atleast_2d(emitted)
            for d in range(toks.shape[0]):
                for i in range(b):
                    if emitted[d, i]:
                        rows[i].append(int(toks[d, i]))
        for i in range(b):
            self.free_slot(i)
        out = np.zeros((b, s0 + int(max_new_tokens)), np.int64)
        out[:, :s0] = ids
        for i, r in enumerate(rows):
            pad = r[-1] if eos_token_id is None else int(eos_token_id)
            r = r + [pad] * (int(max_new_tokens) - len(r))
            out[i, s0:] = r[:int(max_new_tokens)]
        return out

    def explain(self, analyze: bool = False):
        """The reference's per-program cost rows come from XLA's AOT
        compile; the port compiles no serving program."""
        raise NotImplementedError(
            "DecodeEngine.explain() is not ported to paddle_tpu_torch: the port compiles no "
            "serving program; queued in ROADMAP.md (Queue 1, item 14)")

    def cache_bytes(self) -> int:
        """Device bytes held by the target K/V cache as stored: under
        ``kv_dtype="int8"`` the int8 payload plus the f32 scales."""
        return _kv_bytes(self._ck) + _kv_bytes(self._cv)

    def draft_cache_bytes(self) -> int:
        """Device bytes held by the draft model's K/V cache (0 without a
        draft)."""
        return 0 if self._dck is None else _kv_bytes(self._dck) + _kv_bytes(self._dcv)

    def kv_bytes_per_slot(self) -> int:
        """Per-request device cost of admission: the target cache's stored
        bytes over the slot count (the ``infer.kv_bytes_per_slot`` gauge)."""
        return self.cache_bytes() // self.max_batch_slots

    def spec_stats(self) -> dict:
        """Cumulative speculative-decoding counters: proposals drafted,
        accepted, and their ratio (0.0 before any decode)."""
        drafted = self._spec_drafted
        return {"spec_k": self.spec_k, "drafted": drafted,
                "accepted": self._spec_accepted,
                "acceptance_rate": (self._spec_accepted / drafted) if drafted else 0.0}

"""Continuous (in-flight) batching scheduler of the port
(``paddle_tpu/inference/scheduler.py``) over a :class:`DecodeEngine`.

Requests arrive at any time and are admitted into free batch slots
mid-stream: a new request's prefill runs while other slots keep decoding,
and every decode step advances all occupied slots. Requests carry optional
deadlines and can be cancelled mid-flight: an expired or cancelled request
frees its slot at once and lands in ``.cancelled``. The ``serving.*``
counters, gauges and histograms go to the port's metrics registry; the run
log and traces wait for the observability slice.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..observability.metrics import counter_inc, gauge_set, observe

__all__ = ["Request", "ContinuousBatchingScheduler"]


class Request:
    """One in-flight generation request and its lifecycle timestamps.

    ``status`` walks ``queued -> prefilling -> running -> finished``, or ends
    at ``cancelled`` / ``deadline_exceeded``.
    """

    def __init__(self, rid: int, prompt: np.ndarray, max_new_tokens: int,
                 eos_token_id: Optional[int], seed: int, deadline_s: Optional[float] = None):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int64).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.seed = int(seed)
        self.deadline_s = float(deadline_s) if deadline_s is not None else None
        self.status = "queued"
        self.tokens: List[int] = []
        self.slot: Optional[int] = None
        self.bucket: Optional[int] = None
        self.stall_seconds = 0.0      # prefill time spent while decode waited
        self.submitted_ts = time.perf_counter()
        self.admitted_ts: Optional[float] = None
        self.first_token_ts: Optional[float] = None
        self.finished_ts: Optional[float] = None

    @property
    def queue_seconds(self):
        return None if self.admitted_ts is None else self.admitted_ts - self.submitted_ts

    @property
    def ttft_seconds(self):
        return None if self.first_token_ts is None else self.first_token_ts - self.submitted_ts

    @property
    def decode_seconds(self):
        if self.finished_ts is None or self.first_token_ts is None:
            return None
        return self.finished_ts - self.first_token_ts

    @property
    def total_seconds(self):
        return None if self.finished_ts is None else self.finished_ts - self.submitted_ts

    def deadline_expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_s is None:
            return False
        now = time.perf_counter() if now is None else now
        return now - self.submitted_ts > self.deadline_s

    def output_ids(self) -> np.ndarray:
        """prompt + generated tokens, the served completion."""
        return np.concatenate([self.prompt, np.asarray(self.tokens, np.int64)])


class ContinuousBatchingScheduler:
    """Admit-into-free-slots scheduler: a FIFO queue in front of the engine's
    batch slots. Drive it with :meth:`step` (one admission sweep, the
    prefills of new admissions, one decode step) or :meth:`run` (until
    drained)."""

    def __init__(self, engine, keep_finished: int = 256):
        if keep_finished < 1:
            raise ValueError(f"keep_finished must be >= 1, got {keep_finished}")
        self.engine = engine
        self.keep_finished = int(keep_finished)
        self.queue: deque = deque()
        self.prefilling: Dict[int, Request] = {}  # slot -> mid-prefill request
        self._jobs: Dict[int, object] = {}        # slot -> engine prefill job
        self.running: Dict[int, Request] = {}     # slot -> decoding request
        # terminal ledgers, GC'd past keep-last-k (insertion = completion order)
        self.finished: Dict[int, Request] = {}
        self.cancelled: Dict[int, Request] = {}
        self._next_rid = 0

    def submit(self, prompt, max_new_tokens: int = 16, eos_token_id: Optional[int] = None,
               seed: int = 0, deadline_s: Optional[float] = None) -> int:
        """Enqueue one prompt; returns the request id. Validation happens here
        so a bad request fails its caller, not the serving loop.
        ``deadline_s`` bounds the request's total time from submission."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        n = int(prompt.shape[0])
        if n + int(max_new_tokens) > self.engine.max_seq_len:
            raise ValueError(f"prompt {n} + max_new_tokens {max_new_tokens} exceeds "
                             f"engine max_seq_len {self.engine.max_seq_len}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.engine.bucket_for(n)  # raises if no bucket fits
        r = Request(self._next_rid, prompt, max_new_tokens, eos_token_id, seed, deadline_s=deadline_s)
        self._next_rid += 1
        self.queue.append(r)
        counter_inc("serving.requests_submitted")
        gauge_set("serving.queue_depth", len(self.queue))
        return r.rid

    def cancel(self, rid: int, status: str = "cancelled") -> bool:
        """Cancel one in-flight request wherever it is (queued, mid-prefill
        or mid-decode; its slot frees at once). Returns False when ``rid`` is
        not in flight."""
        r = None
        for q in self.queue:
            if q.rid == rid:
                r = q
                self.queue.remove(q)
                gauge_set("serving.queue_depth", len(self.queue))
                break
        for table in (self.prefilling, self.running):
            if r is not None:
                break
            for slot, cand in list(table.items()):
                if cand.rid == rid:
                    r = cand
                    del table[slot]
                    self._jobs.pop(slot, None)
                    self.engine.free_slot(slot)
                    break
        if r is None:
            return False
        r.status = status
        r.finished_ts = time.perf_counter()
        self.cancelled[rid] = r
        counter_inc("serving.deadline_exceeded" if status == "deadline_exceeded"
                    else "serving.requests_cancelled")
        gauge_set("serving.active_slots", len(self.running))
        return True

    def find(self, rid: int):
        """The in-flight :class:`Request` with id ``rid``, else None."""
        for r in list(self.queue) + list(self.prefilling.values()) + list(self.running.values()):
            if r.rid == rid:
                return r
        return None

    def _expire_deadlines(self) -> None:
        now = time.perf_counter()
        live = list(self.queue) + list(self.prefilling.values()) + list(self.running.values())
        for rid in [r.rid for r in live if r.deadline_expired(now)]:
            self.cancel(rid, status="deadline_exceeded")

    def _admit(self) -> None:
        free = self.engine.free_slots()
        while self.queue and free:
            r = self.queue.popleft()
            slot = free.pop(0)
            r.slot = slot
            r.bucket = self.engine.bucket_for(len(r.prompt))
            r.status = "prefilling"
            r.admitted_ts = time.perf_counter()
            self._jobs[slot] = self.engine.begin_prefill(
                r.prompt, slot, max_new_tokens=r.max_new_tokens,
                eos_token_id=r.eos_token_id, seed=r.seed)
            self.prefilling[slot] = r
            gauge_set("serving.queue_depth", len(self.queue))

    def _prefill_tick(self) -> None:
        """One prefill step per admission; prefill time spent while decodes
        wait counts as stall."""
        for slot in list(self.prefilling):
            r = self.prefilling[slot]
            decode_waiting = bool(self.running)
            t0 = time.perf_counter()
            done = self.engine.prefill_step(self._jobs[slot])
            dt = time.perf_counter() - t0
            if decode_waiting:
                r.stall_seconds += dt
                observe("serving.prefill_stall_seconds", dt)
            if not done:
                continue
            job = self._jobs.pop(slot)
            del self.prefilling[slot]
            r.first_token_ts = time.perf_counter()
            r.tokens.append(job.first)
            counter_inc("serving.requests_admitted")
            observe("serving.ttft_seconds", r.ttft_seconds)
            observe("serving.queue_seconds", r.queue_seconds)
            if job.more:
                r.status = "running"
                self.running[slot] = r
            else:
                self._finish(r)
            gauge_set("serving.active_slots", len(self.running))

    def _finish(self, r: Request) -> None:
        r.status = "finished"
        r.finished_ts = time.perf_counter()
        self.engine.free_slot(r.slot)
        self.running.pop(r.slot, None)
        self.finished[r.rid] = r
        counter_inc("serving.requests_completed")
        counter_inc("serving.tokens_generated", len(r.tokens))
        observe("serving.latency_seconds", r.total_seconds)
        gauge_set("serving.active_slots", len(self.running))

    def step(self) -> List[Request]:
        """One scheduler tick: expire deadlines, admit queued requests into
        free slots, prefill them, then advance every decoding slot in a
        single decode step. Returns the requests finished this tick."""
        before = set(self.finished)
        before_cancelled = set(self.cancelled)
        self._expire_deadlines()
        self._admit()
        self._prefill_tick()
        if self.running:
            toks, emitted, active = self.engine.decode_step()
            for slot, r in self.running.items():
                if emitted[slot]:
                    r.tokens.append(int(toks[slot]))
            for slot, r in list(self.running.items()):
                if not active[slot]:
                    self._finish(r)
        fresh = ({rid for rid in self.finished if rid not in before}
                 | {rid for rid in self.cancelled if rid not in before_cancelled})
        done = [self.finished[rid] for rid in self.finished if rid not in before]
        self._gc_ledgers(protect=fresh)
        return done

    def _gc_ledgers(self, protect=()) -> None:
        """Evict the oldest terminal entries past ``keep_finished``; this
        tick's rids are never evicted."""
        for ledger in (self.finished, self.cancelled):
            overflow = len(ledger) - self.keep_finished
            for rid in [r for r in ledger if r not in protect][:max(0, overflow)]:
                del ledger[rid]

    def run(self, max_steps: Optional[int] = None) -> Dict[int, Request]:
        """Drive :meth:`step` until queue and slots drain (or ``max_steps``
        ticks); returns ``{rid: Request}`` for everything finished during the
        run."""
        done: Dict[int, Request] = dict(self.finished)
        steps = 0
        while self.queue or self.prefilling or self.running:
            for r in self.step():
                done[r.rid] = r
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        done.update(self.finished)
        return done

"""Chunked prefill and the prefix cache of the port's ``DecodeEngine``
(``paddle_tpu_torch.inference``) against ``paddle_tpu``'s, on the CPU at
``GPTConfig.tiny()``.

Weights move across by name; both packages take the same numpy prompts.
Greedy tokens are compared exactly; the chunk forward's f32 logits and
cache rows within atol 1e-5. The reference engines are built with the
default, empty ``FLAGS_compile_cache_dir``. Mirrors
``tests/test_inference.py``'s chunked, prefix-reuse and interleave tests.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import DecodeEngine as JDecodeEngine
from paddle_tpu.inference.prefix_cache import PrefixCache as JPrefixCache
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT

from paddle_tpu_torch.inference import ContinuousBatchingScheduler, DecodeEngine
from paddle_tpu_torch.inference.prefix_cache import PrefixCache
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu

ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    paddle.seed(42)
    jm = JGPT(JGPTConfig.tiny())
    jm.eval()
    pm = GPTForPretraining(GPTConfig.tiny(), device="cpu").eval()
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    return jm, pm


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (n,)).astype(np.int64) for n in lens]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_chunk_prefill_forward_matches_paddle_tpu(pair, kv_dtype):
    """One chunk against a cache whose earlier rows are written: the
    ``last_row`` logits and every cache row agree (an int8 pack's
    dequantized rows)."""
    import jax.numpy as jnp

    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch.models import gpt as pgpt

    jm, pm = pair
    cfg = pm.gpt.cfg
    L, H, dh, B, S, C = cfg.num_layers, cfg.num_heads, cfg.hidden_size // cfg.num_heads, 2, 32, 8
    ids = np.random.default_rng(3).integers(0, 512, (1, 2 * C))
    jstack, jwte, jwpe, jfnw, jfnb = jm._decode_params()
    pparams = pm._decode_params()
    jk = jgpt._kv_zeros((L, B, H, S, dh), jnp.float32, kv_dtype)
    jv = jgpt._kv_zeros((L, B, H, S, dh), jnp.float32, kv_dtype)
    pk = pgpt._kv_zeros((L, B, H, S, dh), torch.float32, "cpu", kv_dtype)
    pv = pgpt._kv_zeros((L, B, H, S, dh), torch.float32, "cpu", kv_dtype)
    for start, last in ((0, None), (C, C - 3)):
        chunk = ids[:, start:start + C]
        jl, jk, jv = jgpt._chunk_prefill_forward(jstack, jwte, jwpe, jfnw, jfnb,
                                                 jnp.asarray(chunk, jnp.int32), jk, jv, 1, start,
                                                 num_heads=H, last_row=last)
        pl = pgpt._chunk_prefill_forward(*pparams, torch.from_numpy(chunk), pk, pv, 1, start,
                                         num_heads=H, last_row=last)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for j, p in ((jk, pk), (jv, pv)):
        if kv_dtype:
            j, p = jgpt._kv_dequant(j, jnp.float32), pgpt._kv_dequant(p, torch.float32)
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def test_chunked_prefill_equals_bucketed_and_paddle_tpu(pair):
    """Chunked prefill gives the bucketed path's tokens for every prompt
    length, and the reference's chunked engine's; prompts longer than one
    chunk take several chunk steps."""
    jm, pm = pair
    prompts = _prompts((5, 8, 13, 20, 31), seed=12)
    base = DecodeEngine(pm, max_batch_slots=1, max_seq_len=64, prefill_buckets=(8, 16, 32))
    want = [base.generate(p[None], max_new_tokens=6)[0] for p in prompts]
    metrics.reset_counters("infer.")
    eng = DecodeEngine(pm, max_batch_slots=1, max_seq_len=64, prefill_chunk=8)
    got = [eng.generate(p[None], max_new_tokens=6)[0] for p in prompts]
    ref = JDecodeEngine(jm, max_batch_slots=1, max_seq_len=64, prefill_chunk=8)
    for g, w, p in zip(got, want, prompts):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, ref.generate(p[None].astype(np.int32), max_new_tokens=6)[0])
    assert metrics.counters("infer.")["infer.prefill_chunk_dispatches"] == sum(
        -(-len(p) // 8) for p in prompts)


def test_final_chunk_shifts_back_at_the_cache_end(pair):
    """A prompt whose chunk-aligned last window would run past max_seq_len:
    the window shifts back to [n-C, n), and the tokens still equal the
    bucketed path's and the reference's."""
    jm, pm = pair
    (p,) = _prompts((58,), seed=21)  # chunks [0, 24), [24, 48); the last from 34
    kw = dict(max_batch_slots=1, max_seq_len=64)
    want = DecodeEngine(pm, prefill_buckets=(64,), **kw).generate(p[None], max_new_tokens=6)
    eng = DecodeEngine(pm, prefill_chunk=24, **kw)
    job = eng.begin_prefill(p, 0, max_new_tokens=6)
    steps = 1
    while not eng.prefill_step(job):
        steps += 1
    assert steps == 3 and job.next_pos == 58
    eng.free_slot(0)
    np.testing.assert_array_equal(eng.generate(p[None], max_new_tokens=6), want)
    ref = JDecodeEngine(jm, prefill_chunk=24, **kw)
    np.testing.assert_array_equal(want, ref.generate(p[None].astype(np.int32), max_new_tokens=6))


def test_prefix_cache_reuse_and_eviction(pair):
    """A prompt whose prefix matches cached chunks copies them into its slot
    instead of prefilling them, with the cold tokens; the budget bounds the
    stored bytes."""
    _, pm = pair
    rng = np.random.default_rng(13)
    shared = rng.integers(0, 512, (16,))
    prompts = [np.concatenate([shared, rng.integers(0, 512, (5,))]) for _ in range(2)]
    cold = DecodeEngine(pm, max_batch_slots=1, max_seq_len=64, prefill_chunk=8)
    want = [cold.generate(p[None], max_new_tokens=5)[0] for p in prompts]
    metrics.reset_counters("infer.")
    metrics.reset_counters("serving.")
    eng = DecodeEngine(pm, max_batch_slots=1, max_seq_len=64, prefill_chunk=8, prefix_cache_mb=4.0)
    got0 = eng.generate(prompts[0][None], max_new_tokens=5)[0]
    chunks_cold = metrics.counters("infer.")["infer.prefill_chunk_dispatches"]
    got1 = eng.generate(prompts[1][None], max_new_tokens=5)[0]
    chunks_warm = metrics.counters("infer.")["infer.prefill_chunk_dispatches"] - chunks_cold
    np.testing.assert_array_equal(got0, want[0])
    np.testing.assert_array_equal(got1, want[1])
    assert (chunks_cold, chunks_warm) == (3, 1)  # the shared 16 tokens are not prefilled again
    counts = metrics.counters("serving.")
    assert counts["serving.prefix_hits"] == 1 and counts["serving.prefix_tokens_reused"] == 16
    assert metrics.counters("infer.")["infer.prefix_insert_dispatches"] == 2
    assert metrics.counters("infer.")["infer.prefix_extract_dispatches"] == 2
    assert metrics.gauges("serving.")["serving.prefix_cache_bytes"] == eng.prefix_cache.bytes_used()
    assert eng.prefix_cache.bytes_used() == 2 * eng.prefix_cache.entry_bytes
    assert eng.prefix_cache.bytes_used() <= eng.prefix_cache.budget_bytes

    pc = PrefixCache(chunk=4, budget_bytes=3 * 100, entry_bytes=100)
    toks = np.arange(32, dtype=np.int64)
    for i in range(5):
        pc.put(pc.key(toks, i), f"k{i}", f"v{i}")
    assert len(pc) == 3 and pc.evictions == 2
    assert not pc.has(pc.key(toks, 0))  # the oldest chain is gone
    assert pc.match(toks, max_tokens=32) == []  # the chain breaks at chunk 0
    assert pc.stats()["bytes_used"] == 300


def test_prefix_cache_stats_equal_paddle_tpu():
    """The same sequence of put, match and eviction over tensor segments
    (and their numpy twins in the reference's cache) gives the same
    ``stats()``, keys and matches."""
    rng = np.random.default_rng(5)
    seg = np.zeros((2, 1, 4, 4, 16), np.float32)  # 2048 bytes; a pack 512 + 128
    pack = {"q": np.zeros((2, 1, 4, 4, 16), np.int8), "s": np.zeros((2, 1, 4, 4), np.float32)}
    ours = PrefixCache(chunk=4, budget_bytes=4 * 4096, entry_bytes=4096)
    ref = JPrefixCache(chunk=4, budget_bytes=4 * 4096, entry_bytes=4096)
    prompts = [rng.integers(0, 9, (n,)) for n in (13, 17, 17, 13, 6)]
    prompts[1][:8] = prompts[0][:8]  # a hit on two chunks, then two pack entries
    prompts[3][:12] = prompts[2][:12]
    for step, p in enumerate(prompts):
        for cache, wrap in ((ours, torch.from_numpy), (ref, lambda a: a)):
            matched = cache.match(p, max_tokens=len(p) - 1)
            for i in range(len(matched), len(p) // 4):
                if step % 2:
                    cache.put(cache.key(p, i), {k: wrap(v) for k, v in pack.items()},
                              {k: wrap(v) for k, v in pack.items()})
                else:
                    cache.put(cache.key(p, i), wrap(seg), wrap(seg))
        assert ours.stats() == ref.stats()
        assert ours.key(p, 0) == ref.key(p.astype(np.int32), 0)
    assert ours.stats()["evictions"] > 0 and ours.stats()["hits"] > 0


def test_prefix_entries_are_copies_not_views(pair):
    """A prefix entry is a copy of the cache rows: after another request
    reused the slot and overwrote them, a warm hit still gives the cold
    tokens (a view would hand it the other request's K/V)."""
    _, pm = pair
    a, b = _prompts((21, 29), seed=17)
    cold = DecodeEngine(pm, max_batch_slots=1, max_seq_len=64, prefill_chunk=8)
    want = cold.generate(a[None], max_new_tokens=6)
    eng = DecodeEngine(pm, max_batch_slots=1, max_seq_len=64, prefill_chunk=8, prefix_cache_mb=4.0)
    np.testing.assert_array_equal(eng.generate(a[None], max_new_tokens=6), want)  # stores 2 chunks
    before = [seg.clone() for seg in eng.prefix_cache.match(a, max_tokens=20)[0]]
    eng.generate(b[None], max_new_tokens=6)  # slot 0 again: rows 0..28 overwritten
    hits = eng.prefix_cache.hits
    np.testing.assert_array_equal(eng.generate(a[None], max_new_tokens=6), want)
    assert eng.prefix_cache.hits == hits + 1
    for seg, old in zip(eng.prefix_cache.match(a, max_tokens=20)[0], before):
        assert torch.equal(seg, old)


def test_scheduler_chunked_prefill_interleaves_with_decode(pair):
    """A long admission runs one chunk per tick while the decoding request
    keeps emitting between the chunks; tokens equal isolated runs, and the
    long request's stall is counted."""
    _, pm = pair
    short, long = _prompts((6, 40), seed=14)

    def mk():
        return DecodeEngine(pm, max_batch_slots=2, max_seq_len=64, prefill_chunk=8)

    iso_short = mk().generate(short[None], max_new_tokens=10)[0, 6:].tolist()
    iso_long = mk().generate(long[None], max_new_tokens=6)[0, 40:].tolist()
    sched = ContinuousBatchingScheduler(mk())
    r_short = sched.submit(short, max_new_tokens=10)
    sched.step()  # the short prompt: one final chunk, then a decode
    r_long = sched.submit(long, max_new_tokens=6)
    progress = []
    while sched.prefilling or sched.queue:
        sched.step()
        req = next((r for r in sched.running.values() if r.rid == r_short), None)
        if req is not None:
            progress.append(len(req.tokens))
    done = sched.run()
    assert done[r_short].tokens == iso_short
    assert done[r_long].tokens == iso_long
    assert len(progress) >= 2 and progress[-1] > progress[0]
    assert done[r_long].prefill_chunks == 5 and done[r_long].stall_seconds > 0
    assert done[r_short].stall_seconds == 0.0  # nothing was decoding at its admission

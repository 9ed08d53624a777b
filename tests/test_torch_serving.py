"""Serving path of the port: ``DecodeEngine`` + ``ContinuousBatchingScheduler``
(``paddle_tpu_torch.inference``) on the tiny GPT, on the CPU.

Greedy tokens served by the port equal the port's ``generate()`` and
``paddle_tpu``'s ``DecodeEngine`` on the same prompts and weights; slot
reuse, bucketing, eos / limit, cancel and deadlines mirror
``tests/test_inference.py``; the engine's validation errors and its cache
byte counts equal the reference's. The knobs themselves are held against
the reference in ``tests/test_torch_serving_{chunked,fused,int8,spec}.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import DecodeEngine as JDecodeEngine
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT

from paddle_tpu_torch.inference import ContinuousBatchingScheduler, DecodeEngine
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu


def _tiny_engine(m, slots=2, **kw):
    return DecodeEngine(m, max_batch_slots=slots, max_seq_len=64, prefill_buckets=(8, 16), **kw)


def _model(seed=0):
    return GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=seed).eval()


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (n,)).astype(np.int64) for n in lens]


def test_served_tokens_equal_generate_and_paddle_tpu():
    paddle.seed(41)
    jm = JGPT(JGPTConfig.tiny())
    jm.eval()
    pm = GPTForPretraining(GPTConfig.tiny(), device="cpu").eval()
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    prompts = _prompts((5, 9, 3, 12, 6), seed=4)

    sched = ContinuousBatchingScheduler(_tiny_engine(pm))
    rids = [sched.submit(p, max_new_tokens=6) for p in prompts]
    done = sched.run()
    jeng = JDecodeEngine(jm, max_batch_slots=1, max_seq_len=64, prefill_buckets=(8, 16))
    for rid, p in zip(rids, prompts):
        served = done[rid].tokens
        assert served == pm.generate(p, max_new_tokens=6)[0, len(p):].tolist()
        assert served == jeng.generate(p[None].astype(np.int32), max_new_tokens=6)[0, len(p):].tolist()


def test_scheduler_slot_reuse_and_bucketing():
    """5 requests over 2 slots: every slot is reused, each prompt pads to
    its bucket, and each admission is one prefill."""
    m = _model(31)
    metrics.reset_counters("infer.")
    sched = ContinuousBatchingScheduler(_tiny_engine(m))
    rids = [sched.submit(p, max_new_tokens=4) for p in _prompts((5, 7, 12, 3, 9), seed=1)]
    done = sched.run()
    assert sorted(done) == sorted(rids)
    assert all(len(done[r].tokens) == 4 for r in rids)
    assert {done[r].slot for r in rids} == {0, 1}
    assert [done[r].bucket for r in rids] == [8, 8, 16, 8, 16]
    counts = metrics.counters("infer.")
    assert counts["infer.prefill_dispatches"] == 5
    assert counts["infer.tokens"] == 20
    ttft = metrics.histograms("serving.")["serving.ttft_seconds"].summary()
    assert ttft["count"] >= 5 and 0 < ttft["min"] <= ttft["p50"] <= ttft["max"]
    assert metrics.gauges("serving.")["serving.active_slots"] == 0


def test_scheduler_no_cross_request_leakage_interleaved():
    """Interleaved admissions (requests join mid-decode of others) give the
    same tokens as each request run alone."""
    m = _model(32)
    prompts = _prompts((5, 9, 3, 12, 6), seed=7)
    iso = [_tiny_engine(m, slots=1).generate(p[None], max_new_tokens=5)[0, len(p):].tolist()
           for p in prompts]
    sched = ContinuousBatchingScheduler(_tiny_engine(m))
    r0 = sched.submit(prompts[0], max_new_tokens=5)
    r1 = sched.submit(prompts[1], max_new_tokens=5)
    sched.step()
    r2 = sched.submit(prompts[2], max_new_tokens=5)  # queued mid-decode
    sched.step()
    r3 = sched.submit(prompts[3], max_new_tokens=5)
    r4 = sched.submit(prompts[4], max_new_tokens=5)
    done = sched.run()
    assert [done[r].tokens for r in (r0, r1, r2, r3, r4)] == iso


def test_scheduler_eos_and_early_finish():
    """A request whose token hits eos frees its slot early; a
    max_new_tokens=1 request finishes at prefill."""
    m = _model(34)
    eng = _tiny_engine(m)
    ids = _prompts((4,), seed=0)[0]
    probe = ContinuousBatchingScheduler(eng)
    rid = probe.submit(ids, max_new_tokens=1)
    done = probe.run()
    first = done[rid].tokens[0]
    assert done[rid].slot is not None and not probe.running
    sched = ContinuousBatchingScheduler(eng)
    rid2 = sched.submit(ids, max_new_tokens=8, eos_token_id=int(first))
    assert sched.run()[rid2].tokens == [first]
    with pytest.raises(ValueError):
        sched.submit(np.zeros(60, np.int64), max_new_tokens=10)  # > max_seq_len


def test_scheduler_cancel_and_deadline_free_slots():
    m = _model(35)
    sched = ContinuousBatchingScheduler(_tiny_engine(m))
    prompts = _prompts((5, 6, 7), seed=5)
    r0, r1, r2 = (sched.submit(p, max_new_tokens=10) for p in prompts)
    sched.step()  # r0, r1 decoding; r2 queued
    assert sched.cancel(r0) and not sched.cancel(r0)
    assert sched.cancelled[r0].status == "cancelled"
    sched.step()  # r2 takes the freed slot
    assert sched.find(r2).slot == sched.cancelled[r0].slot
    late = sched.submit(prompts[0], max_new_tokens=4, deadline_s=1e-9)
    done = sched.run()
    assert sched.cancelled[late].status == "deadline_exceeded"
    assert sorted(done) == [r1, r2] and len(done[r2].tokens) == 10


def test_sampled_serving_matches_sampled_generate():
    """Sampling draws from a generator seeded by (request seed, position):
    the engine's slot and neighbours do not change a request's tokens."""
    m = _model(36)
    kw = dict(do_sample=True, temperature=0.9, top_k=50, top_p=0.95)
    eng = _tiny_engine(m, **kw)
    prompts = _prompts((5, 11), seed=6)
    sched = ContinuousBatchingScheduler(eng)
    rids = [sched.submit(p, max_new_tokens=7, seed=100 + i) for i, p in enumerate(prompts)]
    done = sched.run()
    for i, (rid, p) in enumerate(zip(rids, prompts)):
        want = m.generate(p, max_new_tokens=7, seed=100 + i, **kw)[0, len(p):].tolist()
        assert done[rid].tokens == want


def _both_raise(kw, exc=ValueError):
    """The reference's engine and the port's, built on the same tiny
    weights with ``kw``, raise ``exc`` with the same message."""
    paddle.seed(51)
    jm = JGPT(JGPTConfig.tiny())
    jm.eval()
    pm = _model()
    ref = dict(max_batch_slots=2, max_seq_len=64, prefill_buckets=(8, 16))
    with pytest.raises(exc) as want:
        JDecodeEngine(jm, **ref, **{k: (jm if v == "model" else v) for k, v in kw.items()})
    with pytest.raises(exc) as got:
        _tiny_engine(pm, **{k: (pm if v == "model" else v) for k, v in kw.items()})
    assert str(got.value) == str(want.value)


# the reference's validation errors (paddle_tpu/inference/engine.py:154-300)
@pytest.mark.parametrize("knob", [dict(fuse=0), dict(prefill_chunk=65), dict(kv_dtype="fp8"),
                                  dict(draft="model", spec_k=0), dict(draft="model", fuse=2),
                                  dict(prefix_cache_mb=8.0)])
def test_engine_knob_validation_matches_paddle_tpu(knob):
    _both_raise(knob)


def test_engine_cache_bytes_count_what_is_stored():
    """``cache_bytes``, ``kv_bytes_per_slot`` and ``draft_cache_bytes`` count
    the caches as stored: f32, int8 packs (payload plus f32 scales) and the
    draft cache, with the ``spec_k`` slack rows, as the reference counts."""
    paddle.seed(52)
    jm = JGPT(JGPTConfig.tiny())
    jm.eval()
    pm = _model()
    draft = dict(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2, max_seq_len=128)
    # [L=2, B=2, H=4, S=64, dh=16], K and V
    f32 = _tiny_engine(pm)
    assert f32.cache_bytes() == 2 * 2 * 2 * 4 * 64 * 16 * 4 and f32.draft_cache_bytes() == 0
    i8 = _tiny_engine(pm, kv_dtype="int8")
    assert i8.cache_bytes() == 2 * (2 * 2 * 4 * 64 * 16 + 2 * 2 * 4 * 64 * 4)
    spec = _tiny_engine(pm, kv_dtype="int8", draft=draft, spec_k=2)
    assert spec.cache_bytes() == 2 * (2 * 2 * 4 * 66 * 16 + 2 * 2 * 4 * 66 * 4)
    assert spec.draft_cache_bytes() == 2 * 1 * 2 * 2 * 66 * 16 * 4
    for kw in (dict(), dict(kv_dtype="int8"), dict(kv_dtype="int8", draft=draft, spec_k=2)):
        ref = JDecodeEngine(jm, max_batch_slots=2, max_seq_len=64, prefill_buckets=(8, 16), **kw)
        eng = _tiny_engine(pm, **kw)
        assert (eng.cache_bytes(), eng.draft_cache_bytes(), eng.kv_bytes_per_slot()) == \
            (ref.cache_bytes(), ref.draft_cache_bytes(), ref.kv_bytes_per_slot())
    assert metrics.gauges("infer.")["infer.kv_bytes_per_slot"] == eng.kv_bytes_per_slot()
    assert f32.device == torch.device("cpu")


def test_unported_engine_parts_raise_citing_roadmap():
    """Only ``donate=False``, the on-disk AOT cache and ``explain()`` are
    left unported."""
    from paddle_tpu_torch.framework.flags import set_flags

    m = _model()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _tiny_engine(m, donate=False)
    set_flags({"FLAGS_compile_cache_dir": "/nonexistent"})
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _tiny_engine(m)
    finally:
        set_flags({"FLAGS_compile_cache_dir": ""})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _tiny_engine(m).explain()

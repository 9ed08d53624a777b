"""Draft-model speculative decoding (``DecodeEngine(draft=..., spec_k=K)``)
of the port against its plain engine and ``paddle_tpu``'s, on the CPU at
``GPTConfig.tiny()``.

Greedy: with the target as its own draft (every proposal accepted) and
with a small random draft moved across from the reference, spec decode
gives the plain engine's tokens, and ``spec_stats()`` equals the
reference's. Sampled: deterministic per seed, varying by seed, and an
oracle draft is accepted wherever greedy's is. Mirrors
``tests/test_spec_decode.py``; the reference engines are built with the
default, empty ``FLAGS_compile_cache_dir``.
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

# a smaller draft: 1 layer, hidden 32, the same vocab
DRAFT = dict(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2, max_seq_len=128)
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20)


def _moved(jm, cfg):
    pm = GPTForPretraining(cfg, device="cpu").eval()
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    return pm


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JGPT(JGPTConfig.tiny())
    jm.eval()
    return jm, _moved(jm, GPTConfig.tiny())


@pytest.fixture(scope="module")
def draft_pair():
    paddle.seed(7)
    jd = JGPT(JGPTConfig(**DRAFT))
    jd.eval()
    return jd, _moved(jd, GPTConfig(**DRAFT))


def _engine(m, slots=2, buckets=(16,), **kw):
    return DecodeEngine(m, max_batch_slots=slots, max_seq_len=64, prefill_buckets=buckets, **kw)


def test_oracle_draft_equals_plain_and_paddle_tpu(pair):
    """The target as its own draft gives the plain engine's tokens (and
    ``generate()``'s, and the reference's) at every K, and the reference's
    ``spec_stats()``."""
    jm, pm = pair
    ids = np.random.default_rng(11).integers(0, 512, (2, 9))
    want = _engine(pm).generate(ids, max_new_tokens=12)
    np.testing.assert_array_equal(want, pm.generate(torch.from_numpy(ids), max_new_tokens=12).numpy())
    for k in (1, 2, 4):
        eng = _engine(pm, draft=pm, spec_k=k)
        np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=12), want, err_msg=f"K={k}")
    ref = JDecodeEngine(jm, max_batch_slots=2, max_seq_len=64, prefill_buckets=(16,), draft=jm,
                        spec_k=4)
    np.testing.assert_array_equal(ref.generate(ids.astype(np.int32), max_new_tokens=12), want)
    assert eng.spec_stats() == ref.spec_stats()


def test_moved_draft_equals_plain_and_paddle_tpu(pair, draft_pair):
    """A small random draft, its weights moved from the reference's: most
    proposals are rejected, the tokens are the plain engine's at every K,
    and ``spec_stats()`` equals the reference's."""
    jm, pm = pair
    jd, pd = draft_pair
    ids = np.random.default_rng(3).integers(0, 512, (2, 7))
    want = _engine(pm, buckets=(8,)).generate(ids, max_new_tokens=10)
    for k in (1, 4):
        eng = _engine(pm, buckets=(8,), draft=pd, spec_k=k)
        np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=10), want, err_msg=f"K={k}")
    ref = JDecodeEngine(jm, max_batch_slots=2, max_seq_len=64, prefill_buckets=(8,), draft=jd,
                        spec_k=4)
    np.testing.assert_array_equal(ref.generate(ids.astype(np.int32), max_new_tokens=10), want)
    assert eng.spec_stats() == ref.spec_stats()
    assert eng.spec_stats()["acceptance_rate"] < 1.0


def test_config_draft_is_built_from_draft_seed(pair):
    """A draft given as a config (or its dict) is built from ``draft_seed``
    on the engine's device: the same seed, the same draft weights."""
    _, pm = pair
    a = _engine(pm, draft=DRAFT, spec_k=2, draft_seed=5)
    b = _engine(pm, draft=GPTConfig(**DRAFT), spec_k=2, draft_seed=5)
    c = _engine(pm, draft=DRAFT, spec_k=2, draft_seed=6)
    assert all(torch.equal(x, y) for x, y in zip(a._dparams[0], b._dparams[0]))
    assert not torch.equal(a._dparams[1], c._dparams[1])
    assert a._dparams[1].device == pm.gpt.layers.qkv_w.device
    ids = np.random.default_rng(4).integers(0, 512, (2, 6))
    np.testing.assert_array_equal(a.generate(ids, max_new_tokens=9),
                                  _engine(pm).generate(ids, max_new_tokens=9))


def test_spec_eos_mid_window(pair):
    """eos inside a speculative window stops the row where sequential
    decode stops it; the window's later tokens are not emitted."""
    _, pm = pair
    ids = np.random.default_rng(5).integers(0, 512, (1, 6))
    base = _engine(pm, slots=1, buckets=(8,))
    eos = int(base.generate(ids, max_new_tokens=12)[0, 6 + 4])
    want = base.generate(ids, max_new_tokens=12, eos_token_id=eos)
    eng = _engine(pm, slots=1, buckets=(8,), draft=pm, spec_k=4)
    np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=12, eos_token_id=eos), want)


def test_spec_dispatch_amortization(pair):
    """With the oracle draft at K = 4, 15 tokens take at most
    ceil(15/5) + 1 = 4 decode calls; the spec counters ride along."""
    _, pm = pair
    ids = np.random.default_rng(9).integers(0, 512, (1, 8))
    metrics.reset_counters("infer.")
    eng = _engine(pm, slots=1, buckets=(8,), draft=pm, spec_k=4)
    eng.generate(ids, max_new_tokens=15)
    counts = metrics.counters("infer.")
    assert counts["infer.decode_dispatches"] <= 4, counts
    assert counts["infer.spec_draft_tokens"] >= 4 * (counts["infer.decode_dispatches"] - 1)
    assert counts["infer.spec_accepted_tokens"] > 0
    st = eng.spec_stats()
    assert st["spec_k"] == 4 and st["acceptance_rate"] > 0.5
    assert metrics.gauges("serving.")["serving.spec_acceptance_rate"] == st["acceptance_rate"]


def test_spec_validation(pair):
    _, pm = pair
    with pytest.raises(ValueError, match="vocab"):
        _engine(pm, draft=dict(DRAFT, vocab_size=256))
    with pytest.raises(ValueError, match="positional table"):
        _engine(pm, draft=dict(DRAFT, max_seq_len=32))
    eng = _engine(pm, slots=1, buckets=(8,), draft=pm, spec_k=2)
    eng.prefill(np.random.default_rng(0).integers(0, 512, (5,)), slot=0, max_new_tokens=4)
    with pytest.raises(ValueError, match="fuse depth 1"):
        eng.decode_step(fuse=2)


def test_spec_sampled_deterministic_and_acceptance(pair):
    """Sampled spec decode is deterministic per seed and varies by seed; an
    oracle draft's proposals are accepted (u q(d) <= p(d) with q = p)
    wherever the greedy oracle's are."""
    _, pm = pair
    ids = np.random.default_rng(5).integers(0, 512, (1, 5))
    eng = _engine(pm, slots=1, buckets=(8,), draft=DRAFT, spec_k=2, **SAMPLE)
    a = eng.generate(ids, max_new_tokens=6, seed=9)
    np.testing.assert_array_equal(a, eng.generate(ids, max_new_tokens=6, seed=9))
    assert not np.array_equal(a, eng.generate(ids, max_new_tokens=6, seed=10))
    ids = np.random.default_rng(6).integers(0, 512, (2, 7))
    greedy = _engine(pm, draft=pm, spec_k=3)
    greedy.generate(ids, max_new_tokens=12)
    sampled = _engine(pm, draft=pm, spec_k=3, **SAMPLE)
    out = sampled.generate(ids, max_new_tokens=12, seed=3)
    assert sampled.spec_stats() == greedy.spec_stats()
    assert ((0 <= out) & (out < 512)).all()


def test_scheduler_drains_variable_runs(pair, draft_pair):
    """The scheduler takes the variable accepted runs in order: served
    tokens equal each request's plain ``generate()``, and each finished
    request carries the engine's acceptance rate."""
    _, pm = pair
    _, pd = draft_pair
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, 512, (n,)) for n in (5, 9, 3, 12, 7)]
    base = _engine(pm, buckets=(8, 16))
    want = [base.generate(p[None], max_new_tokens=6)[0, len(p):].tolist() for p in prompts]
    for draft in (pm, pd):
        sched = ContinuousBatchingScheduler(_engine(pm, buckets=(8, 16), draft=draft, spec_k=3))
        rids = [sched.submit(p, max_new_tokens=6) for p in prompts]
        done = sched.run()
        assert [done[r].tokens for r in rids] == want
        assert all(done[r].spec_acceptance is not None for r in rids)


def test_spec_with_int8_kv_and_chunked_prefix_hit(pair, draft_pair):
    """Speculation composes with the int8 cache and with chunked prefill:
    the tokens are the plain int8 engine's; after a prefix-cache hit the
    draft cache is rebuilt for the matched chunks, row for row as a cold
    admission writes it."""
    _, pm = pair
    _, pd = draft_pair
    ids = np.random.default_rng(6).integers(0, 512, (2, 7))
    plain = _engine(pm, buckets=(8,), kv_dtype="int8").generate(ids, max_new_tokens=10)
    spec = _engine(pm, buckets=(8,), kv_dtype="int8", draft=pm, spec_k=3)
    np.testing.assert_array_equal(spec.generate(ids, max_new_tokens=10), plain)

    prompt = np.random.default_rng(7).integers(0, 512, (21,))
    kw = dict(max_batch_slots=1, max_seq_len=64, prefill_chunk=8, draft=pd, spec_k=2)
    want = _engine(pm, buckets=(32,)).generate(prompt[None], max_new_tokens=8)
    eng = DecodeEngine(pm, prefix_cache_mb=4.0, **kw)
    np.testing.assert_array_equal(eng.generate(prompt[None], max_new_tokens=8), want)
    cold_rows = eng._dck[:, 0, :, :16].clone()
    eng._dck.zero_()
    np.testing.assert_array_equal(eng.generate(prompt[None], max_new_tokens=8), want)
    assert eng.prefix_cache.hits == 1
    torch.testing.assert_close(eng._dck[:, 0, :, :16], cold_rows, atol=1e-6, rtol=0)

"""Fused decode (``DecodeEngine(fuse=D)`` / ``decode_step(fuse=D)``) of the
port against depth 1 and ``paddle_tpu``'s engine, on the CPU at
``GPTConfig.tiny()``.

Every depth gives depth 1's tokens, greedy and sampled (a sampled token's
generator depends on its request's seed and position only); one fused
call reads the device back once; the scheduler drains ``[D, B]`` stacks.
Greedy tokens are compared exactly. Mirrors ``tests/test_inference.py``'s
fused tests.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.inference import DecodeEngine as JDecodeEngine
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT

from paddle_tpu_torch.inference import ContinuousBatchingScheduler, DecodeEngine
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu

SAMPLE = dict(do_sample=True, temperature=0.9, top_k=40, top_p=0.95)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(41)
    jm = JGPT(JGPTConfig.tiny())
    jm.eval()
    pm = GPTForPretraining(GPTConfig.tiny(), device="cpu").eval()
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    return jm, pm


def _engine(m, **kw):
    return DecodeEngine(m, max_batch_slots=3, max_seq_len=64, prefill_buckets=(16,), **kw)


def test_fused_decode_equals_depth_one_and_paddle_tpu(pair):
    """Every depth gives depth 1's tokens and the reference's fused
    engine's, in at most ceil(N/D) + 1 decode calls for N tokens."""
    jm, pm = pair
    ids = np.random.default_rng(11).integers(0, 512, (3, 9))
    want = _engine(pm).generate(ids, max_new_tokens=16)
    ref = JDecodeEngine(jm, max_batch_slots=3, max_seq_len=64, prefill_buckets=(16,), fuse=4)
    np.testing.assert_array_equal(ref.generate(ids.astype(np.int32), max_new_tokens=16), want)
    for depth in (2, 4, 7):
        metrics.reset_counters("infer.")
        got = _engine(pm, fuse=depth).generate(ids, max_new_tokens=16)
        np.testing.assert_array_equal(got, want, err_msg=f"fuse={depth}")
        assert metrics.counters("infer.")["infer.decode_dispatches"] <= -(-16 // depth) + 1


def test_fused_decode_eos_stops_inside_the_window(pair):
    """eos reached in the middle of a fused window stops that row there;
    the other rows run on."""
    _, pm = pair
    ids = np.random.default_rng(2).integers(0, 512, (3, 7))
    probe = _engine(pm).generate(ids, max_new_tokens=12)
    eos = int(probe[0, 7 + 4])
    want = _engine(pm).generate(ids, max_new_tokens=12, eos_token_id=eos)
    assert (want[0, 7 + 4:] == eos).all()
    np.testing.assert_array_equal(_engine(pm, fuse=5).generate(ids, max_new_tokens=12,
                                                               eos_token_id=eos), want)


def test_fused_sampled_decode_equals_depth_one_and_generate(pair):
    """Sampled: depth D draws each token from the same (seed, position)
    generator as depth 1 and ``generate()``, so all three agree, per seed."""
    _, pm = pair
    ids = np.random.default_rng(6).integers(0, 512, (3, 8))
    want = _engine(pm, **SAMPLE).generate(ids, max_new_tokens=12, seed=5)
    for depth in (3, 8):
        got = _engine(pm, fuse=depth, **SAMPLE).generate(ids, max_new_tokens=12, seed=5)
        np.testing.assert_array_equal(got, want, err_msg=f"fuse={depth}")
    gen = pm.generate(torch.from_numpy(ids), max_new_tokens=12, seed=5, **SAMPLE).numpy()
    np.testing.assert_array_equal(want[0], gen[0])
    other = _engine(pm, fuse=3, **SAMPLE).generate(ids, max_new_tokens=12, seed=6)
    assert not np.array_equal(other, want)


@pytest.mark.parametrize("do_sample", [False, True])
def test_fused_call_reads_the_device_back_once(pair, monkeypatch, do_sample):
    """One ``decode_step(fuse=D)`` copies to the host once (one ``.cpu()``)
    and asks for no scalar (``item``, ``tolist``, ``bool``, ``int``), however
    many tokens it decodes."""
    _, pm = pair
    eng = _engine(pm, fuse=6, **(SAMPLE if do_sample else {}))
    for i, p in enumerate(np.random.default_rng(8).integers(0, 512, (3, 5))):
        eng.prefill(p, slot=i, max_new_tokens=20, seed=i)
    calls = {}
    for name in ("cpu", "item", "tolist", "__bool__", "__int__", "__index__", "numpy"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    toks, emitted, active = eng.decode_step()
    monkeypatch.undo()
    assert calls.get("cpu") == 1 and set(calls) <= {"cpu", "numpy"}, calls
    assert toks.shape == emitted.shape == (6, 3) and emitted.all() and active.all()


def test_scheduler_fused_drain_equals_unfused_and_paddle_tpu(pair):
    """The scheduler drains ``[D, B]`` stacks in order: chunked prefill,
    prefix reuse and fuse 3 together serve the bucketed, unfused tokens and
    the reference's, in fewer decode calls."""
    jm, pm = pair
    rng = np.random.default_rng(15)
    shared = rng.integers(0, 512, (8,))
    prompts = [np.concatenate([shared, rng.integers(0, 512, (n,))]) for n in (5, 9, 14)]

    def serve(make, **kw):
        sched = make(max_batch_slots=2, max_seq_len=64, **kw)
        rids = [sched.submit(p, max_new_tokens=7) for p in prompts]
        done = sched.run()
        return [list(done[r].tokens) for r in rids], sched

    def port(**kw):
        return ContinuousBatchingScheduler(DecodeEngine(pm, **kw))

    want, _ = serve(port, prefill_buckets=(32,))
    metrics.reset_counters("infer.")
    got, sched = serve(port, prefill_chunk=8, prefix_cache_mb=2.0, fuse=3)
    assert got == want
    assert metrics.counters("infer.")["infer.decode_dispatches"] <= 10
    assert [r.prefix_tokens for r in sorted(sched.finished.values(), key=lambda r: r.rid)] == [0, 0, 8]
    ref, _ = serve(lambda **kw: JScheduler(JDecodeEngine(jm, **kw)),
                   prefill_chunk=8, prefix_cache_mb=2.0, fuse=3)
    assert [[int(t) for t in r] for r in ref] == want

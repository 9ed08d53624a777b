"""The int8 KV cache (``kv_dtype="int8"``) and int8 weights (``int8=True``)
of the port's ``DecodeEngine`` against ``paddle_tpu``'s, on the CPU at
``GPTConfig.tiny()``.

``_kv_quantize`` and ``quant_abs_max`` give the reference's int8 payload on
the same numpy input (scales within 1e-7 relative); the round trip stays
within half a quantization step; under int8 KV bucketed, chunked and
prefix-hit prefill give the same tokens, and the reference's int8 engines
the same tokens as the port's. Mirrors ``tests/test_spec_decode.py``'s int8
tests and ``tests/test_inference.py``'s int8 weight test; the reference
engines are built with the default, empty ``FLAGS_compile_cache_dir``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import DecodeEngine as JDecodeEngine
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT

from paddle_tpu_torch.inference import DecodeEngine
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JGPT(JGPTConfig.tiny())
    jm.eval()
    pm = GPTForPretraining(GPTConfig.tiny(), device="cpu").eval()
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    return jm, pm


def test_kv_quantize_equals_paddle_tpu():
    """Same numpy input, same int8 payload; scales within 1e-7 relative
    (a zero row keeps the 1e-8 floor)."""
    from paddle_tpu.models.gpt import _kv_quantize as jquant
    from paddle_tpu_torch.models.gpt import _kv_quantize

    u = np.random.default_rng(1).normal(size=(3, 4, 5, 16)).astype(np.float32)
    u[0, 0, 0] = 0.0
    u[1, 2, 3] *= 1e4
    jq, js = jquant(u)
    q, s = _kv_quantize(torch.from_numpy(u))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and tuple(s.shape) == (3, 4, 5)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)


def test_kv_round_trip_within_half_a_step():
    """The dequantized value is within half a quantization step (the row's
    abs_max / 127) of the input."""
    from paddle_tpu_torch.models.gpt import _kv_dequant, _kv_quantize

    u = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 4, 16)).astype(np.float32))
    q, s = _kv_quantize(u)
    back = _kv_dequant({"q": q, "s": s}, torch.float32)
    step = u.abs().amax(dim=-1, keepdim=True) / 127.0
    assert bool(((back - u).abs() <= 0.5 * step + 1e-7).all())
    q0, s0 = _kv_quantize(torch.zeros(1, 3, 8))
    assert int(q0.abs().sum()) == 0 and bool(torch.isfinite(s0).all())


def test_quant_abs_max_equals_paddle_tpu():
    """Per tensor, per channel and per (layer, output channel) over an
    ``[L, in, out]`` stack: the reference's payload and scales."""
    from paddle_tpu.quantization import quant_abs_max as jquant
    from paddle_tpu_torch.quantization import quant_abs_max

    w = np.random.default_rng(2).normal(size=(2, 8, 6)).astype(np.float32)
    w[1, :, 3] = 0.0
    for axis in (None, 2, (0, 2)):
        q, s = quant_abs_max(torch.from_numpy(w), channel_axis=axis)
        jq, js = jquant(w, channel_axis=axis)
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s, js)
        assert np.abs(q * s - w).max() <= 0.5 * np.abs(w).max() / 127 + 1e-7


def test_int8_kv_shrinks_slot_bytes_and_keeps_tokens(pair):
    """int8 payload plus f32 per-row scales: per-slot bytes shrink
    4*dh/(dh+4) = 3.2x at dh 16; greedy tokens agree with the f32 engine's
    and equal the reference's int8 engine's."""
    jm, pm = pair
    ids = np.random.default_rng(2).integers(0, 512, (2, 9))
    kw = dict(max_batch_slots=2, max_seq_len=64, prefill_buckets=(16,))
    f32 = DecodeEngine(pm, **kw)
    i8 = DecodeEngine(pm, kv_dtype="int8", **kw)
    assert f32.kv_bytes_per_slot() / i8.kv_bytes_per_slot() == pytest.approx(3.2)
    a = f32.generate(ids, max_new_tokens=10)
    b = i8.generate(ids, max_new_tokens=10)
    assert (a == b).mean() >= 0.9
    ref = JDecodeEngine(jm, kv_dtype="int8", **kw)
    np.testing.assert_array_equal(ref.generate(ids.astype(np.int32), max_new_tokens=10), b)
    assert i8._ck["q"].dtype == torch.int8 and i8._ck["s"].dtype == torch.float32


def test_int8_kv_bucketed_chunked_and_prefix_hit_agree(pair):
    """Under int8 KV the serving paths are one family: bucketed == chunked
    == prefix-cache warm hit, and the prefix entries are stored as packs
    (payload plus scales, no f32 copy)."""
    jm, pm = pair
    prompt = np.random.default_rng(8).integers(0, 512, (19,))
    kw = dict(max_batch_slots=1, max_seq_len=64, kv_dtype="int8")
    want = DecodeEngine(pm, prefill_buckets=(32,), **kw).generate(prompt[None], max_new_tokens=8)
    np.testing.assert_array_equal(
        DecodeEngine(pm, prefill_chunk=8, **kw).generate(prompt[None], max_new_tokens=8), want)
    warm = DecodeEngine(pm, prefill_chunk=8, prefix_cache_mb=4.0, **kw)
    np.testing.assert_array_equal(warm.generate(prompt[None], max_new_tokens=8), want)
    assert warm.prefix_cache.stats()["entries"] == 2
    np.testing.assert_array_equal(warm.generate(prompt[None], max_new_tokens=8), want)
    assert warm.prefix_cache.hits == 1
    seg_k, _ = warm.prefix_cache.match(prompt, max_tokens=18)[0]
    assert set(seg_k) == {"q", "s"} and seg_k["q"].dtype == torch.int8
    assert warm.prefix_cache.bytes_used() / len(warm.prefix_cache) == warm.prefix_cache.entry_bytes
    ref = JDecodeEngine(jm, prefill_buckets=(32,), **kw)
    np.testing.assert_array_equal(ref.generate(prompt[None].astype(np.int32), max_new_tokens=8), want)


def test_int8_weights_equal_paddle_tpu(pair):
    """``int8=True`` stores qkv, out, ffn1 and ffn2 as int8 packs with
    per-layer x per-output-channel scales; the tokens track the f32
    engine's and equal the reference's int8 engine's."""
    jm, pm = pair
    ids = np.random.default_rng(3).integers(0, 512, (1, 6))
    kw = dict(max_batch_slots=1, max_seq_len=32, prefill_buckets=(8,))
    i8 = DecodeEngine(pm, int8=True, **kw)
    packs = [e for e in i8._params[0] if isinstance(e, dict)]
    assert len(packs) == 4 and all(e["q"].dtype == torch.int8 for e in packs)
    assert tuple(packs[0]["s"].shape) == (2, 1, 3 * 64)
    a = DecodeEngine(pm, **kw).generate(ids, max_new_tokens=8)
    b = i8.generate(ids, max_new_tokens=8)
    assert (a == b).mean() > 0.5
    ref = JDecodeEngine(jm, int8=True, **kw)
    np.testing.assert_array_equal(ref.generate(ids.astype(np.int32), max_new_tokens=8), b)

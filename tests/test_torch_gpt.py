"""GPT of the port (``paddle_tpu_torch.models.gpt``) against ``paddle_tpu``'s.

Weights are made by ``paddle_tpu`` from a seed and carried across by
``paddle_tpu_torch.utils.convert``; both packages get the same token ids from
a numpy seed. f32 throughout, on the CPU.

Tolerance for logits: atol 2e-5 / rtol 1e-5. Both sides compute in f32 with
the same formulas; they differ only in the order of the f32 sums inside the
matmuls, which moves logits of order 1 by a few 1e-7 per layer.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops import registry as jregistry

from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu

ATOL, RTOL = 2e-5, 1e-5


def _pair(seed=0, **cfg_kw):
    """A paddle_tpu GPT made from ``seed`` and the port's with its weights."""
    paddle.seed(seed)
    jcfg = JGPTConfig.tiny(**cfg_kw)
    jm = JGPT(jcfg)
    jm.eval()
    pm = GPTForPretraining(GPTConfig(**jcfg.to_dict()), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    return jm, pm.eval()


def _ids(shape, vocab=512, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_tiny_logits_match_paddle_tpu():
    jm, pm = _pair(seed=5)
    ids = _ids((2, 24))
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (2, 24, 512)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.fixture
def jax_flash_interpret():
    prior = jfa.set_interpret(True)
    saved = (jfa._BLOCK_Q, jfa._BLOCK_K)
    jfa._BLOCK_Q = jfa._BLOCK_K = 64  # < s: the Pallas kernel streams K/V tiles
    jregistry.clear_cache()
    registry.clear_cache()
    yield
    jfa.set_interpret(prior)
    jfa._BLOCK_Q, jfa._BLOCK_K = saved
    jregistry.clear_cache()
    registry.clear_cache()


def test_flash_width_logits_match_paddle_tpu(jax_flash_interpret):
    """hidden 128 / 2 heads (d = 64) at s = 256: the JAX forward runs
    ``attention_core``/``flash`` (the Pallas kernel, interpreted) and the
    port's forward picks ``attention_core``/``flash`` too (its plain version
    on the CPU)."""
    jm, pm = _pair(seed=6, hidden_size=128, num_heads=2, max_seq_len=256)
    ids = _ids((1, 256), seed=1)
    jmetrics.reset_counters("kernels.attention_core.")
    metrics.reset_counters("kernels.attention_core.")
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids).long()).numpy()
    assert jmetrics.counters("kernels.attention_core.")["kernels.attention_core.picked"] == 1
    assert metrics.counters("kernels.attention_core.") == {
        "kernels.attention_core.picked": 1, "kernels.attention_core.fallback": 0}
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_generate_greedy_tokens_match_paddle_tpu():
    jm, pm = _pair(seed=7)
    ids = _ids((2, 9), seed=2)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=12).numpy())
    got = pm.generate(ids, max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_eos_pads_and_sampling_is_seeded():
    _, pm = _pair(seed=8)
    ids = _ids((1, 6), seed=3)
    greedy = pm.generate(ids, max_new_tokens=8).numpy()
    eos = int(greedy[0, 7])  # the second generated token
    stopped = pm.generate(ids, max_new_tokens=8, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(stopped[0, :8], greedy[0, :8])
    assert (stopped[0, 8:] == eos).all()
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.8, top_k=40, top_p=0.9)
    a = pm.generate(ids, seed=11, **kw).numpy()
    np.testing.assert_array_equal(a, pm.generate(ids, seed=11, **kw).numpy())
    assert ((0 <= a) & (a < 512)).all()


def test_convert_checks_names_and_shapes():
    jm, _ = _pair(seed=9)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_paddle_tpu({k: v for k, v in state.items() if k != "gpt.layers.qkv_b"})
    with pytest.raises(KeyError, match="extra"):
        state_dict_from_paddle_tpu({**state, "gpt.layers.0.attn.qkv_proj.weight": state["gpt.layers.qkv_w"][0]})
    with pytest.raises(ValueError, match="out_w"):
        state_dict_from_paddle_tpu({**state, "gpt.layers.out_w": state["gpt.layers.out_w"].transpose(0, 2, 1)[:, :, :32]})


def test_unported_config_options_raise():
    # the per-layer trunk is ported (GPT-MoE needs it); recompute is not
    assert GPTConfig.tiny(stacked=False).stacked is False
    assert GPTConfig.tiny(moe=4).to_dict()["moe_num_experts"] == 4
    with pytest.raises(ValueError, match="stacked=False"):
        GPTConfig.tiny(moe_num_experts=4)
    with pytest.raises(NotImplementedError):
        GPTConfig.tiny(recompute=True)
    cfg = GPTConfig.gpt3_1p3b()
    assert (cfg.hidden_size, cfg.num_layers, cfg.max_seq_len) == (2048, 24, 2048)
    assert GPTConfig(**cfg.to_dict()).to_dict() == cfg.to_dict()

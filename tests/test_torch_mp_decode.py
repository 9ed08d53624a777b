"""GPT decoding at mp > 1 of the port against ``paddle_tpu``'s, on the CPU.

The case of ``tests/test_gpt.py:171-195``: the reference's tiny GPT
(``paddle.seed(3)``), ids ``[2, 8]`` from ``default_rng(0)``, greedy
``generate`` of 6 new tokens. The port decodes the same weights (carried
across by ``utils/convert.py``) in one process and at mp 2 as 2 gloo
ranks, each holding half the heads (its slice of the fused qkv, its
``[L, b, H / 2, S, dh]`` cache, its FFN rows) and half the vocabulary of
the tied head. Tokens are held bitwise: to the reference's single-device
decode and across the ranks. Decoding at pp > 1 raises, citing its
ROADMAP item, and the serving engine refuses an mp-sharded model.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models.gpt import GPTForPretraining as JGPT  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from torch_hybrid_reference import started  # noqa: E402
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining  # noqa: E402
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu  # noqa: E402

NEW = 6


@pytest.fixture(scope="module")
def reference():
    paddle.seed(3)
    jm = JGPT(JGPTConfig.tiny())
    ids = np.random.default_rng(0).integers(0, jm.gpt.cfg.vocab_size, (2, 8)).astype("int32")
    tokens = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=NEW).numpy())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    world = started(ranks.several, 2, [("gpt_mp_decode", (state, ids.astype(np.int64), NEW)),
                                       ("gpt_decode_refusals", ())])
    return dict(ids=ids, tokens=tokens, state=state, world=world)


def test_mp1_decode_matches_paddle_tpu(reference):
    pm = GPTForPretraining(GPTConfig.tiny(), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(reference["state"]))
    out = pm.eval().generate(torch.as_tensor(reference["ids"]), max_new_tokens=NEW)
    np.testing.assert_array_equal(out.numpy(), reference["tokens"])


def test_mp2_decode_tokens_bitwise_to_paddle_tpu_and_across_ranks(reference):
    outs = [r[0] for r in reference["world"].result()]
    for o in outs:
        assert o["heads"] == 2  # 4 heads over mp 2
        assert o["qkv"] == (2, 64, 96)  # each of q, k and v split on its own
        np.testing.assert_array_equal(o["tokens"], reference["tokens"])
    np.testing.assert_array_equal(outs[0]["tokens"], outs[1]["tokens"])


def test_decoding_at_pp2_raises_and_the_engine_refuses_mp(reference):
    refusals = reference["world"].result()[0][1]
    assert refusals["pp"].startswith("NotImplementedError")
    assert "13c" in refusals["pp"] and "pipeline" in refusals["pp"]
    assert refusals["engine_mp"].startswith("ValueError") and "never meshes" in refusals["engine_mp"]

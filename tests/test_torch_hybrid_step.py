"""The hybrid step of the port against ``paddle_tpu``'s GSPMD step, on the
CPU: BASELINE #4's mesh (``bench_1p3b.py:25-60``: sdp 2 x mp 2 x pp 2,
ZeRO stage 2, 2 micro-batches, ``1f1b``), dp 2 x mp 2 x pp 2 and dp 2 x
mp 2 x sep 2 (``tests/test_pipeline_moe_ring.py:150-185``'s world, at
hidden 256 with 4 heads so each rank keeps a head after mp and sep, 2
steps), each as 8 gloo ranks against the reference's 8-device step; GPT
at mp 2 alone;
ERNIE at dp 2 x mp 2 (its ``BertLayer`` trunk has no pipeline).

GPT: ``GPTConfig.tiny(hidden_size=128, num_heads=2)`` (d 64, so the
attention goes through the flash kernels' module, one head a rank at mp
2) at 4 layers, ids ``[8, 16]``, AdamW lr 1e-3, 3 steps
(``tests/torch_hybrid_reference.py``). ERNIE:
``ErnieConfig.tiny(hidden_size=256, num_heads=4, max_seq_len=64)`` (d 64,
2 heads a rank at mp 2), 2 layers, ids ``[4, 32]`` with every second MLM
label -100 (so each dp rank's loss averages the same count) and random
SOP labels, AdamW lr 1e-4, 3 steps. Tolerances: losses rtol 1e-5, each
parameter after the steps within a relative L2 error of 2e-5 (the key
third of a qkv bias within the steps' reach), moments likewise. ERNIE's
zero-initialised biases are held to the steps' reach, 2 lr a step, not
to 2e-5: AdamW moves an entry whose gradient sits within f32 noise of 0
by about lr times the sign of that noise, and at this config the
reference's own dp 2 x mp 2 step differs from its one-device step there
by up to 9.9e-2 relative L2 (``qkv_proj.bias``), 1.7e-3
(``layers.1.attn.out_proj.bias``) and 6.9e-5 (``layers.1.ffn1.bias``),
measured on the CPU; its weights by at most 2.8e-6.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed.fleet import fleet as jfleet  # noqa: E402
from paddle_tpu.distributed.strategy import DistributedStrategy as JStrategy  # noqa: E402
from paddle_tpu.models.ernie import ErnieConfig as JErnieConfig  # noqa: E402
from paddle_tpu.models.ernie import ErnieForPretraining as JErnie  # noqa: E402
from paddle_tpu.models.ernie import ErniePretrainingCriterion as JErnieCriterion  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from torch_hybrid_reference import (IDS, LOSS_RTOL, assert_close, gathered,  # noqa: E402
                                    reference_gpt, started)
from paddle_tpu_torch.models.ernie import ErnieConfig  # noqa: E402
from paddle_tpu_torch.utils.convert import gather_state  # noqa: E402

BASE = dict(lr=1e-3, steps=3, layers=4, cfg=dict(hidden_size=128, num_heads=2))
BASELINE4 = dict(BASE, sdp=2, mp=2, pp=2, stage=2, accumulate=2, schedule="1f1b")
DP_MP_PP = dict(BASE, dp=2, mp=2, pp=2, accumulate=2)
MP2 = dict(BASE, mp=2)
# tests/test_pipeline_moe_ring.py:150-185's world, dp 2 x mp 2 x sep 2, for 2
# steps: 4 heads of d 64, so each rank holds 2 (mp) and attends over 1 (sep)
DP_MP_SEP = dict(BASE, dp=2, mp=2, sep=2, steps=2, cfg=dict(hidden_size=256, num_heads=4))
ERNIE_CFG = dict(hidden_size=256, num_heads=4, max_seq_len=64)
EB, ES, ELR, ESTEPS = 4, 32, 1e-4, 3


@pytest.fixture(autouse=True)
def reference_fleet_reset():
    prior = jfleet._hcg
    jfleet._hcg = None
    yield
    jfleet._hcg = prior


@pytest.fixture(scope="module")
def worlds():
    """This file's worlds of 8, 4 (ERNIE) and 2 ranks, queued in the
    background; the tests compute the reference's steps while they run."""
    initial = reference_gpt(steps=0, cfg=BASE["cfg"])[0]
    inputs, labels = _ernie_batch()
    paddle.seed(7)
    ernie = {k: np.asarray(v.numpy()) for k, v in JErnie(JErnieConfig.tiny(**ERNIE_CFG))
             .state_dict().items()}
    sep_state = reference_gpt(steps=0, cfg=DP_MP_SEP["cfg"])[0]
    return {8: started(ranks.gpt_hybrid, 8, [DP_MP_PP, BASELINE4, dict(DP_MP_SEP, state=sep_state)],
                       initial, IDS),
            4: started(ranks.ernie_steps, 4, 2, 2, ERNIE_CFG, ernie, inputs, labels, ESTEPS, ELR),
            2: started(ranks.gpt_hybrid, 2, [MP2], initial, IDS), "ernie_state": ernie}


def _config(worlds, world, i):
    return [o[i] for o in worlds[world].result()]


def _ernie_batch():
    rng = np.random.default_rng(50)
    ids = rng.integers(0, 512, (EB, ES)).astype(np.int64)
    mlm = ids.copy()
    mlm[:, ::2] = -100
    return (ids,), (mlm, rng.integers(0, 2, (EB,)).astype(np.int64))


def _check(worlds, world, i, c):
    _, losses, params, moments = reference_gpt(**c)
    outs = _config(worlds, world, i)
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=LOSS_RTOL)
        # the kernel module runs: the stacked trunk's attention_core picks its flash impl
        assert o["picked"].get("kernels.attention_core.picked", 0) >= 1
        assert o["picked"].get("kernels.attention_core.fallback", 0) == 0
    dims = outs[0]["sdp_dims"]
    reach = 2 * c["lr"] * c["steps"] + 1e-7
    assert_close(gathered(outs, "state"), params, what="params", reach=reach)
    for k in ("m", "v"):
        assert_close(gathered(outs, k, sdp_dims=dims), moments[k], what=k)
    for dp_rank in range(1, c.get("dp", 1)):  # the dp replicas hold the same model
        other = gathered(outs, "state", dp_rank=dp_rank)
        for name, v in gathered(outs, "state").items():
            np.testing.assert_array_equal(other[name], v)
    return outs


def test_dp2_mp2_pp2_matches_paddle_tpu(worlds):
    _check(worlds, 8, 0, DP_MP_PP)


def test_baseline4_sdp2_mp2_pp2_zero2_1f1b_matches_paddle_tpu(worlds):
    """BASELINE #4's mesh at tiny width: 8 ranks, each holding half the
    heads of its stage's 2 layers and a vocabulary half of the tied table
    (the last stage's copy summed with the first's), ZeRO-2 over sdp, 1F1B
    over 2 micro-batches."""
    outs = _check(worlds, 8, 1, BASELINE4)
    for o in outs:
        pp_rank = o["coord"][1]
        assert o["state"]["gpt.layers.qkv_w"].shape == (2, 128, 192)  # 2 layers, mp 2
        assert ("gpt.embeddings.position_embeddings.weight" in o["state"]) == (pp_rank == 0)
        assert ("gpt.final_norm.weight" in o["state"]) == (pp_rank == 1)
        assert o["peak_held"] == 2 - pp_rank
        assert o["counters"]["collective.reduce_scatter.calls"] > 0
    # the tied table's two copies are equal after the steps
    first = [o for o in outs if o["coord"][1] == 0]
    last = [o for o in outs if o["coord"][1] == 1]
    for a in first:
        b = next(o for o in last if o["coord"][2:] == a["coord"][2:])
        np.testing.assert_array_equal(a["state"]["gpt.embeddings.word_embeddings.weight"],
                                      b["state"]["gpt.embeddings.word_embeddings.weight"])


def test_dp2_mp2_sep2_matches_paddle_tpu(worlds):
    """The reference's hybrid sep world (``tests/test_pipeline_moe_ring.py:150-185``):
    8 ranks, each with 2 of the 4 heads, a vocabulary half of the tied
    table and its quarter of the batch's sequence block."""
    outs = _check(worlds, 8, 2, DP_MP_SEP)
    for o in outs:
        assert o["state"]["gpt.layers.qkv_w"].shape == (4, 256, 384)
        assert o["counters"]["collective.alltoall.calls"] > 0


def test_gpt_mp2_matches_paddle_tpu(worlds):
    for o in _check(worlds, 2, 0, MP2):
        assert o["state"]["gpt.layers.qkv_w"].shape == (4, 128, 192)
        assert o["state"]["gpt.embeddings.word_embeddings.weight"].shape == (256, 128)


def test_ernie_dp2_mp2_matches_paddle_tpu(worlds):
    state = worlds["ernie_state"]
    inputs, labels = _ernie_batch()
    strat = JStrategy()
    strat.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 1, "sharding_degree": 1}
    jfleet.init(is_collective=True, strategy=strat, devices=jax.devices()[:4])
    paddle.seed(7)
    jm = JErnie(JErnieConfig.tiny(**ERNIE_CFG))
    crit = JErnieCriterion()
    step = jfleet.distributed_step(
        jm, paddle.optimizer.AdamW(learning_rate=ELR, parameters=jm.parameters()),
        lambda outs, mlm, sop: crit(outs[0], outs[1], mlm, sop))
    ids, mlm, sop = jfleet.shard_batch(*(paddle.to_tensor(a) for a in inputs + labels))
    losses = [float(step((ids,), (mlm, sop))["loss"].numpy()) for _ in range(ESTEPS)]
    params = {n: np.asarray(v, np.float32) for n, v in step.state["params"].items()}
    jfleet._hcg = None
    outs = worlds[4].result()
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=LOSS_RTOL)
        assert o["heads"] == 2
        assert o["picked"].get("kernels.sdpa.picked", 0) >= 1
    got = gather_state([o["state"] for o in outs if o["dp_rank"] == 0],
                       ErnieConfig.tiny(**ERNIE_CFG))
    zero = {n for n, v in state.items() if not v.any()}
    assert zero and all(n.endswith("bias") for n in zero)
    for n in zero:
        np.testing.assert_array_less(np.abs(got[n] - params[n]), 2 * ELR * ESTEPS)
    assert_close({n: v for n, v in got.items() if n not in zero},
                 {n: v for n, v in params.items() if n not in zero}, what="ernie")

"""``fleet.distributed_step`` of the port against ``paddle_tpu``'s, on the CPU.

The reference compiles one GSPMD step over a mesh of dp x mp CPU devices
(``fleet.init(strategy, devices=jax.devices()[:dp * mp])``); the port runs
dp x mp gloo processes (:func:`paddle_tpu_torch.testing.dist.run_ranks`),
each loading its mp shard of the reference's weights
(``utils.convert.shard_state``) and feeding its ``shard_batch`` block.
``BertConfig.tiny()`` (h 64, 4 heads, 2 layers, vocab 512) on a global
batch ``[4, 32]`` with padding masks, AdamW lr 1e-3, 6 steps, f32,
``FLAGS_flash_flat`` off on both sides (the flat kernels' modules are held
by ``tests/test_torch_flash_flat.py``).

Every rank's loss averages the same number of labelled tokens (the first 8
of every row), so the port's dp mean of the ranks' losses is the global
batch's mean; ``test_unequal_label_counts_weigh_ranks_equally`` pins what
happens when they differ.

Tolerances, f32: losses rtol 1e-5; each parameter after the steps within a
relative L2 error of 2e-5 of the reference's, the tolerance the port holds
whole AdamW steps to (``tests/test_torch_optimizer.py``): Adam divides each
gradient by its own RMS, so the f32 rounding of sums in another order
carries into the update undamped. The reference's own 6 steps at dp 2 x
mp 2 differ from its single-device steps by up to 8.1e-6 (``pooler.bias``,
``layers.1.norm1.bias``; measured on the CPU), the port's from the
reference's by up to 1.1e-5. The exception is the key part of the
qkv bias: its gradient is 0 in exact arithmetic (softmax ignores a constant
added to every key's score), so AdamW's first steps move each entry by
about lr times the sign of f32 noise on either side; it is held to the
steps' reach, 2 lr per step.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
from paddle_tpu.distributed.fleet import fleet as jfleet  # noqa: E402
from paddle_tpu.distributed.strategy import DistributedStrategy as JStrategy  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.models.bert import BertConfig as JBertConfig  # noqa: E402
from paddle_tpu.models.bert import BertForPretraining as JBert  # noqa: E402
from paddle_tpu.models.bert import BertPretrainingCriterion as JCriterion  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from paddle_tpu_torch.models.bert import BertConfig  # noqa: E402
from paddle_tpu_torch.testing.dist import run_ranks  # noqa: E402
from paddle_tpu_torch.utils.convert import gather_state  # noqa: E402

B, S, LABELLED = 4, 32, 8
STEPS, LR = 6, 1e-3
LOSS_RTOL = 1e-5
PARAM_REL_L2 = 2e-5


@pytest.fixture(autouse=True)
def reference_fleet_reset():
    """Each test starts the reference with no fleet mesh and leaves none
    (a mesh left set makes its mp layers shard later modules' steps)."""
    prior = jfleet._hcg
    jfleet._hcg = None
    yield
    jfleet._hcg = prior


def _batch(counts=None):
    """ids, token types, positions ``[B, S]``, the additive padding mask
    ``[B, 1, S, S]``, MLM labels (the first ``counts[b]`` tokens of row b,
    the rest -100) and NSP labels."""
    rng = np.random.default_rng(40)
    counts = counts or [LABELLED] * B
    ids = rng.integers(0, 512, (B, S)).astype(np.int32)
    lengths = np.array([S, 20, 27, S])
    keep = np.arange(S)[None, None, None, :] < lengths[:, None, None, None]
    mask = np.broadcast_to(np.where(keep, 0.0, -1e30), (B, 1, S, S)).astype(np.float32)
    mlm = np.full((B, S), -100, np.int64)
    for b, n in enumerate(counts):
        mlm[b, :n] = rng.integers(0, 512, n)
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return (ids, np.zeros((B, S), np.int32), pos, mask), (mlm, nsp)


def _reference_model(seed):
    paddle.seed(seed)
    jm = JBert(JBertConfig.tiny())
    return jm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _loss_fn(crit):
    def loss_fn(outs, mlm, nsp):
        return crit(outs[0], outs[1], mlm, nsp)
    return loss_fn


def _reference_steps(dp, mp, seed, clip=None):
    strat = JStrategy()
    strat.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": 1, "sharding_degree": 1}
    jfleet.init(is_collective=True, strategy=strat, devices=jax.devices()[:dp * mp])
    jm, state = _reference_model(seed)
    grad_clip = None if clip is None else paddle.nn.ClipGradByGlobalNorm(clip_norm=clip)
    opt = paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters(), grad_clip=grad_clip)
    step = jfleet.distributed_step(jm, opt, _loss_fn(JCriterion()))
    inputs, labels = _batch()
    placed = jfleet.shard_batch(*(paddle.to_tensor(a) for a in inputs + labels))
    losses = [float(step(tuple(placed[:4]), tuple(placed[4:]))["loss"].numpy()) for _ in range(STEPS)]
    params = {n: np.asarray(v, np.float32) for n, v in step.state["params"].items()}
    return state, losses, params


def _assert_params_close(got, want):
    H = JBertConfig.tiny().hidden_size
    for name, w in want.items():
        g = got[name]
        if name.endswith("attn.qkv_proj.bias"):
            np.testing.assert_array_less(np.abs(g[H:2 * H] - w[H:2 * H]), 2 * LR * STEPS + 1e-7)
            g, w = np.concatenate([g[:H], g[2 * H:]]), np.concatenate([w[:H], w[2 * H:]])
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= PARAM_REL_L2, (name, err)


def _run_port(dp, mp, state, clip=None):
    inputs, labels = _batch()
    out = run_ranks(ranks.bert_steps, dp * mp, dp, mp, {}, state, inputs, labels, STEPS, LR, clip)
    return out, gather_state([o["state"] for o in out if o["dp_rank"] == 0], BertConfig.tiny())


def test_dp2_step_matches_paddle_tpu():
    state, jlosses, jparams = _reference_steps(2, 1, seed=41)
    out, params = _run_port(2, 1, state)
    for o in out:
        np.testing.assert_allclose(o["losses"], jlosses, rtol=LOSS_RTOL)
        assert o["reducer_buckets"] == 1  # the tiny model's 0.8 MB fits one 25 MB bucket
    for name in params:  # the dp ranks hold the same parameters
        np.testing.assert_array_equal(out[1]["state"][name], params[name])
    _assert_params_close(params, jparams)
    assert jlosses[-1] < jlosses[0]


def test_dp2_mp2_step_with_binding_clip_matches_paddle_tpu():
    """dp 2 x mp 2 over 4 ranks, with a global-norm clip of 1.0 that binds
    (the first step's whole gradient norm, the shards' squares all-reduced
    over mp and each replicated parameter counted once, is above it)."""
    clip = 1.0
    state, jlosses, jparams = _reference_steps(2, 2, seed=42, clip=clip)
    out, params = _run_port(2, 2, state, clip=clip)
    for o in out:
        assert o["seeded_shards"]  # a model from a seed holds the one-rank model's shards
        np.testing.assert_allclose(o["losses"], jlosses, rtol=LOSS_RTOL)
    # the reference's whole norm of the first step's gradient (its eager
    # backward over the global batch, from the same weights)
    jfleet._hcg = None
    jm, _ = _reference_model(seed=42)
    inputs, labels = _batch()
    loss = _loss_fn(JCriterion())(jm(*(paddle.to_tensor(a) for a in inputs)),
                                  *(paddle.to_tensor(a) for a in labels))
    loss.backward()
    jnorm = float(np.sqrt(sum(float((np.asarray(p.grad.numpy(), np.float64) ** 2).sum())
                              for p in jm.parameters())))
    assert jnorm > 2 * clip
    for o in out:
        np.testing.assert_allclose(o["clip_norm"], jnorm, rtol=1e-5)
    _assert_params_close(params, jparams)


def test_unequal_label_counts_weigh_ranks_equally():
    """Ranks holding different numbers of labelled tokens: the port's loss
    is the mean of the ranks' means, the reference's the global batch's.
    They differ by exactly the count weighting of the MLM terms."""
    counts = [8, 8, 2, 1]  # rank 0's rows label 16 tokens, rank 1's 3
    inputs, labels = _batch(counts)
    jm, state = _reference_model(seed=43)
    # the reference's per-token MLM and per-row NSP cross entropy over the
    # global batch, and its criterion over it
    mlm_logits, nsp_logits = jm(*(paddle.to_tensor(a) for a in inputs))
    mlm_lab, nsp_lab = (paddle.to_tensor(a) for a in labels)
    jglobal = float(JCriterion()(mlm_logits, nsp_logits, mlm_lab, nsp_lab).numpy())
    tok = np.asarray(jF.cross_entropy(mlm_logits, mlm_lab, reduction="none", ignore_index=-100).numpy())
    tok = tok.reshape(B, S) * (labels[0] != -100)
    row_nsp = np.asarray(jF.cross_entropy(nsp_logits, nsp_lab, reduction="none").numpy()).reshape(B)
    n0, n1 = sum(counts[:2]), sum(counts[2:])
    m0, m1 = tok[:2].sum() / n0, tok[2:].sum() / n1
    np.testing.assert_allclose(jglobal, (n0 * m0 + n1 * m1) / (n0 + n1) + row_nsp.mean(), rtol=1e-5)
    out = run_ranks(ranks.bert_steps, 2, 2, 1, {}, state, inputs, labels, 1, LR, None)
    got = out[0]["losses"][0]
    np.testing.assert_allclose(got, (m0 + m1) / 2 + row_nsp.mean(), rtol=1e-5)
    # f32 losses of about 7 differ from their sums by a few 2**-24 relative
    np.testing.assert_allclose(got - jglobal, (m0 + m1) / 2 - (n0 * m0 + n1 * m1) / (n0 + n1),
                               atol=2e-6)
    assert abs(got - jglobal) > 1e-3


def test_dist_matches_single_device():
    """The reference's ``test_dist_matches_single_device`` at dp 2: one SGD
    step of a ``Linear(16, 4)`` on an MSE loss through ``distributed_step``
    and ``shard_batch`` equals the reference's single-device step."""
    paddle.seed(3)
    net = paddle.nn.Linear(16, 4)
    w0, b0 = np.asarray(net.weight.numpy()).copy(), np.asarray(net.bias.numpy()).copy()
    rng = np.random.default_rng(44)
    x, y = rng.standard_normal((8, 16)).astype(np.float32), rng.standard_normal((8, 4)).astype(np.float32)
    step = JTrainStep(net, paddle.optimizer.SGD(learning_rate=0.1), paddle.nn.MSELoss())
    jloss = float(step(x, y)["loss"].numpy())
    out = run_ranks(ranks.linear_dist_step, 2, w0, b0, x, y, 0.1)
    for w, b, loss in out:
        np.testing.assert_allclose(w, np.asarray(step.state["params"]["weight"]), atol=1e-5)
        np.testing.assert_allclose(b, np.asarray(step.state["params"]["bias"]), atol=1e-5)
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)


def test_strategy_knobs_and_refusals():
    """What ``distributed_step`` consumes and refuses: sharding sets the
    ZeRO stage and ``offload`` keeps its state on the host, float16 AMP raises with
    the reference's message, ``comm_overlap=False`` warns,
    ``gradient_merge`` sets the micro-batches and ``recompute`` the remat;
    ``save_inference_model`` raises (14)."""
    errors = run_ranks(ranks.strategy_errors, 1)[0]
    assert errors["sharding"] == "stage 2"
    assert errors["offload"] == "stage 1 offload"
    assert errors["fp16"].startswith("ValueError") and "loss scaling" in errors["fp16"]
    assert errors["warned"] and errors["knobs"] == (2, True, None)
    assert "item 14" in errors["save_inference_model"]

"""Dropout of the port at model, sequence, pipeline and expert parallel
degrees above 1, against ``paddle_tpu``'s CPU mesh and against the
one-process port.

The reference's models are one program under GSPMD, so a rank's mask is
its part of the mask the one-device program draws. Both sides get the
same masks, as in ``tests/test_torch_dropout.py``: numpy makes one keep
mask per draw of the GLOBAL shape; the reference takes them in draw order
through a ``monkeypatch`` of ``jax.random.bernoulli`` (inside its jitted
step, so a step's draws are constants that its second step uses again);
each port rank takes them by the seed of the generator it draws from
(``torch_dist_ranks.masked``), the global shape along the model axes
(the port's own :func:`~paddle_tpu_torch.framework.random.site_mask`
slices it) and its rows along a data axis (the global mask is the
concatenation of the data ranks' masks). Under the reference's pipeline
the stage function is traced once, so every layer and micro-batch of a
step takes the same three site masks; the port's table maps each
(micro-batch, global layer, site) name to them, and the seeds a stage
draws show that stage 1 folds layers 2 and 3, not stage 0's 0 and 1.

Tolerances: those of ``tests/torch_hybrid_reference.py`` (losses rtol
1e-5, parameters 2e-5 relative L2; the key third of a qkv bias within the
steps' reach). The port-only checks run real masks: the mp 2 x sep 2 and
mp 2 x pp 2 (1F1B) worlds against the one-process port from the same seed
(losses rtol 1e-5, parameters 2e-5; the pipeline's losses bitwise), the
parameters that are replicated over mp bitwise equal on both mp ranks,
a recomputed pipeline step bitwise equal to the one without recompute,
and a resume at mp 2 x pp 2 bitwise.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed.fleet import fleet as jfleet  # noqa: E402
from paddle_tpu.distributed.strategy import DistributedStrategy as JStrategy  # noqa: E402
from paddle_tpu.models.bert import BertConfig as JBertConfig  # noqa: E402
from paddle_tpu.models.bert import BertForPretraining as JBert  # noqa: E402
from paddle_tpu.models.bert import BertPretrainingCriterion as JBertCriterion  # noqa: E402
from paddle_tpu.models.ernie import ErnieConfig as JErnieConfig  # noqa: E402
from paddle_tpu.models.ernie import ErnieForPretraining as JErnie  # noqa: E402
from paddle_tpu.models.ernie import ErniePretrainingCriterion as JErnieCriterion  # noqa: E402
from paddle_tpu.ops import moe_pallas as jmp  # noqa: E402
from paddle_tpu.ops import registry as jregistry  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402
from torch_hybrid_reference import (IDS, LOSS_RTOL, REL_L2, assert_close, gathered,  # noqa: E402
                                    reference_gpt, started)
from paddle_tpu_torch.framework import random as R  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models.bert import BertConfig  # noqa: E402
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.utils.convert import gather_state  # noqa: E402

P = 0.1
CFG = dict(dropout=P, attn_dropout=P)
LR, STEPS, LAYERS = 1e-3, 2, 4
B, S, D, H = 8, 16, 64, 4  # IDS and GPTConfig.tiny()
REACH = 2 * LR * STEPS + 1e-7
GPT = dict(cfg=CFG, lr=LR, steps=STEPS)
DP_MP = dict(GPT, dp=2, mp=2)
MP_SEP = dict(GPT, mp=2, sep=2)
MP_PP = dict(GPT, mp=2, pp=2, schedule="1f1b", accumulate=2)
# GPT-MoE, every block MoE, its experts over the data axis
MOE = dict(cfg=dict(moe=4, moe_every=1, moe_capacity_factor=0.5, **CFG), layers=2, moe=True,
           lr=LR, steps=STEPS)
# BERT and ERNIE: 2 layers, a mask after the embeddings and on both residuals
EB, ES = 4, 32
ENC_CFG = dict(dropout=P)


def _seed(key):
    return key & ((1 << 63) - 1)


def _masks(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.random(s) < 1.0 - P for s in shapes]


def _stack_shapes(b=B, layers=LAYERS):
    return [(b, S, D)] + [(b, H, S, S), (b, S, D), (b, S, D)] * layers


def _stacked_table(masks, dp=1):
    """The port's seeds of a stacked GPT step at pp 1 (the embeddings' key,
    then the trunk's, folded by layer and site) mapped to the rank's rows of
    the reference's masks, for each step and data rank."""
    table, n = {}, B // dp
    for step in range(STEPS):
        for r in range(dp):
            key = R.step_key(0, step, None, r if dp > 1 else None)
            rows = slice(r * n, (r + 1) * n)
            table[_seed(R.fold_in(key, 1))] = masks[0][rows]
            trunk = R.fold_in(key, 2)
            for layer in range(LAYERS):
                for site in range(3):
                    table[_seed(R.fold_in(trunk, layer, site))] = masks[1 + 3 * layer + site][rows]
    return table


def _pipeline_table(masks, n_micro=2):
    """The same under the pipeline: micro-batch i's stream, its rows
    ``i::n_micro`` of the embeddings' mask, and the one mask of each site
    that the reference's traced stage takes at every layer. Also the seeds
    of each stage's layers."""
    table, stage_seeds = {}, {0: set(), 1: set()}
    for step in range(STEPS):
        for i in range(n_micro):
            key = R.step_key(0, step, i, None)
            table[_seed(R.fold_in(key, 1))] = masks[0][i::n_micro]
            trunk = R.fold_in(key, 2)
            for layer in range(LAYERS):
                for site in range(3):
                    s = _seed(R.fold_in(trunk, layer, site))
                    table[s] = masks[1 + site]
                    stage_seeds[layer * 2 // LAYERS].add(s)
    return table, stage_seeds


def _draw_table(masks, dp=1, b=B):
    """Seeds of a model whose sites split a key each, in call order (the
    per-layer trunk, BERT, ERNIE), for each step and data rank."""
    table, n = {}, b // dp
    for step in range(STEPS):
        for r in range(dp):
            key = R.step_key(0, step, None, r if dp > 1 else None)
            for k, m in enumerate(masks):
                table[_seed(R.fold_in(key, k + 1))] = m[r * n:(r + 1) * n]
    return table


def _moe_shapes():
    return [(B, S, D)] + [(B, H, S, S), (B, S, D), (B, S, D)] * MOE["layers"]


def _enc_batch():
    rng = np.random.default_rng(51)
    ids = rng.integers(0, 512, (EB, ES)).astype(np.int64)
    mlm = ids.copy()
    mlm[:, ::2] = -100
    return ids, mlm, rng.integers(0, 2, (EB,)).astype(np.int64)


def _bert_inputs():
    ids, mlm, nsp = _enc_batch()
    pos = np.broadcast_to(np.arange(ES, dtype=np.int32), (EB, ES)).copy()
    mask = np.zeros((EB, 1, ES, ES), np.float32)
    return (ids.astype(np.int32), np.zeros((EB, ES), np.int32), pos, mask), (mlm, nsp)


GPT_MASKS = {"dp_mp": _masks(_stack_shapes(), 1), "mp_sep": _masks(_stack_shapes(), 2),
             "mp_pp": _masks([(B, S, D), (B // 2, H, S, S), (B // 2, S, D), (B // 2, S, D)], 3),
             "moe": _masks(_moe_shapes(), 4)}
ENC_MASKS = {"bert": _masks([(EB, ES, 64)] * 5, 5), "ernie": _masks([(EB, ES, 64)] * 5, 6)}


@pytest.fixture(autouse=True)
def reference_fleet_reset():
    prior = jfleet._hcg
    jfleet._hcg = None
    yield
    jfleet._hcg = prior


@pytest.fixture(scope="module")
def interpret():
    prior = jmp.set_interpret(True)
    jregistry.clear_cache()
    yield
    jmp.set_interpret(prior)
    jregistry.clear_cache()


@pytest.fixture(scope="module")
def worlds(interpret, tmp_path_factory):
    """The worlds of 4 and 2 ranks, queued in the background while the
    tests compute the reference's steps."""
    initial = reference_gpt(steps=0, layers=LAYERS, cfg=CFG)[0]
    moe_initial = reference_gpt(**dict(MOE, steps=0))[0]
    paddle.seed(7)
    bert = {k: np.asarray(v.numpy()) for k, v in JBert(JBertConfig.tiny(**ENC_CFG))
            .state_dict().items()}
    paddle.seed(7)
    ernie = {k: np.asarray(v.numpy()) for k, v in JErnie(JErnieConfig.tiny(**ENC_CFG))
             .state_dict().items()}
    pipe, stage_seeds = _pipeline_table(GPT_MASKS["mp_pp"])
    real = [MP_SEP, MP_PP, dict(MP_PP, cfg=dict(CFG, recompute=True))]
    four = [("masked", (_stacked_table(GPT_MASKS["dp_mp"], dp=2), "gpt_hybrid", [DP_MP],
                        initial, IDS)),
            ("masked", (_stacked_table(GPT_MASKS["mp_sep"]), "gpt_hybrid", [MP_SEP], initial,
                        IDS)),
            ("masked", (pipe, "gpt_hybrid", [MP_PP], initial, IDS)),
            ("gpt_hybrid", (real, initial, IDS)),
            ("dropout_resume", (MP_PP, initial, IDS, str(tmp_path_factory.mktemp("ck")), 2))]
    inputs, labels = _bert_inputs()
    ids, mlm, sop = _enc_batch()
    two = [("masked", (_draw_table(ENC_MASKS["bert"], b=EB), "bert_steps", 1, 2, ENC_CFG, bert,
                       inputs, labels, STEPS, LR)),
           ("masked", (_draw_table(ENC_MASKS["ernie"], b=EB), "ernie_steps", 1, 2, ENC_CFG,
                       ernie, (ids,), (mlm, sop), STEPS, LR)),
           ("masked", (_draw_table(GPT_MASKS["moe"], dp=2), "gpt_moe",
                       [dict(dp=2, experts=4, state=moe_initial, cfg=dict(
                           moe_capacity_factor=0.5, **CFG), steps=STEPS)], IDS))]
    return {4: started(ranks.several, 4, four), 2: started(ranks.several, 2, two),
            "initial": initial, "bert": bert, "ernie": ernie, "stage_seeds": stage_seeds}


def _fed(monkeypatch, masks):
    """The reference's draws fed ``masks`` in order; the list of shapes drawn."""
    drawn = []

    def feed(key, p, shape):
        want = masks[len(drawn)]
        drawn.append(tuple(shape))
        assert want.shape == tuple(shape), (want.shape, tuple(shape))
        return jnp.asarray(want)

    monkeypatch.setattr(jax.random, "bernoulli", feed)
    return drawn


def _job(worlds, world, i):
    """Job ``i``'s results by rank: ``(result, seeds drawn)`` for a masked job."""
    return [o[i] for o in worlds[world].result()]


def _check_gpt(outs, want, dp=1):
    _, losses, params, _ = want
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=LOSS_RTOL)
    assert_close(gathered(outs, "state"), params, what="params", reach=REACH)
    for dp_rank in range(1, dp):  # the dp replicas hold the same model
        other = gathered(outs, "state", dp_rank=dp_rank)
        for name, v in gathered(outs, "state").items():
            np.testing.assert_array_equal(other[name], v)


@pytest.mark.parametrize("job,config,key", [(0, DP_MP, "dp_mp"), (1, MP_SEP, "mp_sep")],
                         ids=["dp2_mp2", "mp2_sep2"])
def test_gpt_stacked_trunk_matches_reference_with_global_masks(worlds, monkeypatch, job, config,
                                                               key):
    """The stacked trunk at dp 2 x mp 2 (each data rank its rows; the mp
    ranks the whole residual masks after the reduce, their heads of the
    attention mask) and at mp 2 x sep 2 (the residual masks' sequence
    blocks, the attention mask's heads after ``seq_to_heads``) trains to
    the reference's losses and parameters with the same global masks."""
    drawn = _fed(monkeypatch, GPT_MASKS[key])
    want = reference_gpt(**dict(config, layers=LAYERS))
    assert len(drawn) == len(GPT_MASKS[key])  # one trace: step 2 takes step 1's masks
    outs = _job(worlds, 4, job)
    _check_gpt([o[0][0] for o in outs], want, dp=config.get("dp", 1))
    for o in outs:
        assert len(o[1]) == STEPS * len(GPT_MASKS[key])


def test_gpt_pipeline_matches_reference_and_folds_global_layers(worlds, monkeypatch):
    """At mp 2 x pp 2 through 1F1B with 2 micro-batches: the reference's
    losses and parameters with its masks; each micro-batch's stream is its
    own (stage 0's embeddings take the micro-batch's rows of the global
    mask), and stage 1's layers draw under the global indices 2 and 3, not
    stage 0's (their seeds are disjoint and each stage's are its layers')."""
    drawn = _fed(monkeypatch, GPT_MASKS["mp_pp"])
    want = reference_gpt(**dict(MP_PP, layers=LAYERS))
    assert drawn == [(B, S, D), (B // 2, H, S, S), (B // 2, S, D), (B // 2, S, D)]
    outs = _job(worlds, 4, 2)
    _check_gpt([o[0][0] for o in outs], want)
    stages = worlds["stage_seeds"]
    assert not stages[0] & stages[1]
    for o in outs:
        trunk = set(o[1]) & (stages[0] | stages[1])
        assert trunk == stages[o[0][0]["coord"][1]]  # coord: (dp, pp, sdp, mp, sep)


def _one_process(initial, accumulate):
    model = GPTForPretraining(GPTConfig.tiny(num_layers=LAYERS, **CFG), device="cpu", seed=0)
    model.load_state_dict({k: torch.tensor(v) for k, v in initial.items()})
    step = TrainStep(model, AdamW(learning_rate=LR, parameters=model.parameters()),
                     GPTPretrainingCriterion(), accumulate_steps=accumulate)
    x = torch.from_numpy(IDS)
    losses = [float(step(x, x)["loss"]) for _ in range(STEPS)]
    return losses, {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("config", [0, 1], ids=["mp2_sep2", "mp2_pp2_1f1b"])
def test_worlds_train_like_one_process_with_real_masks(worlds, config):
    """With real masks (attention dropout on, so the heads' slice is used),
    the mp 2 x sep 2 world trains like one process from the same seed, and
    the mp 2 x pp 2 world like one process accumulating 2 micro-batches
    (its losses bitwise; the tied word table's two gradients are summed in
    another order); the parameters that are
    replicated over mp are bitwise equal on both mp ranks."""
    outs = [o[config] for o in _job(worlds, 4, 3)]
    losses, params = _one_process(worlds["initial"], 1 if config == 0 else 2)
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=LOSS_RTOL)
    if config == 1:
        assert all(o["losses"] == losses for o in outs)
    assert_close(gathered(outs, "state"), params, tol=REL_L2, what="params")
    replicated = [n for n in params if n.startswith("gpt.layers.")
                  and n.rsplit(".", 1)[1] in ("norm1_w", "norm1_b", "out_b", "norm2_w", "norm2_b",
                                              "ffn2_b")]
    assert len(replicated) == 6
    pairs = [(o, p) for o in outs for p in outs if _only_mp_differs(o, p)]
    assert len(pairs) == 4
    for o, p in pairs:
        for n in replicated:
            if n in o["state"]:
                np.testing.assert_array_equal(o["state"][n], p["state"][n], err_msg=n)


def _only_mp_differs(o, p):
    """Whether two ranks' coordinates ``(dp, pp, sdp, mp, sep)`` differ in
    mp alone."""
    a, b = o["coord"], p["coord"]
    return a[3] != b[3] and a[:3] + a[4:] == b[:3] + b[4:]


def test_pipeline_recompute_is_bitwise(worlds):
    """With every block recomputed at mp 2 x pp 2 (1F1B), the losses and
    parameters are bitwise those without recompute: each recompute
    re-derives its micro-batch's masks, in whatever order 1F1B runs them."""
    plain, again = ([o[i] for o in _job(worlds, 4, 3)] for i in (1, 2))
    for a, b in zip(plain, again):
        assert a["losses"] == b["losses"]
        for n, v in a["state"].items():
            np.testing.assert_array_equal(b["state"][n], v, err_msg=n)


def test_resume_at_mp2_pp2_is_bitwise(worlds):
    """A step restored from a checkpoint at mp 2 x pp 2 takes the later
    steps' losses and parameters bitwise (the state names the masks)."""
    for o in _job(worlds, 4, 4):
        assert o["resumed"] == o["later"]
        for n, v in o["state"].items():
            np.testing.assert_array_equal(o["resumed_state"][n], v, err_msg=n)


def _reference_encoder(monkeypatch, which, worlds):
    strat = JStrategy()
    strat.hybrid_configs = {"dp_degree": 1, "mp_degree": 2, "pp_degree": 1, "sharding_degree": 1}
    jfleet.init(is_collective=True, strategy=strat, devices=jax.devices()[:2])
    drawn = _fed(monkeypatch, ENC_MASKS[which])
    paddle.seed(7)
    if which == "bert":
        jm, crit = JBert(JBertConfig.tiny(**ENC_CFG)), JBertCriterion()
        inputs, labels = _bert_inputs()
    else:
        jm, crit = JErnie(JErnieConfig.tiny(**ENC_CFG)), JErnieCriterion()
        ids, mlm, sop = _enc_batch()
        inputs, labels = (ids,), (mlm, sop)
    step = jfleet.distributed_step(
        jm, paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters()),
        lambda outs, a, b: crit(outs[0], outs[1], a, b))
    placed = jfleet.shard_batch(*(paddle.to_tensor(a) for a in inputs + labels))
    n = len(inputs)
    losses = [float(step(tuple(placed[:n]), tuple(placed[n:]))["loss"].numpy())
              for _ in range(STEPS)]
    assert len(drawn) == len(ENC_MASKS[which])
    return losses, {k: np.asarray(v, np.float32) for k, v in step.state["params"].items()}


@pytest.mark.parametrize("which,job", [("bert", 0), ("ernie", 1)])
def test_encoder_at_mp2_matches_reference_with_same_masks(worlds, monkeypatch, which, job):
    """BERT and ERNIE at mp 2: every site (after the embeddings' LayerNorm,
    after each row-parallel reduce and its bias) is replicated over mp, so
    both ranks draw the whole mask; losses and parameters are the
    reference's with the same masks."""
    losses, params = _reference_encoder(monkeypatch, which, worlds)
    outs = _job(worlds, 2, job)
    for o in outs:
        np.testing.assert_allclose(o[0]["losses"], losses, rtol=LOSS_RTOL)
        assert len(o[1]) == STEPS * len(ENC_MASKS[which])
    cfg = BertConfig.tiny(**ENC_CFG)
    got = gather_state([o[0]["state"] for o in outs], cfg)
    assert_close(got, params, what="params", reach=REACH)


def test_gpt_moe_at_ep2_matches_reference_with_same_masks(worlds, monkeypatch):
    """GPT-MoE with its experts over the data axis at 2: each data rank
    draws its rows' masks (the data rank folded into its stream), which
    together are the reference's global masks."""
    drawn = _fed(monkeypatch, GPT_MASKS["moe"])
    _, losses, params, _ = reference_gpt(dp=2, **MOE)
    assert len(drawn) == len(GPT_MASKS["moe"])
    outs = [o[0][0] for o in _job(worlds, 2, 2)]
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=LOSS_RTOL)
    got = gather_state({(0, 0, 0, o["dp_rank"]): o["state"] for o in outs})
    # zero-initialised biases: an entry whose gradient is f32 noise moves by
    # AdamW's sign of it (one entry of moe.b2 here, by 7.3e-6); each entry is
    # held to the steps' reach and the rest to the parameters' tolerance
    zero = {n for n in params if n.endswith("bias") or n.endswith(".b1") or n.endswith(".b2")}
    for n in zero:
        np.testing.assert_array_less(np.abs(got[n] - params[n]), REACH, err_msg=n)
    assert_close({n: v for n, v in got.items() if n not in zero},
                 {n: v for n, v in params.items() if n not in zero}, what="params", reach=REACH)

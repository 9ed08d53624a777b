"""Expert parallelism of the port against ``paddle_tpu``'s GSPMD step, on the CPU.

The reference builds every GPT-MoE block with ``MoELayer``'s default
``expert_axis="dp"`` (``paddle_tpu/models/gpt.py:237-241``): under
``fleet.distributed_step`` at dp > 1 its expert weights are ``P("dp", ...)``
and its routing sees the global batch (the capacity from the global token
count, queue positions in global arrival order, the aux loss over global
means). The port runs one gloo process per rank; each holds ``E / dp``
experts and routes as the reference does (``paddle_tpu_torch/distributed/moe.py``).

The model: ``GPTConfig.tiny(moe=E, moe_every=1, moe_capacity_factor=0.5)``
at 2 layers (every block MoE, top-2 GShard), ids ``[8, 16]``, AdamW lr
1e-3, 3 steps, from the weights the reference made (``utils/convert.py``'s
``shard_state`` gives each rank its experts). GShard's random routing draws
from threefry in the reference and from the layer's generator in the port,
so it is off on both sides for the parity tests; with it on, the port's
world of n is held against its own world of one (the jitter draws over
the global tokens and each rank takes its slice). The reference's MoE
kernels run through the Pallas interpreter, as ``tests/test_torch_moe.py``
runs them.

Tolerances (``tests/torch_hybrid_reference.py``): losses rtol 1e-5; each
parameter after the steps within a relative L2 error of 2e-5 (the key
third of a qkv bias within the steps' reach, 2 lr a step), but the
zero-initialised biases, held to 1e-4: AdamW moves them by about lr a step
from 0, so f32 noise in their small gradients weighs more, and the port's
own one-process step is already 2.3e-5 from the reference's one-device
step on layer 0's ``moe.b2`` (6e-6 on the other biases; the reference's
dp 2 step is 4e-7 from its one-device step there), measured on the CPU.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from paddle_tpu.ops import moe_pallas as jmp  # noqa: E402
from paddle_tpu.ops import registry as jregistry  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from torch_hybrid_reference import (IDS, LOSS_RTOL, assert_close, reference_gpt,  # noqa: E402
                                    started)

LR, STEPS = 1e-3, 3
# capacity factor 0.5: experts overflow, so which pairs a rank keeps
# depends on the lower ranks' pairs (at the tiny default 1.25 nothing
# overflows, and per-rank routing came within 2e-7 of the reference's loss)
CF = dict(moe_capacity_factor=0.5)
MOE4 = dict(cfg=dict(moe=4, moe_every=1, **CF), layers=2, moe=True, lr=LR, steps=STEPS)
MOE8 = dict(MOE4, cfg=dict(moe=8, moe_every=1, **CF))
CLIP = 0.05  # binding: the tiny model's gradient norm is about 1
INITIAL = {}  # the reference's initial state by number of experts


@pytest.fixture(scope="module")
def interpret():
    prior = jmp.set_interpret(True)
    jregistry.clear_cache()
    yield
    jmp.set_interpret(prior)
    jregistry.clear_cache()


@pytest.fixture(scope="module")
def worlds(interpret):
    """The worlds of 2 and 4 ranks, queued in the background while the
    tests compute the reference's steps."""
    s4 = reference_gpt(**dict(MOE4, steps=0))[0]
    s8 = reference_gpt(**dict(MOE8, steps=0))[0]
    INITIAL.update({4: s4, 8: s8})
    two = [("gpt_moe", ([dict(dp=2, experts=4, state=s4, cfg=CF),
                         dict(dp=2, experts=4, state=s4, cfg=CF, clip=CLIP),
                         dict(dp=2, experts=4, seed=5, jitter=True),
                         dict(dp=2, experts=4, state=s4, cfg=CF, meta=True, steps=1)], IDS)),
           ("expert_exchange", (EXCHANGE[2], 3)),
           ("moe_refusals", ())]
    four = [("gpt_moe", ([dict(dp=4, experts=8, state=s8, cfg=CF)], IDS)),
            ("expert_exchange", (EXCHANGE[4], 2))]
    return {2: started(ranks.several, 2, two), 4: started(ranks.several, 4, four)}


def _gathered(outs):
    from paddle_tpu_torch.utils.convert import gather_state

    return gather_state({(0, 0, 0, o["dp_rank"]): o["state"] for o in outs})


ZERO_INIT_REL_L2 = 1e-4


def _check(outs, want, initial):
    _, losses, params, _ = want
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=LOSS_RTOL)
        # the CPU's plain grouped FFN (K4/K4b's plain versions) takes the call
        assert o["picked"] == {"kernels.moe.picked": 1, "kernels.moe.fallback": 0}
        assert o["counters"]["collective.all_gather.calls"] > 0
    got = _gathered(outs)
    zero = {n for n, v in initial.items() if not v.any() and not n.endswith("qkv_proj.bias")}
    assert zero and all(n.endswith("bias") or n.endswith(".b1") or n.endswith(".b2")
                        for n in zero)
    assert_close({n: got[n] for n in zero}, {n: params[n] for n in zero}, tol=ZERO_INIT_REL_L2,
                 what="zero-initialised biases")
    assert_close({n: v for n, v in got.items() if n not in zero},
                 {n: v for n, v in params.items() if n not in zero}, what="params",
                 reach=2 * LR * STEPS + 1e-7)


def test_gpt_moe_dp2_routes_globally_as_paddle_tpu(worlds):
    """The fault this slice closes: at dp 2 each rank routed its own tokens
    at half the capacity and took its own aux loss, and the reducer
    averaged the experts as if replicated. Now each rank holds 2 of the 4
    experts and the step is the reference's GSPMD step."""
    outs = [o[0][0] for o in worlds[2].result()]
    assert [o["state"]["gpt.layers.0.moe.w1"].shape for o in outs] == [(2, 64, 256)] * 2
    _check(outs, reference_gpt(dp=2, **MOE4), INITIAL[4])


def test_gpt_moe_ep4_eight_experts_matches_paddle_tpu(worlds):
    outs = [o[0][0] for o in worlds[4].result()]
    assert {o["state"]["gpt.layers.1.moe.w2"].shape for o in outs} == {(2, 256, 64)}
    _check(outs, reference_gpt(dp=4, **MOE8), INITIAL[8])


def test_global_norm_clip_sums_the_expert_shards(worlds):
    """A binding global-norm clip: each rank's expert shard's squares are
    summed over the expert group, each replicated weight counted once."""
    outs = [o[0][1] for o in worlds[2].result()]
    _check(outs, reference_gpt(dp=2, clip=CLIP, **MOE4), INITIAL[4])


def test_world_of_two_matches_world_of_one_with_jitter_on(worlds):
    """GShard's random routing on: the port's world of 2 draws over the
    global tokens and each rank takes its slice, so it steps as the
    port's own one-process step from the same seed."""
    import torch

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForPretraining(GPTConfig.tiny(moe=4, moe_every=1), device="cpu", seed=5)
    assert all(blk.moe.gate.random_routing for blk in model.gpt.layers)
    step = TrainStep(model, AdamW(learning_rate=LR, parameters=model.parameters()),
                     GPTPretrainingCriterion())
    ids = torch.from_numpy(IDS)
    losses = [float(step(ids, ids)["loss"]) for _ in range(STEPS)]
    outs = [o[0][2] for o in worlds[2].result()]
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=LOSS_RTOL)
    want = {k: v.numpy() for k, v in model.state_dict().items()}
    assert_close(_gathered(outs), want, what="world 1", reach=2 * LR * STEPS + 1e-7)


def test_meta_build_loads_its_experts(worlds):
    """A rank built on the meta device holds only its experts' shapes and
    steps as one built with its weights."""
    outs = [o[0][3] for o in worlds[2].result()]
    first = [o[0][0] for o in worlds[2].result()]
    for o, f in zip(outs, first):
        assert o["losses"] == f["losses"][:1]


# ``counts[r][j * ne + i]``: the rows rank r sends to expert i of rank j
EXCHANGE = {2: np.array([[2, 0, 1, 3], [1, 2, 0, 4]]),
            4: np.array([[1, 0, 2, 1, 0, 0, 3, 1], [0, 2, 1, 1, 2, 0, 0, 0],
                         [1, 1, 1, 1, 1, 1, 1, 1], [0, 0, 0, 0, 0, 3, 0, 2]])}


def _exchange_expected(counts, width, r):
    """Rank r's rows received, expert-major and in sending-rank order
    within an expert, as Paddle's ``global_scatter`` orders them."""
    n = counts.shape[0]
    ne = counts.shape[1] // n
    sent = []
    for src in range(n):
        rows = int(counts[src].sum())
        x = 1000.0 * src + np.arange(rows * width, dtype=np.float32).reshape(rows, width)
        starts = np.concatenate([[0], np.cumsum(counts[src])])
        sent.append((x, starts))
    out = []
    for i in range(ne):
        for src in range(n):
            x, starts = sent[src]
            e = r * ne + i
            out.append(x[starts[e]:starts[e + 1]])
    return np.concatenate(out)


@pytest.mark.parametrize("world", [2, 4])
def test_global_scatter_and_gather_follow_the_count_contract(worlds, world):
    width = {2: 3, 4: 2}[world]
    counts = EXCHANGE[world]
    for r, res in enumerate(o[1] for o in worlds[world].result()):
        np.testing.assert_array_equal(res["recv"], _exchange_expected(counts, width, r))
        rows = int(counts[r].sum())
        x = 1000.0 * r + np.arange(rows * width, dtype=np.float32).reshape(rows, width)
        # gather is scatter's inverse, and each one's backward is the other
        np.testing.assert_array_equal(res["back"], 2.0 * x)
        np.testing.assert_array_equal(res["grad"], 2.0 * np.repeat(
            np.arange(1.0, rows + 1, dtype=np.float32)[:, None], width, axis=1))
        mismatch, mismatch_gather, uneven = res["errors"]
        assert "count mismatch" in mismatch and "count mismatch" in mismatch_gather
        assert f"do not split over a group of {world}" in uneven


def test_expert_parallelism_refuses_what_it_cannot_hold(worlds):
    refusals = worlds[2].result()[0][2]
    assert "13c" in refusals["zero"] and "ZeRO" in refusals["zero"]
    assert "13c" in refusals["mp"] and "model" in refusals["mp"]
    assert "fleet.init" in refusals["replicated"]
    assert "13c" in refusals["sep"]


def test_global_scatter_in_a_world_of_one_passes_rows_through():
    """The reference's single-controller contract (``tests/test_api_tail2.py:201-207``)."""
    import torch

    from paddle_tpu_torch.distributed import utils

    x = torch.ones(4, 2)
    lc = torch.tensor([2, 2])
    assert utils.global_scatter(x, lc, lc) is x and utils.global_gather(x, lc, lc) is x
    with pytest.raises(ValueError, match="count mismatch"):
        utils.global_scatter(x, torch.tensor([1, 1]), lc)
    with pytest.raises(ValueError, match="count mismatch"):
        utils.global_scatter(x, torch.tensor([1, 3]), lc)

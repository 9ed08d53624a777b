"""The pipeline of the port (``distributed/pipeline.py``) against
``paddle_tpu``'s, on the CPU.

The reference pipelines its stacked GPT trunk inside one SPMD program
(``spmd_pipeline``); the port runs one gloo process per stage, each
holding its segment's layers, and drives GPipe's or 1F1B's schedule with
point-to-point sends. Held against the reference's
``fleet.distributed_step`` (``tests/test_pipeline_pp.py``'s
``test_pp4_matches_pp1`` analog: ``GPTConfig.tiny()`` at 4 layers, ids
``[8, 16]``, AdamW lr 1e-3, 3 steps) at pp 2 and pp 4, with
``tests/torch_hybrid_reference.py``'s tolerances; ``PipelineLayer``,
``SegmentLayers``, ``LayerDesc`` and ``SharedLayerDesc`` against
``tests/test_pipeline_pp.py:136-170`` and
``tests/test_pipeline_moe_ring.py:45-68``'s cases. One world of 2 and one
of 4 run every config of this file.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed.fleet import fleet as jfleet  # noqa: E402
from paddle_tpu.distributed.pipeline import LayerDesc as JLayerDesc  # noqa: E402
from paddle_tpu.distributed.pipeline import PipelineLayer as JPipelineLayer  # noqa: E402
from paddle_tpu.distributed.pipeline import SegmentLayers as JSegmentLayers  # noqa: E402
from paddle_tpu.distributed.strategy import DistributedStrategy as JStrategy  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from torch_hybrid_reference import (IDS, LOSS_RTOL, REL_L2, assert_close, gathered,  # noqa: E402
                                    reference_gpt, started)
from paddle_tpu_torch.distributed import pipeline as P  # noqa: E402

BASE = dict(lr=1e-3, steps=3, layers=4)
PP2 = [dict(BASE, pp=2, accumulate=4), dict(BASE, pp=2, accumulate=4, schedule="1f1b"),
       dict(BASE, pp=2, accumulate=1)]
PP2_MASK = dict(BASE, pp=2, accumulate=2)
PP4 = [dict(BASE, pp=4, accumulate=8), dict(BASE, pp=4, accumulate=8, schedule="1f1b")]
# rows 0, 2, 4, 6 (micro-batch 0 of 2) keep all 16 tokens, the others 4
MASK = np.ones((8, 16), np.float32)
MASK[1::2, 4:] = 0.0
LINEAR_LR = 0.5


@pytest.fixture(autouse=True)
def reference_fleet_reset():
    prior = jfleet._hcg
    jfleet._hcg = None
    yield
    jfleet._hcg = prior


def _linears(n, d, seed):
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((d, d)) * 0.3).astype(np.float32),
             (rng.standard_normal(d) * 0.1).astype(np.float32)) for _ in range(n)]


X16 = np.random.default_rng(2).normal(size=(8, 16)).astype(np.float32)
X8 = np.random.default_rng(3).normal(size=(4, 8)).astype(np.float32)
SHARED = tuple(a for w, b in _linears(2, 8, 5) for a in (w, b))


@pytest.fixture(scope="module")
def worlds():
    """This file's worlds of 2 and 4 ranks, queued in the background; the
    tests compute the reference's steps while they run."""
    initial = reference_gpt(steps=0)[0]
    return {2: started(ranks.several, 2, [
                ("gpt_hybrid", (PP2, initial, IDS)),
                ("gpt_hybrid", ([PP2_MASK], initial, IDS, MASK)),
                ("pipeline_layers", (_linears(2, 8, 4), X8, LINEAR_LR, SHARED))]),
            4: started(ranks.several, 4, [
                ("gpt_hybrid", (PP4, initial, IDS)),
                ("pipeline_layers", (_linears(4, 16, 6), X16, LINEAR_LR))])}


def _check(outs, ref, c, tol=REL_L2):
    _, losses, params, moments = ref
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=LOSS_RTOL)
    assert_close(gathered(outs, "state"), params, tol=tol, what="params",
                 reach=2 * c["lr"] * c["steps"] + 1e-7)
    for k in ("m", "v"):
        assert_close(gathered(outs, k), moments[k], tol=tol, what=k)


@pytest.fixture(scope="module")
def pp2_reference():
    return reference_gpt(**PP2[0])


def test_pp2_gpipe_and_1f1b_match_paddle_tpu(worlds, pp2_reference):
    """pp 2 over 4 micro-batches, GPipe and 1F1B, against the reference's
    pipeline; the two schedules give equal steps (each stage adds its
    micro-batches' gradients in one order)."""
    gpipe, f1b = ([o[0][i] for o in worlds[2].result()] for i in range(2))
    _check(gpipe, pp2_reference, PP2[0])
    _check(f1b, pp2_reference, PP2[1])
    for a, b in zip(gpipe, f1b):
        np.testing.assert_array_equal(a["losses"], b["losses"])
        for name in a["state"]:
            np.testing.assert_array_equal(a["state"][name], b["state"][name])
    assert gpipe[0]["order"] == [("F", i) for i in range(4)] + [("B", i) for i in range(4)]
    assert f1b[0]["order"] == [("F", 0), ("F", 1), ("B", 0), ("F", 2), ("B", 1), ("F", 3),
                               ("B", 2), ("B", 3)]
    assert f1b[1]["order"] == [x for i in range(4) for x in (("F", i), ("B", i))]


def test_pp4_gpipe_and_1f1b_match_paddle_tpu(worlds):
    ref = reference_gpt(**PP4[0])
    for i, c in enumerate(PP4):
        _check([o[0][i] for o in worlds[4].result()], ref, c)


def test_1f1b_holds_at_most_pp_minus_s_stage_inputs(worlds):
    """Stage s of a 1F1B pipeline holds at most ``pp - s`` micro-batches'
    stage inputs at once (here exactly, with more micro-batches than
    stages); GPipe holds all of them."""
    for pp in (2, 4):
        for o in worlds[pp].result():
            gpipe, f1b = o[0][0], o[0][1]
            s = gpipe["coord"][1]
            assert gpipe["peak_held"] == gpipe["n_micro"]
            assert f1b["peak_held"] == pp - s <= f1b["n_micro"]


def test_default_micro_batches_and_unknown_schedule(worlds, pp2_reference):
    """``accumulate_steps`` 1 gives ``2 pp`` micro-batches (the reference's
    ``active_pipeline_plan``); an unknown schedule raises ``ValueError``."""
    default = [o[0][2] for o in worlds[2].result()]
    assert all(o["n_micro"] == 4 for o in default)
    _check(default, pp2_reference, PP2[2])
    from paddle_tpu_torch.distributed import DistributedStrategy
    from paddle_tpu_torch.distributed.fleet import fleet

    prior = fleet._strategy
    fleet._strategy = DistributedStrategy()
    fleet._strategy.pipeline_configs.schedule = "zigzag"
    try:
        with pytest.raises(ValueError, match="schedule"):
            P.active_pipeline_schedule()
    finally:
        fleet._strategy = prior
    with pytest.raises(ValueError, match="schedule"):
        P.run_schedule(None, None, 2, "zigzag", None, 0, 2, {}, "cpu")
    assert P.active_pipeline_plan() == (None, 1)


def test_loss_mask_weighs_micro_batches_by_their_tokens(worlds):
    """Micro-batches of unequal masked token counts (64 and 16): the last
    stage weighs each one's masked mean by its share of the batch's count,
    so the step's loss is the batch's masked mean, as the reference's.

    The parameters are held to a relative L2 error of 5e-5, not 2e-5:
    under this mask ``ffn1_b`` (zero at the start, its masked gradient
    partly cancelling) is ill-conditioned in f32. Measured on the CPU: the
    port's one-process step (no pipeline) is already 3.4e-5 from the
    reference's one-device step there, the port's pp-2 step 3.9e-6 from
    the port's one-process step, and the reference's own pp-2 step 9.1e-6
    from its one-device step; every other parameter is below 7e-6."""
    ref = reference_gpt(**PP2_MASK, mask=MASK)
    outs = [o[1][0] for o in worlds[2].result()]
    _check(outs, ref, PP2_MASK, tol=5e-5)
    assert [MASK[i::2].sum() for i in range(2)] == [64.0, 16.0]  # the micro-batches' counts


def test_segment_layers_and_pipeline_layer_match_paddle_tpu(worlds):
    """``SegmentLayers``'s bounds; a ``PipelineLayer`` of 4 ``Linear``s at
    pp 4 (one a stage) and of 2 at pp 2: the pipelined output and one SGD
    step on ``mean(out ** 2)`` against the reference's ``PipelineLayer``
    (its output, and its gradients through ``backward``)."""
    descs = [P.LayerDesc(object) for _ in range(10)]
    assert P.SegmentLayers(descs, 4).do_segment() == \
        JSegmentLayers([JLayerDesc(object) for _ in range(10)], 4).do_segment() == [0, 3, 6, 8, 10]
    for n, d, seed, x in ((4, 16, 6, X16), (2, 8, 4, X8)):
        weights = _linears(n, d, seed)
        strat = JStrategy()
        strat.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": n,
                                "sharding_degree": 1}
        strat.pipeline_configs = {"accumulate_steps": 2}
        jfleet.init(is_collective=True, strategy=strat, devices=jax.devices()[:n])
        pl = JPipelineLayer(layers=[JLayerDesc(paddle.nn.Linear, d, d) for _ in range(n)],
                            num_stages=n)
        for layer, (w, b) in zip(pl.built, weights):
            layer.weight.set_value(w)
            layer.bias.set_value(b)
        out = pl(paddle.to_tensor(x))
        loss = paddle.mean(out ** 2)
        loss.backward()
        for o in (r[-1] for r in worlds[n].result()):
            np.testing.assert_allclose(o["out"], np.asarray(out.numpy()), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(o["loss"], float(loss.numpy()), rtol=1e-5)
            assert o["segments"] == list(range(n + 1))
            (w1, b1), = o["layers"]
            layer = pl.built[o["stage"]]
            w, b = weights[o["stage"]]
            np.testing.assert_allclose(w1, w - LINEAR_LR * np.asarray(layer.weight.grad.numpy()),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(b1, b - LINEAR_LR * np.asarray(layer.bias.grad.numpy()),
                                       rtol=1e-5, atol=1e-6)
        jfleet._hcg = None


def test_shared_layer_desc_sums_the_tied_gradient(worlds):
    """A ``SharedLayerDesc`` on the first stage and its tied use on the
    last (``forward_func``): both stages hold the weight, its gradient is
    the sum of both uses, and after an SGD step the copies agree with one
    process's step of the same model (torch autograd on the CPU)."""
    ws, bs, wm, bm = (torch.from_numpy(a).requires_grad_() for a in SHARED)
    x = torch.from_numpy(X8)
    out = ((x @ ws + bs) @ wm + bm) @ ws.T
    loss = (out ** 2).mean()
    loss.backward()
    want = (ws - LINEAR_LR * ws.grad).detach().numpy()
    a, b = (o[-1] for o in worlds[2].result())
    assert a["tied_segments"] == [0, 2, 3]
    np.testing.assert_allclose(a["tied_loss"], float(loss), rtol=1e-5)
    for o in (a, b):
        np.testing.assert_allclose(o["tied_weight"], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(a["tied_weight"], b["tied_weight"])

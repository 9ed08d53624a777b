"""ZeRO sharding of the port (``distributed/sharding.py``) against
``paddle_tpu``'s, on the CPU.

The reference's stages are ``PartitionSpec`` policies over its ``sdp``
mesh axis (``build_state_specs``); the port's are a partition plan run by
hand over gloo processes (:func:`paddle_tpu_torch.testing.dist.run_ranks`):
stage 1 updates each rank's blocks of the whole averaged gradients, stage
2 reduce-scatters the split gradients, stage 3 holds the parameters as
blocks and gathers them layer by layer. Each is held against the
reference's ``fleet.distributed_step`` on its CPU mesh at sdp 2 and at dp 2
x sdp 2: ``GPTConfig.tiny()`` at 4 layers, ids ``[8, 16]`` with labels =
ids, AdamW lr 1e-3, 3 steps, as ``tests/test_pipeline_pp.py:42-54`` builds
it; Lamb and a binding global-norm clip at sdp 2 x mp 2. The tolerances
are ``tests/torch_hybrid_reference.py``'s (losses rtol 1e-5, parameters
and moments after the steps within a relative L2 error of 2e-5). One world
of 2 and one of 4 run every config of this file.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed.fleet import fleet as jfleet  # noqa: E402
from paddle_tpu.distributed.sharding import build_state_specs  # noqa: E402
from paddle_tpu.distributed.topology import HybridCommunicateGroup as JHCG  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from torch_hybrid_reference import (IDS, LOSS_RTOL, assert_close, gathered,  # noqa: E402
                                    reference_gpt, started)
from paddle_tpu_torch.distributed.sharding import MIN_SIZE, partition_dim  # noqa: E402

BASE = dict(lr=1e-3, steps=3, layers=4)
WORLD2 = [dict(BASE, sdp=2, stage=s) for s in (1, 2, 3)]
WORLD4 = [dict(BASE, dp=2, sdp=2, stage=s) for s in (1, 2, 3)]
#: each stage of WORLD2 again with its optimizer state offloaded to the host
OFFLOAD = [dict(c, offload=True) for c in WORLD2]
#: stage 2 for two steps, then three under the guard with NaN gradients at
#: dispatch 1, without and with offload
GUARD = [dict(WORLD2[1], steps=2), dict(WORLD2[1], nan_at=1),
         dict(WORLD2[1], nan_at=1, offload=True)]
CLIP = 0.3
LAMB = dict(BASE, sdp=2, mp=2, stage=2, optimizer="lamb", clip=CLIP)


@pytest.fixture(autouse=True)
def reference_fleet_reset():
    prior = jfleet._hcg
    jfleet._hcg = None
    yield
    jfleet._hcg = prior


@pytest.fixture(scope="module")
def worlds():
    """This file's worlds of 2 and 4 ranks, queued in the background; each
    test computes the reference's steps while they run."""
    initial = reference_gpt(steps=0)[0]
    return {2: started(ranks.several, 2, [("gpt_hybrid", (WORLD2 + OFFLOAD + GUARD, initial, IDS)),
                                          ("sharding_levels", ())]),
            4: started(ranks.gpt_hybrid, 4, WORLD4 + [LAMB], initial, IDS)}


def _world4(worlds, i):
    return [o[i] for o in worlds[4].result()]


def _check(outs, c, ref=None):
    _, losses, params, moments = ref or reference_gpt(**c)
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=LOSS_RTOL)
    dims = outs[0]["sdp_dims"]
    assert_close(gathered(outs, "state", sdp_dims=dims if c.get("stage") == 3 else None), params,
                 what="params", reach=2 * c["lr"] * c["steps"] + 1e-7)
    for k in ("m", "v"):
        assert_close(gathered(outs, k, sdp_dims=dims), moments[k], what=k)
    if c.get("dp", 1) > 1:  # the dp replicas hold the same model
        for name, v in gathered(outs, "state", dp_rank=1, sdp_dims=dims if c.get("stage") == 3
                                else None).items():
            np.testing.assert_array_equal(v, gathered(outs, "state", sdp_dims=dims if
                                                      c.get("stage") == 3 else None)[name])
    assert losses[-1] < losses[0]


def test_partition_plan_matches_build_state_specs(worlds):
    """Which parameters stay replicated and along which dim each rank owns
    a block: the reference's ``build_state_specs`` at sdp 2 (its ``sdp``
    entry) against the port's plan in the ranks."""
    jfleet._hcg = None
    from paddle_tpu.models.gpt import GPTConfig, GPTForPretraining

    paddle.seed(7)
    cfg = GPTConfig.tiny()
    cfg.num_layers = 4
    jm = GPTForPretraining(cfg)
    params = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    specs = {n: getattr(p, "dist_spec", None) for n, p in jm.named_parameters()}
    mesh = JHCG(1, 1, 1, 2, devices=jax.devices()[:2]).mesh
    _, opt_specs = build_state_specs(params, mesh, 2, specs)
    want = {}
    for name, spec in opt_specs.items():
        dims = [i for i, e in enumerate(spec) if e is not None and "sdp" in
                (e if isinstance(e, tuple) else (e,))]
        want[name] = dims[0] if dims else None
    for o in worlds[2].result():  # every stage's config and rank holds the same plan
        for c in o[0]:
            assert c["sdp_dims"] == want
    assert {n for n, d in want.items() if d is None} == {
        n for n, a in params.items() if a.size < MIN_SIZE}
    # the rule itself: the mp dim first, then the largest, never the layer dim
    assert partition_dim((4, 64, 192), 2, mp_axis=2, exclude=(0,)) == 2
    assert partition_dim((4, 64, 64), 2, mp_axis=1, exclude=(0,)) == 1
    assert partition_dim((4, 128, 63), 2, mp_axis=2, exclude=(0,)) == 1
    assert partition_dim((4, 256), 2, whole_numel=1024) is None
    assert partition_dim((512, 64), 1) is None


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_at_sdp2_matches_paddle_tpu(worlds, stage):
    c = WORLD2[stage - 1]
    ref = reference_gpt(**c)
    outs = [o[0][stage - 1] for o in worlds[2].result()]
    _check(outs, c, ref)
    counters = outs[0]["counters"]
    if stage == 2:  # the split parameters' gradients reduce-scatter over sdp
        assert counters["collective.reduce_scatter.calls"] == 5 * BASE["steps"]
    if stage == 3:  # each held as its block, gathered in the forward and the backward
        assert outs[0]["state"]["gpt.layers.qkv_w"].shape == (4, 64, 96)
        assert counters["collective.all_gather_concat.calls"] > 4 * BASE["layers"] * BASE["steps"]
    if stage in (1, 2):
        assert outs[0]["state"]["gpt.layers.qkv_w"].shape == (4, 64, 192)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_at_dp2_sdp2_matches_paddle_tpu(worlds, stage):
    ref = reference_gpt(**WORLD4[stage - 1])
    _check(_world4(worlds, stage - 1), WORLD4[stage - 1], ref)


def test_lamb_and_binding_clip_at_sdp2_mp2_match_paddle_tpu(worlds):
    """Lamb's trust ratio over ZeRO-2 blocks of tensor-parallel shards, and a
    global-norm clip of 0.3 that binds (the first step's whole gradient
    norm is above twice it): each parameter's norms, and the global one,
    are summed over ``sdp`` and ``mp`` and count a replicated parameter
    once."""
    from paddle_tpu.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion

    paddle.seed(7)
    cfg = GPTConfig.tiny()
    cfg.num_layers = 4
    jm = GPTForPretraining(cfg)
    ids = paddle.to_tensor(IDS.astype(np.int32))
    JCriterion()(jm(ids), ids).backward()
    norm = float(np.sqrt(sum(float((np.asarray(p.grad.numpy(), np.float64) ** 2).sum())
                             for p in jm.parameters())))
    assert norm > 2 * CLIP
    ref = reference_gpt(**LAMB)
    _check(_world4(worlds, len(WORLD4)), LAMB, ref)


def test_group_sharded_parallel_levels_and_refusals(worlds):
    levels = worlds[2].result()[0][1]
    for level, stage in (("os", 1), ("os_g", 2), ("p_g_os", 3)):
        same, scaler, got, qkv_shape = levels[level]
        assert same and scaler is None and got == stage
        assert qkv_shape == ((2, 64, 96) if stage == 3 else (2, 64, 192))
    assert levels["offload"] == (2, True)
    assert levels["level"].startswith("ValueError")
    assert levels["strategy_offload"] == (2, True)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_offload_is_bitwise_the_same_stage(worlds, stage):
    """ZeRO offload (the optimizer state in host memory, streamed through
    the parameters' device chunk by chunk) at sdp 2: the losses, every
    rank's parameters and moments equal the same stage's without offload
    bit for bit. Here the parameters are on the CPU, so the state is plain
    host memory (pinned only beside CUDA parameters)."""
    for o in worlds[2].result():
        plain, off = o[0][stage - 1], o[0][len(WORLD2) + stage - 1]
        assert off["losses"] == plain["losses"]
        assert off["state_devices"] == [("cpu", False)]
        trees = [("state", plain["state"], off["state"])] + [
            (k, plain["moments"][k], off["moments"][k]) for k in ("m", "v")]
        for what, want, got in trees:
            assert got.keys() == want.keys()
            for name, v in want.items():
                np.testing.assert_array_equal(got[name], v, err_msg=f"{what} {name}")


def test_offload_under_the_guard_skips_the_bad_step_bitwise(worlds):
    """Stage 2 under the training guard with NaN gradients at dispatch 1,
    with and without offload: the bad step is skipped and leaves every
    parameter and moment bit for bit, so three dispatches end where two
    clean steps end, and the step after the bad one repeats its loss."""
    first = 2 * len(WORLD2)
    for o in worlds[2].result():
        two, guarded, off = o[0][first:first + 3]
        assert guarded["skipped"] == off["skipped"] == 1
        assert guarded["losses"] == two["losses"] + two["losses"][1:]
        assert off["losses"] == guarded["losses"]
        assert off["state_devices"] == [("cpu", False)]
        for got in (guarded, off):
            trees = [("state", two["state"], got["state"])] + [
                (k, two["moments"][k], got["moments"][k]) for k in ("m", "v")]
            for what, want, have in trees:
                assert have.keys() == want.keys()
                for name, v in want.items():
                    np.testing.assert_array_equal(have[name], v, err_msg=f"{what} {name}")

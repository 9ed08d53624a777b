"""The reference side of the port's ZeRO, pipeline and hybrid-step parity
tests (``tests/test_torch_{sharding,pipeline,hybrid_step}.py``):
``paddle_tpu``'s ``fleet.distributed_step`` of a stacked GPT on the CPU
mesh of ``tests/conftest.py``, as ``tests/test_pipeline_pp.py:42-54``
builds it (``GPTConfig.tiny()`` at 4 layers, AdamW at lr 1e-3, ids
``[8, 16]`` with labels = ids), and the tolerances the port is held to.

Tolerances, f32 (those of ``tests/test_torch_dist_step.py``): losses rtol
1e-5; each parameter after the steps within a relative L2 error of 2e-5
of the reference's: Adam divides each gradient by its own RMS, so the f32
rounding of sums in another order carries into the update undamped. The
moments are held to the same relative L2 error. The exception is the key
third of a qkv bias: its gradient is 0 in exact arithmetic (softmax
ignores a constant added to every key's score), so AdamW moves each entry
by about lr times the sign of f32 noise on either side; it is held to the
steps' reach, 2 lr per step, and its moments (noise) are left out.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import fleet as jfleet
from paddle_tpu.distributed.strategy import DistributedStrategy as JStrategy
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion

_WORLDS = ThreadPoolExecutor(max_workers=1)

LOSS_RTOL = 1e-5
REL_L2 = 2e-5
IDS = np.random.default_rng(0).integers(0, 512, (8, 16)).astype(np.int64)


def reference_gpt(dp=1, mp=1, pp=1, sdp=1, stage=0, schedule="gpipe", accumulate=1, layers=4,
                  optimizer="adamw", lr=1e-3, clip=None, steps=3, ids=IDS, mask=None, seed=7,
                  cfg=None, sep=1, moe=False):
    """The reference's steps at these degrees from the model of ``seed``
    (``GPTConfig.tiny(**cfg)`` at ``layers``; with ``moe``, GShard's random
    routing off in every MoE layer): ``(initial state, losses, parameters,
    moments)``, numpy."""
    jfleet._hcg = None
    strat = JStrategy()
    strat.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                            "sharding_degree": sdp, "sep_degree": sep}
    if stage:
        strat.sharding = True
        strat.sharding_configs = {"sharding_stage": stage}
    strat.pipeline_configs = {"accumulate_steps": accumulate, "schedule": schedule}
    jfleet.init(is_collective=True, strategy=strat,
                devices=jax.devices()[:dp * mp * pp * sdp * sep])
    try:
        paddle.seed(seed)
        config = JGPTConfig.tiny(**(cfg or {}))
        config.num_layers = layers
        model = JGPT(config)
        if moe:
            for blk in model.gpt.layers:
                if blk.moe is not None:
                    blk.moe.gate.random_routing = False
        state = {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}
        grad_clip = None if clip is None else paddle.nn.ClipGradByGlobalNorm(clip_norm=clip)
        make = paddle.optimizer.Lamb if optimizer == "lamb" else paddle.optimizer.AdamW
        opt = make(learning_rate=lr, parameters=model.parameters(), grad_clip=grad_clip)
        step = jfleet.distributed_step(model, opt, JCriterion())
        if mask is None:
            x = jfleet.shard_batch(paddle.to_tensor(ids.astype(np.int32)))
            labels = x
        else:
            x, m = jfleet.shard_batch(paddle.to_tensor(ids.astype(np.int32)), paddle.to_tensor(mask))
            labels = (x, m)
        losses = [float(step(x, labels)["loss"]) for _ in range(steps)]
        params = {n: np.asarray(v, np.float32) for n, v in step.state["params"].items()}
        moments = {k: {n: np.asarray(v, np.float32) for n, v in tree.items()}
                   for k, tree in step.state["opt"].items()}
    finally:
        jfleet._hcg = None
    return state, losses, params, moments


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _key_third(name):
    return name.endswith("qkv_b") or name.endswith("attn.qkv_proj.bias")


def assert_close(got, want, tol=REL_L2, what="", reach=None):
    """Every entry of ``want`` (name -> array) within ``tol`` relative L2;
    a qkv bias's key third within ``reach`` (absolute; None: left out)."""
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for name, w in want.items():
        g = np.asarray(got[name], np.float32)
        if _key_third(name):
            d = w.shape[-1] // 3
            if reach is not None:
                np.testing.assert_array_less(np.abs(g[..., d:2 * d] - w[..., d:2 * d]), reach)
            g = np.concatenate([g[..., :d], g[..., 2 * d:]], axis=-1)
            w = np.concatenate([w[..., :d], w[..., 2 * d:]], axis=-1)
        err = rel_l2(g, w)
        assert err <= tol, (what, name, err)


def gathered(outs, key, dp_rank=0, sdp_dims=None):
    """The whole model of the ranks at ``dp_rank`` from their
    ``gpt_hybrid`` results ``outs`` (one config's, by rank): ``key`` is
    ``"state"`` or a moment's name."""
    from paddle_tpu_torch.utils.convert import gather_state

    parts = {}
    for o in outs:
        if o["coord"][0] != dp_rank:
            continue
        parts[o["stage_rank"]] = o["state"] if key == "state" else o["moments"][key]
    return gather_state(parts, sdp_dims=sdp_dims)


def started(fn, world, *args, **kwargs):
    """``run_ranks(fn, world, *args, **kwargs)`` queued on a background
    thread: a future whose ``result()`` is the ranks' results. A test file
    queues its worlds (one runs at a time, so one world's processes share
    the host with the tests) and computes the reference's steps while the
    ranks run."""
    from paddle_tpu_torch.testing.dist import run_ranks

    return _WORLDS.submit(run_ranks, fn, world, *args, timeout=300, **kwargs)

"""Sequence parallelism of the port against ``paddle_tpu``'s, on the CPU.

Ring and Ulysses attention over a ``sep`` group of 2 and 4 gloo ranks,
each holding its block of the sequence, against the reference's
``ring_attention`` and ``ulysses_attention`` mapped over a ``sep`` mesh of
as many CPU devices (``tests/test_pipeline_moe_ring.py:70-91``): the
outputs and the gradients of ``mean(out ** 2)`` for q, k and v, causal and
full, ``[2, 32, 4, 16]`` inputs from ``default_rng``. Tolerance atol 1e-5
(f32, the online softmax summed in another order; the reference's own
tests hold its ring to its plain attention at 1e-4).

The GPT step at sep 2 and at dp 2 x sep 2 (``tests/test_pipeline_moe_ring.py:150-185``'s
mesh, cut to 2 and 4 ranks) against the reference's GSPMD step: the
stacked GPT of ``tests/torch_hybrid_reference.py`` (``GPTConfig.tiny(hidden_size=128,
num_heads=2)``, d 64 so the attention goes through the flash kernels'
module, one head a rank after Ulysses' exchange), 4 layers, ids ``[8,
16]``, AdamW lr 1e-3, 3 steps; losses rtol 1e-5, each parameter within a
relative L2 error of 2e-5 (the key third of a qkv bias within the steps'
reach), the moments likewise, and the ``sep`` ranks of one row block
holding the same weights. The zero-initialised biases are held to 1e-4:
AdamW moves them by about lr a step from 0, so f32 noise in their small
gradients weighs more; the reference's own sep 2 step is 2.4e-5 from its
one-device step on ``ffn1_b`` (8.0e-5 at dp 2 x sep 2), and the port's
2.9e-5 (3.4e-5) from the reference's, measured on the CPU.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.sharding import Mesh  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from paddle_tpu.distributed.ring_attention import ring_attention as jring  # noqa: E402
from paddle_tpu.distributed.ring_attention import ulysses_attention as julysses  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from torch_hybrid_reference import (IDS, LOSS_RTOL, assert_close, gathered,  # noqa: E402
                                    reference_gpt, started)

ATOL = 1e-5
ZERO_INIT_REL_L2 = 1e-4
QKV = [np.random.default_rng(60 + i).normal(size=(2, 32, 4, 16)).astype(np.float32)
       for i in range(3)]
BASE = dict(lr=1e-3, steps=3, layers=4, cfg=dict(hidden_size=128, num_heads=2))
SEP2 = dict(BASE, sep=2)
DP2_SEP2 = dict(BASE, dp=2, sep=2)


INITIAL = {}


@pytest.fixture(scope="module")
def worlds():
    initial = reference_gpt(steps=0, cfg=BASE["cfg"])[0]
    INITIAL.update(initial)
    two = [("seq_attention", QKV), ("gpt_hybrid", ([SEP2], initial, IDS))]
    four = [("seq_attention", QKV), ("gpt_hybrid", ([DP2_SEP2], initial, IDS))]
    return {2: started(ranks.several, 2, two), 4: started(ranks.several, 4, four)}


def _reference(fn, n, causal):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sep",))
    q, k, v = (jnp.asarray(t) for t in QKV)

    def attend(q, k, v):
        return fn(q, k, v, mesh, axis="sep", causal=causal)

    # jitted: the reference's eager shard_map runs its ring op by op (8 s a call)
    out = jax.jit(attend)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.mean(attend(q, k, v) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
@pytest.mark.parametrize("n", [2, 4])
def test_attention_matches_paddle_tpu(worlds, n, name, causal):
    want_out, want_grads = _reference({"ring": jring, "ulysses": julysses}[name], n, causal)
    outs = [o[0][(name, causal)] for o in worlds[n].result()]
    np.testing.assert_allclose(np.concatenate([o["out"] for o in outs], axis=1), want_out,
                               atol=ATOL)
    for i, want in enumerate(want_grads):
        np.testing.assert_allclose(np.concatenate([o["grads"][i] for o in outs], axis=1), want,
                                   atol=ATOL, err_msg="qkv"[i])


def test_ulysses_needs_heads_that_split(worlds):
    for o in worlds[2].result():
        assert "do not split over a sep group of 2" in o[0]["uneven_heads"]


@pytest.mark.parametrize("world,c", [(2, SEP2), (4, DP2_SEP2)], ids=["sep2", "dp2_sep2"])
def test_gpt_step_matches_paddle_tpu(worlds, world, c):
    _, losses, params, moments = reference_gpt(**c)
    outs = worlds[world].result()
    outs = [o[1][0] for o in outs]
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=LOSS_RTOL)
        # Ulysses hands the flash module the packed [b, s, 3, 1, 64]: picked, no fallback
        assert o["picked"] == {"kernels.attention_core.picked": 1,
                               "kernels.attention_core.fallback": 0}
        assert o["counters"]["collective.alltoall.calls"] > 0
    reach = 2 * c["lr"] * c["steps"] + 1e-7
    zero = {n for n, v in INITIAL.items() if not v.any() and not n.endswith("qkv_b")}
    assert zero and all(n.endswith("_b") or n.endswith("bias") for n in zero)
    for dp_rank in range(c.get("dp", 1)):
        got = gathered(outs, "state", dp_rank=dp_rank)
        assert_close({n: got[n] for n in zero}, {n: params[n] for n in zero},
                     tol=ZERO_INIT_REL_L2, what="zero-initialised biases")
        assert_close({n: v for n, v in got.items() if n not in zero},
                     {n: v for n, v in params.items() if n not in zero}, what="params",
                     reach=reach)
    for key in ("m", "v"):
        assert_close(gathered(outs, key), moments[key], what=key)
    # the sep ranks of one row block step to the same weights
    by_dp = {}
    for o in outs:
        by_dp.setdefault(o["coord"][0], []).append(o["state"])
    for states in by_dp.values():
        for name, v in states[0].items():
            np.testing.assert_array_equal(states[1][name], v)

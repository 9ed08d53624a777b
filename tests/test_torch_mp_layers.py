"""The port's tensor-parallel layers at mp 2 and 4 against ``paddle_tpu``'s
single-device layers holding the full weights, on the CPU.

Each rank of an mp-degree gloo world (:func:`paddle_tpu_torch.testing.dist.run_ranks`)
loads its shard of the same numpy weights; the reference runs its layers
on one device (no fleet mesh). Forward values and gradients (under the
same random cotangents) must agree: the full output on every rank (or
this rank's column block without ``gather_output``), the full input
gradient, and this rank's shard of each weight's gradient. Also here:
``TensorParallel``'s broadcast of the replicated parameters, the RNG
tracker, and the errors of a width the degree does not divide.

Tolerance, f32: atol 1e-5 / rtol 1e-5 (the row-parallel sum and the
softmax reductions split over ranks, added in another order).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed import mp_layers as jmp  # noqa: E402
from paddle_tpu.distributed.fleet import fleet as jfleet  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from paddle_tpu_torch.testing.dist import run_ranks  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def one_device_reference():
    prior = jfleet._hcg
    jfleet._hcg = None
    yield
    jfleet._hcg = prior


def _case(mp):
    rng = np.random.default_rng(50 + mp)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    labels = rng.integers(0, 12 * mp, (3, 5))
    labels[0, :2] = -100
    return {"x": f(3, 5, 16), "col_w": f(16, 8 * mp), "col_b": f(8 * mp), "col_ct": f(3, 5, 8 * mp),
            "qkv_w": f(16, 12 * mp), "xr": f(3, 5, 8 * mp), "row_w": f(8 * mp, 16), "row_b": f(16),
            "row_ct": f(3, 5, 16), "emb_w": f(12 * mp, 16),
            "ids": rng.integers(0, 12 * mp, (3, 5)), "emb_ct": f(3, 5, 16),
            "logits": 3 * f(3, 5, 12 * mp), "labels": labels, "ce_ct": f(3, 5)}


def _grads(layer, x, ct, inputs_grad=True):
    """The reference layer's output and the gradients of ``sum(out * ct)``:
    input (if float), weight, bias."""
    t = paddle.to_tensor(x, stop_gradient=not inputs_grad)
    out = layer(t)
    (out * paddle.to_tensor(ct)).sum().backward()
    g = lambda p: None if p is None or p.grad is None else np.asarray(p.grad.numpy())  # noqa: E731
    return (np.asarray(out.numpy()), g(t) if inputs_grad else None, g(layer.weight),
            g(getattr(layer, "bias", None)))


def _set(layer, **arrays):
    layer.set_state_dict({k: paddle.to_tensor(v) for k, v in arrays.items()})
    return layer


def _block(a, axis, r, n, blocks=1):
    size = a.shape[axis]
    parts = np.split(a, blocks * n, axis=axis)
    return np.concatenate([parts[b * n + r] for b in range(blocks)], axis=axis) if size else a


@pytest.mark.parametrize("mp", [2, 4])
def test_layers_match_paddle_tpu_single_device(mp):
    case = _case(mp)
    got = run_ranks(ranks.mp_layers, mp, mp, case)
    col = _grads(_set(jmp.ColumnParallelLinear(16, 8 * mp), weight=case["col_w"], bias=case["col_b"]),
                 case["x"], case["col_ct"])
    row = _grads(_set(jmp.RowParallelLinear(8 * mp, 16), weight=case["row_w"], bias=case["row_b"]),
                 case["xr"], case["row_ct"])
    emb = _grads(_set(jmp.VocabParallelEmbedding(12 * mp, 16), weight=case["emb_w"]),
                 case["ids"], case["emb_ct"], inputs_grad=False)
    logits = paddle.to_tensor(case["logits"], stop_gradient=False)
    ce = jmp.ParallelCrossEntropy(ignore_index=-100)(logits, paddle.to_tensor(case["labels"]))
    (ce * paddle.to_tensor(case["ce_ct"])).sum().backward()
    ce_out, ce_grad = np.asarray(ce.numpy()), np.asarray(logits.grad.numpy())
    lamb = _set(jmp.ColumnParallelLinear(4, 2 * mp),
                weight=np.arange(8.0 * mp, dtype=np.float32).reshape(4, 2 * mp),
                bias=np.zeros(2 * mp, np.float32))
    lamb(paddle.ones([1, 4])).sum().backward()
    paddle.optimizer.Lamb(learning_rate=0.1, parameters=lamb.parameters()).step()
    lamb_whole = np.asarray(lamb.weight.numpy())
    for r, o in enumerate(got):
        for gather in (True, False):
            out, dx, dw, db, dist, axis = o[f"col_{gather}"]
            want_out = col[0] if gather else _block(col[0], 2, r, mp)
            # without gather_output the cotangent seen is this rank's block,
            # so the input gradient is this rank's part of the sum
            np.testing.assert_allclose(out, want_out, **TOL)
            if gather:
                np.testing.assert_allclose(dx, col[1], **TOL)
            np.testing.assert_allclose(dw, _block(col[2], 1, r, mp), **TOL)
            np.testing.assert_allclose(db, _block(col[3], 0, r, mp), **TOL)
            assert dist and axis == 1
        np.testing.assert_allclose(o["fused"], case["x"] @ case["qkv_w"], **TOL)
        for parallel in (False, True):
            out, dx, dw, db, bias_dist = o[f"row_{parallel}"]
            np.testing.assert_allclose(out, row[0], **TOL)
            np.testing.assert_allclose(dx, _block(row[1], 2, r, mp) if parallel else row[1], **TOL)
            np.testing.assert_allclose(dw, _block(row[2], 0, r, mp), **TOL)
            np.testing.assert_allclose(db, row[3], **TOL)  # the bias, added once, is replicated
            assert not bias_dist
        out, dw = o["emb"]
        np.testing.assert_allclose(out, emb[0], **TOL)
        np.testing.assert_allclose(dw, _block(emb[2], 0, r, mp), **TOL)
        assert f"out of range [0, {12 * mp})" in o["emb_range"]
        np.testing.assert_array_equal(o["emb_bad_inside_step"][:2], 0.0)
        np.testing.assert_allclose(o["emb_bad_inside_step"][2], case["emb_w"][0], **TOL)
        loss, dlogits = o["ce"]
        np.testing.assert_allclose(loss, ce_out, **TOL)
        assert (loss[0, :2] == 0).all()
        np.testing.assert_allclose(dlogits, _block(ce_grad, 2, r, mp), **TOL)
        np.testing.assert_array_equal(o["tp_replicated"], got[0]["tp_replicated"])
        if r:
            assert not np.array_equal(o["tp_shard"], got[0]["tp_shard"])  # shards stay their own
        assert all("does not split" in e for e in o["indivisible"])
        # GPT and ERNIE build at mp > 1 with their heads split; Lamb over the
        # column shards steps as over the whole weight
        assert o["gpt_heads"] == 4 // mp and o["ernie_heads"] == 4 // mp
        np.testing.assert_allclose(o["lamb_weight"], _block(lamb_whole, 1, r, mp), **TOL)


def test_rng_tracker_is_shared_within_the_group():
    """``tensor_parallel_configs`` (its degree, as ``hybrid_configs``
    leaves mp at 1, and its ``tensor_init_seed``) seeds the named stream
    on every rank alike; the default streams stay each rank's own; a
    second seed for the same name raises."""
    out = run_ranks(ranks.rng_tracker, 2, 123)
    (s0, own0, names, clash, mp), (s1, own1, _, _, _) = out
    assert mp == 2
    np.testing.assert_array_equal(s0, s1)
    assert not np.array_equal(own0, own1)
    assert names == ["model_parallel_rng"] and "different seed" in clash

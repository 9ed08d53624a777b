"""The port's metrics (``paddle_tpu_torch.metric``: computed in torch on the
inputs' device, accumulated as host numbers) against ``paddle_tpu.metric``
on the same numpy predictions, on the CPU.

Tolerances: Accuracy, Precision and Recall count the same hits (exact);
Auc bins the same f32 scores into the same counts and integrates them with
the same numpy trapezoid (exact). Scores are f32 draws without ties, where
the reference's ``argsort`` order is defined; the port's tie rule (a stable
descending order: the lower class index first) is held to
``torch.sort(stable=True)`` apart.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.metric as rm

from paddle_tpu_torch import metric as pm


def _scores(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("label_shape", ["column", "flat"])
def test_accuracy_topk_over_batches(label_shape):
    rng = np.random.default_rng(1)
    r, p = rm.Accuracy(topk=(1, 3, 5)), pm.Accuracy(topk=(1, 3, 5))
    for step in range(3):
        pred = _scores(step, (32, 10))
        label = rng.integers(0, 10, (32, 1) if label_shape == "column" else (32,))
        want = r.update(*r.compute(pred, label))
        got = p.update(*p.compute(torch.from_numpy(pred), torch.from_numpy(label)))
        assert got == want
    assert p.accumulate() == r.accumulate() and p.name() == r.name() == "acc"
    p.reset()
    assert p.accumulate() == [0.0, 0.0, 0.0]


def test_accuracy_of_sequence_logits():
    """``[b, s, V]`` logits with ``[b, s]`` labels (a language model's)."""
    pred = _scores(3, (4, 6, 50))
    label = np.random.default_rng(4).integers(0, 50, (4, 6))
    r, p = rm.Accuracy(topk=(1, 5)), pm.Accuracy(topk=(1, 5), name="lm_acc")
    want = r.update(*r.compute(pred, label))
    assert p.update(*p.compute(torch.from_numpy(pred), torch.from_numpy(label))) == want
    assert p.name() == "lm_acc"
    for k in (1, 2, 7):
        got = pm.accuracy(torch.from_numpy(pred), torch.from_numpy(label), k=k)
        assert got.dtype == torch.float32
        assert float(got) == float(rm.accuracy(pred, label, k=k).numpy())


def test_the_tie_rule_is_a_stable_descending_order():
    pred = torch.tensor([[0.5, 0.9, 0.5, 0.5, 0.1], [0.2, 0.2, 0.2, 0.2, 0.2]])
    label = torch.tensor([2, 4])
    correct, _ = pm.Accuracy(topk=(1, 3)).compute(pred, label)
    order = torch.sort(pred, dim=-1, descending=True, stable=True)[1][:, :3]
    torch.testing.assert_close(correct, order == label[:, None], rtol=0, atol=0)
    assert correct.tolist() == [[False, False, True], [False, False, False]]


@pytest.mark.parametrize("kind", ["Precision", "Recall"])
def test_precision_and_recall(kind):
    r, p = getattr(rm, kind)(), getattr(pm, kind)()
    for step in range(3):
        preds = _scores(10 + step, (40, 1))
        labels = np.random.default_rng(step).integers(0, 2, (40, 1)).astype(np.float32)
        r.update(preds, labels)
        p.update(torch.from_numpy(preds), torch.from_numpy(labels))
    assert p.accumulate() == r.accumulate() and p.name() == r.name()


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc(two_columns):
    r, p = rm.Auc(num_thresholds=255), pm.Auc(num_thresholds=255)
    for step in range(3):
        s = _scores(20 + step, (64,))
        preds = np.stack([1 - s, s], 1) if two_columns else s
        labels = (np.random.default_rng(step).random(64) < s).astype(np.int64)
        r.update(preds, labels)
        p.update(torch.from_numpy(preds), torch.from_numpy(labels))
    np.testing.assert_array_equal(p._stat_pos, r._stat_pos)
    np.testing.assert_array_equal(p._stat_neg, r._stat_neg)
    assert p.accumulate() == r.accumulate() and 0.5 < p.accumulate() < 1.0
    p.reset()
    assert p.accumulate() == 0.0

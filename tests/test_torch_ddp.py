"""The port's ``DataParallel`` against ``paddle_tpu``'s (``tests/test_hooks_ddp.py``'s
cases) at world 2, in gloo processes on the CPU.

- the gradient mean: ranks feed 1s and 2s to one ``Linear(4, 1)`` and the
  weight gradient is exactly 3 on both, which is half the reference's
  gradient of the same sum over the two ranks' rows joined;
- the bucket plan equals the reference's ``_BucketReducer``'s for the same
  parameter shapes and dtypes;
- the unused-parameter error, ``find_unused_parameters``, ``no_sync`` with
  ``apply_collective_grads``, the parameters broadcast from rank 0;
- ``spawn``; and the world-1 passthrough (no hooks).

Exact values: sums of a few small integers in f32.
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed.parallel import _BucketReducer as JBucketReducer  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from paddle_tpu_torch.distributed.parallel import spawn  # noqa: E402
from paddle_tpu_torch.testing.dist import run_ranks  # noqa: E402


def test_gradient_mean_error_no_sync_and_broadcast():
    out = run_ranks(ranks.ddp_cases, 2)
    # the reference: the same Linear on both ranks' rows joined; DataParallel
    # averages the ranks' gradients, i.e. half the joined batch's
    paddle.seed(0)
    lin = paddle.nn.Linear(4, 1)
    x = paddle.to_tensor(np.concatenate([np.full((2, 4), 1.0), np.full((2, 4), 2.0)]).astype("float32"))
    lin(x).sum().backward()
    want = 0.5 * np.asarray(lin.weight.grad.numpy())
    for r, o in enumerate(out):
        assert o["grad_sync"] and o["hooks"] == 2
        np.testing.assert_array_equal(o["weight"], out[0]["weight"])  # broadcast from rank 0
        np.testing.assert_array_equal(o["grad"], np.full((4, 1), 3.0, np.float32))
        np.testing.assert_array_equal(o["grad"], want)
        np.testing.assert_array_equal(o["bias_grad"], [2.0])
        assert "produced no gradient" in o["unused_error"] and "b.weight" in o["unused_error"]
        np.testing.assert_array_equal(o["loose_grad"], np.full((3, 3), 1.5, np.float32))
        assert o["loose_unused"]
        np.testing.assert_array_equal(o["no_sync_grad"], np.full((4, 1), 2.0 * (r + 1), np.float32))
        np.testing.assert_array_equal(o["applied_grad"], np.full((4, 1), 3.0, np.float32))
        assert o["state_keys"] == ["bias", "weight"]


def test_bucket_plan_equals_paddle_tpu():
    """Grouped by dtype in order, each bucket filled to the budget, an
    oversized parameter alone: the same buckets as the reference's plan."""
    shapes = [(256, 256), (256,), (64, 512), (300, 100), (8,), (512, 64), (4, 4), (1024, 40)]
    dtypes = ["float32", "float32", "bfloat16", "float32", "bfloat16", "float32", "float32",
              "bfloat16"]
    budgets = [0.1, 0.3, 25]

    class _P:
        def __init__(self, shape, dtype):
            self._value = jnp.zeros(shape, dtype)
            self.grad = None

    params = [_P(s, d) for s, d in zip(shapes, dtypes)]
    index = {id(p): i for i, p in enumerate(params)}
    want = [[(dt, [index[id(p)] for p in ps]) for dt, ps in JBucketReducer(params, mb).buckets]
            for mb in budgets]
    got = run_ranks(ranks.bucket_plans, 2, shapes, dtypes, budgets)
    for plan in got:
        assert [[(dt, list(ix)) for dt, ix in b] for b in plan] == want
    assert len(want[0]) >= 6 and len(want[2]) == 2  # the small budget splits, 25 MB does not


def test_world_one_is_a_passthrough():
    out = run_ranks(ranks.ddp_world_one, 1)[0]
    assert out["world"] == 1 and not out["grad_sync"] and out["hooks"] == 0
    np.testing.assert_array_equal(out["grad"], np.full((4, 2), 2.0, np.float32))


def test_spawn(tmp_path):
    spawn(ranks.spawn_target, args=(str(tmp_path),), nprocs=2, join=True)
    assert (tmp_path / "rank0").read_text() == "2" and (tmp_path / "rank1").read_text() == "2"
    hit = []
    spawn(lambda: hit.append(1), nprocs=-1)  # nprocs -1 or 1 is a direct call
    spawn(lambda: hit.append(2), nprocs=1)
    assert hit == [1, 2]
    assert "PADDLE_TRAINER_ID" not in os.environ

"""The port's ``SyncBatchNorm`` at dp 2 against ``paddle_tpu``'s batch norm
over the whole batch, on the CPU.

The reference's batch norm runs over a batch that GSPMD shards, so its
statistics are always the global batch's; the port's ``SyncBatchNorm``
all-reduces the per-channel sums over the dp group to get the same. Two
gloo ranks (:func:`paddle_tpu_torch.testing.dist.run_ranks`) each take
their ``shard_batch`` block:

- one ``[8, 6, 5, 5]`` layer in training: each rank's output is its block
  of the reference's; under the cotangent ``ct`` (the loss
  ``sum(out * ct)``, summed over the ranks) the input gradient is its block
  of the reference's, the weight and bias gradients averaged over the
  ranks (``DataParallel``) are half the reference's, and the running
  statistics after the step are the reference's;
- the port's ResNet18 with ``convert_sync_batchnorm``: the layers swapped
  in place, sharing their weights and buffers, and one training forward at
  dp 2 giving the reference's logits, loss and first running statistics.

Tolerance, f32: atol 1e-5 / rtol 1e-5 for the layer (its sums over the
batch split in two); the ResNet's logits atol 1e-4 / rtol 1e-4 (20 batch
norms in training mode, each renormalising over few values per channel).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
from paddle_tpu.vision.models import resnet18 as jresnet18  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from paddle_tpu_torch.nn.layer import BatchNorm2D, SyncBatchNorm  # noqa: E402
from paddle_tpu_torch.testing.dist import run_ranks  # noqa: E402
from paddle_tpu_torch.utils.convert import state_dict_by_name  # noqa: E402
from paddle_tpu_torch.vision.models import resnet18  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def test_sync_batch_norm_dp2_matches_paddle_tpu_global_batch_norm():
    rng = np.random.default_rng(60)
    x = (2 * rng.standard_normal((8, 6, 5, 5)) + 0.5).astype(np.float32)
    ct = rng.standard_normal((8, 6, 5, 5)).astype(np.float32)
    w, b = rng.standard_normal(6).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    bn = jnn.BatchNorm2D(6, momentum=0.8, epsilon=1e-5)
    bn.set_state_dict({"weight": paddle.to_tensor(w), "bias": paddle.to_tensor(b)})
    bn.train()
    jx = paddle.to_tensor(x, stop_gradient=False)
    out = bn(jx)
    (out * paddle.to_tensor(ct)).sum().backward()
    want = dict(out=np.asarray(out.numpy()), dx=np.asarray(jx.grad.numpy()),
                dw=np.asarray(bn.weight.grad.numpy()), db=np.asarray(bn.bias.grad.numpy()),
                mean=np.asarray(bn._mean.numpy()), var=np.asarray(bn._variance.numpy()))
    got = run_ranks(ranks.sync_bn, 2, x, ct, w, b, 0.8, 1e-5)
    for r, o in enumerate(got):
        rows = slice(4 * r, 4 * r + 4)
        np.testing.assert_allclose(o["out"], want["out"][rows], **TOL)
        np.testing.assert_allclose(o["dx"], want["dx"][rows], **TOL)
        np.testing.assert_allclose(o["dw"], want["dw"] / 2, **TOL)
        np.testing.assert_allclose(o["db"], want["db"] / 2, **TOL)
        np.testing.assert_allclose(o["mean"], want["mean"], **TOL)
        np.testing.assert_allclose(o["var"], want["var"], **TOL)


def test_convert_sync_batchnorm_resnet18_dp2():
    model = resnet18(num_classes=10, device="cpu")
    bns = {n: m for n, m in model.named_modules() if isinstance(m, BatchNorm2D)}
    weights = {n: (m.weight, m._mean) for n, m in bns.items()}
    assert SyncBatchNorm.convert_sync_batchnorm(model) is model
    swapped = dict(model.named_modules())
    assert len(bns) == 20
    for n, (weight, mean) in weights.items():
        assert isinstance(swapped[n], SyncBatchNorm)
        assert swapped[n].weight is weight and swapped[n]._mean is mean  # shared, not copied
    assert not any(type(m) is BatchNorm2D for m in model.modules())
    # one rank, no process group: a SyncBatchNorm is the plain batch norm
    x1 = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    model.eval()
    plain = resnet18(num_classes=10, device="cpu").eval()
    plain.load_state_dict(model.state_dict())
    torch.testing.assert_close(model(x1), plain(x1), rtol=0, atol=0)

    paddle.seed(61)
    jm = jresnet18(num_classes=10)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    rng = np.random.default_rng(62)
    x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, (4,)).astype(np.int64)
    jm.train()
    logits = jm(paddle.to_tensor(x))
    jloss = float(paddle.nn.CrossEntropyLoss()(logits, paddle.to_tensor(y)).numpy())
    want = np.asarray(logits.numpy())
    port_state = {k: v.numpy() for k, v in
                  state_dict_by_name(state, resnet18(num_classes=10, device="cpu")).items()}
    got = run_ranks(ranks.resnet_sync_bn, 2, port_state, x, y)
    for r, o in enumerate(got):
        np.testing.assert_allclose(o["logits"], want[2 * r:2 * r + 2], **MODEL_TOL)
        np.testing.assert_allclose(o["loss"], jloss, rtol=1e-5)
        np.testing.assert_allclose(o["mean"], np.asarray(jm.bn1._mean.numpy()), **MODEL_TOL)
        np.testing.assert_allclose(o["var"], np.asarray(jm.bn1._variance.numpy()), **MODEL_TOL)

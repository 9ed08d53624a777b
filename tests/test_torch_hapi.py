"""The port's training loop (``paddle_tpu_torch.hapi``: ``Model``, the
callbacks, ``flops``/``summary``; ``jit.EvalStep``) against
``paddle_tpu``'s on the CPU, from the same weights and data.

LeNet is fitted in both packages from one state (drawn by the port; the
reference model is built with constant initialisers and takes it, as
``tests/torch_zoo_common.py`` does, since its random ones dispatch per
shape): 2 epochs of 3 Adam steps, ``EarlyStopping`` stopping both after the
second evaluation, ``ModelCheckpoint`` writing each epoch.

Tolerances: per-step losses and the eval loss rtol 1e-5, the predicted
logits within 1e-5 of their largest magnitude (f32 through XLA's and
ATen's convolutions after 6 Adam steps: 5.3e-5 apart at logits up to 16,
measured); eager one-batch losses and logits rtol / atol 1e-5; accuracies
exact (the same top-1 hits of untied f32 logits); ``flops`` and ``summary``
exact; the tiny GPT's ``EvalStep`` logits rtol 1e-5, atol 1e-6, and at dp 2
over two gloo ranks bitwise against one process (each rank's block runs
the same kernels as the whole batch's rows). ``TestHapiTrainingHealth`` is
``tests/test_stability.py``'s, run on the port.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu.hapi import callbacks as rcb
from paddle_tpu.io import Dataset as RDataset
from paddle_tpu.models.lenet import LeNet as RLeNet
from paddle_tpu.nn import initializer as rI

import paddle_tpu_torch as port
from paddle_tpu_torch.hapi import callbacks as pcb
from paddle_tpu_torch.io import Dataset as PDataset
from paddle_tpu_torch.models.lenet import LeNet as PLeNet

LOSS = dict(rtol=1e-5, atol=0)
HOOKS = ("on_train_begin", "on_train_end", "on_epoch_begin", "on_epoch_end",
         "on_train_batch_begin", "on_train_batch_end", "on_eval_begin", "on_eval_end",
         "on_eval_batch_begin", "on_eval_batch_end", "on_predict_begin", "on_predict_end",
         "on_predict_batch_begin", "on_predict_batch_end")


def _mnist(base, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 1, 28, 28)).astype("float32")
    y = rng.integers(0, 10, (n, 1)).astype("int64")

    class DS(base):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return x[i], y[i]

    return DS()


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.calls, self.losses = [], []

    for hook in HOOKS:
        def fn(self, *args, _hook=hook):
            self.calls.append(_hook)
            logs = args[-1] if args and isinstance(args[-1], dict) else None
            if _hook == "on_train_batch_end":
                self.losses.append(logs["loss"])
        setattr(Recorder, hook, fn)
    return Recorder()


def _ref_model(make):
    rI.set_global_initializer(rI.Constant(0.0), rI.Constant(0.0))
    try:
        return make()
    finally:
        rI.set_global_initializer(None, None)


def _state(pm):
    return {k: v.detach().numpy().copy() for k, v in pm.state_dict().items()}


@pytest.fixture(scope="module")
def lenet_runs(tmp_path_factory):
    """Both packages' fit (with an eval set, EarlyStopping and
    ModelCheckpoint), evaluate and predict from one LeNet state."""
    root = tmp_path_factory.mktemp("hapi")
    pnet = PLeNet(device="cpu", seed=3)
    state = _state(pnet)
    rnet = _ref_model(RLeNet)
    rnet.set_state_dict(state)
    out = {}
    for name, pkg, net, cb, base in (("ref", ref, rnet, rcb, RDataset),
                                     ("port", port, pnet, pcb, PDataset)):
        model = pkg.Model(net)
        model.prepare(pkg.optimizer.Adam(learning_rate=1e-3, parameters=model.parameters()),
                      pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
        rec = _recorder(cb.Callback)
        stop = cb.EarlyStopping(monitor="loss", mode="min", patience=0, min_delta=1.0, verbose=0)
        hist = model.fit(_mnist(base, 48, 0), eval_data=_mnist(base, 32, 1), batch_size=16,
                         epochs=4, shuffle=False, verbose=0, callbacks=[rec, stop],
                         save_dir=str(root / name))
        evaluated = model.evaluate(_mnist(base, 32, 1), batch_size=16, verbose=0)
        preds = model.predict(_mnist(base, 40, 2), batch_size=16, stack_outputs=True, verbose=0,
                              callbacks=[rec])
        out[name] = dict(model=model, hist=hist, rec=rec, eval=evaluated, preds=preds,
                         stopped=model.stop_training, dir=root / name)
    return out


def test_fit_losses_per_step_match(lenet_runs):
    r, p = lenet_runs["ref"], lenet_runs["port"]
    assert len(p["rec"].losses) == len(r["rec"].losses) == 6
    np.testing.assert_allclose(p["rec"].losses, r["rec"].losses, **LOSS)
    np.testing.assert_allclose(p["hist"], r["hist"], **LOSS)


def test_early_stopping_stops_at_the_same_epoch(lenet_runs):
    r, p = lenet_runs["ref"], lenet_runs["port"]
    assert len(p["hist"]) == len(r["hist"]) == 2 and p["stopped"] and r["stopped"]


def test_callback_order_is_the_reference(lenet_runs):
    r, p = lenet_runs["ref"], lenet_runs["port"]
    assert p["rec"].calls == r["rec"].calls
    assert p["rec"].calls[:3] == ["on_train_begin", "on_epoch_begin", "on_train_batch_begin"]


def test_evaluate_and_predict(lenet_runs):
    r, p = lenet_runs["ref"], lenet_runs["port"]
    np.testing.assert_allclose(p["eval"]["loss"], r["eval"]["loss"], **LOSS)
    assert p["eval"]["acc"] == r["eval"]["acc"]
    assert len(p["preds"]) == 1 and p["preds"][0].shape == (40, 10)
    np.testing.assert_allclose(p["preds"][0], r["preds"][0], rtol=0,
                               atol=1e-5 * np.abs(r["preds"][0]).max())
    batches = p["model"].predict(_mnist(PDataset, 40, 2), batch_size=16, verbose=0)
    assert [tuple(b.shape) for b in batches] == [(16, 10), (16, 10), (8, 10)]
    np.testing.assert_allclose(np.concatenate([b.numpy() for b in batches]), p["preds"][0],
                               rtol=0, atol=0)


def test_checkpoints_cross_the_packages(lenet_runs, tmp_path):
    """Each epoch's and the final ``.pdparams``; the reference's final file
    loads into a port ``Model`` and the port's into a reference ``Model``,
    each evaluating as its writer did."""
    r, p = lenet_runs["ref"], lenet_runs["port"]
    for run in (r, p):
        assert sorted(os.listdir(run["dir"])) == ["0.pdopt", "0.pdparams", "1.pdopt",
                                                  "1.pdparams", "final.pdopt", "final.pdparams"]
    data = _mnist(PDataset, 32, 1)
    fresh = port.Model(PLeNet(device="cpu", seed=9))
    fresh.prepare(loss=port.nn.CrossEntropyLoss(), metrics=port.metric.Accuracy())
    fresh.load(str(r["dir"] / "final"), reset_optimizer=True)
    got = fresh.evaluate(data, batch_size=16, verbose=0)
    np.testing.assert_allclose(got["loss"], r["eval"]["loss"], **LOSS)
    fresh.save(str(tmp_path / "back"), training=False)
    back = ref.Model(_ref_model(RLeNet))
    back.prepare(loss=ref.nn.CrossEntropyLoss())
    back.load(str(tmp_path / "back"))
    want = {k: np.asarray(v.numpy()) for k, v in back.network.state_dict().items()}
    for k, v in _state(fresh.network).items():
        np.testing.assert_array_equal(want[k], v)
    mine = ref.Model(_ref_model(RLeNet))
    mine.prepare(loss=ref.nn.CrossEntropyLoss())
    mine.load(str(p["dir"] / "final"))
    np.testing.assert_allclose(mine.evaluate(_mnist(RDataset, 32, 1), batch_size=16,
                                             verbose=0)["loss"], p["eval"]["loss"], **LOSS)
    # the optimizer's state comes back too
    opt = port.optimizer.Adam(learning_rate=1e-3, parameters=fresh.parameters())
    fresh.prepare(opt, port.nn.CrossEntropyLoss())
    fresh.load(str(p["dir"] / "final"))
    assert opt._step_count == p["model"]._optimizer._step_count == 6


def test_eager_batches():
    from paddle_tpu_torch.nn.layer import Linear

    pnet = torch.nn.Sequential(Linear(12, 10, device="cpu"))
    rnet = _ref_model(lambda: ref.nn.Sequential(ref.nn.Linear(12, 10)))
    rnet.set_state_dict(_state(pnet))
    x = np.random.default_rng(5).normal(size=(8, 12)).astype(np.float32)
    y = np.random.default_rng(6).integers(0, 10, (8, 1)).astype(np.int64)
    got, want = [], []
    for pkg, net, out in ((port, pnet, got), (ref, rnet, want)):
        m = pkg.Model(net)
        m.prepare(pkg.optimizer.SGD(learning_rate=0.1, parameters=m.parameters()),
                  pkg.nn.CrossEntropyLoss())
        out.append(np.asarray(m.train_batch([x], [y])))
        loss, logits = m.eval_batch([x], [y])
        out += [np.asarray(loss), np.asarray(logits.numpy())]
        out.append(np.asarray(m.predict_batch([x]).numpy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_metrics_under_accumulation():
    """``TrainStep(accumulate_steps=2, return_outputs=True)`` gives the
    batch's outputs in order, so a metric over them counts as the
    reference's does (``tests/test_hapi.py:104``)."""
    from paddle_tpu.jit import TrainStep as RTrainStep

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.layer import Linear

    x = np.random.default_rng(0).standard_normal((8, 8)).astype("float32")
    y = np.random.default_rng(1).integers(0, 4, (8,)).astype("int64")
    pnet = torch.nn.Sequential(Linear(8, 4, device="cpu"))
    rnet = _ref_model(lambda: ref.nn.Sequential(ref.nn.Linear(8, 4)))
    rnet.set_state_dict(_state(pnet))
    accs = []
    for pkg, net, make in ((port, pnet, TrainStep), (ref, rnet, RTrainStep)):
        step = make(net, pkg.optimizer.SGD(learning_rate=0.01, parameters=net.parameters()),
                    pkg.nn.CrossEntropyLoss(), accumulate_steps=2, return_outputs=True)
        out = step(pkg.to_tensor(x) if pkg is ref else torch.from_numpy(x),
                   pkg.to_tensor(y) if pkg is ref else torch.from_numpy(y))
        acc = pkg.metric.Accuracy(topk=(1, 2))
        accs.append(acc.update(*acc.compute(out["outputs"], y)))
        assert tuple(out["outputs"].shape) == (8, 4)
    assert accs[0] == accs[1]


@pytest.mark.parametrize("name", ["lenet", "resnet18"])
def test_flops_and_summary(name, capsys):
    from paddle_tpu.vision.models import resnet18 as rresnet18

    from paddle_tpu_torch.vision.models import resnet18

    if name == "lenet":
        pnet, rnet, size = PLeNet(device="cpu"), _ref_model(RLeNet), [2, 1, 28, 28]
    else:
        pnet, rnet, size = resnet18(device="cpu"), _ref_model(rresnet18), [1, 3, 64, 64]
    assert port.flops(pnet, size) == ref.flops(rnet, size) > 0
    assert port.summary(pnet) == ref.summary(rnet)
    port.flops(pnet, size, print_detail=True)
    assert "total" in capsys.readouterr().out
    assert pnet.training  # flops restores the mode


def test_eval_step_on_the_tiny_gpt():
    from paddle_tpu.jit import EvalStep as REvalStep
    from paddle_tpu.models.gpt import GPTConfig as RConfig
    from paddle_tpu.models.gpt import GPTForPretraining as RGPT

    from paddle_tpu_torch.jit import EvalStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu

    ref.seed(0)
    rm = RGPT(RConfig.tiny())
    pm = GPTForPretraining(GPTConfig.tiny(), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in rm.state_dict().items()}))
    pm.train()
    ids = np.random.default_rng(0).integers(0, GPTConfig.tiny().vocab_size, (4, 16))
    got = EvalStep(pm)(ids)
    assert pm.training and not got.requires_grad and got.dtype == torch.float32
    want = np.asarray(REvalStep(rm)(ref.to_tensor(ids)).numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_eval_step_over_a_mesh_is_one_process():
    import torch_dist_ranks

    from paddle_tpu_torch.jit import EvalStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.testing.dist import run_ranks

    pm = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=2)
    ids = np.random.default_rng(1).integers(0, GPTConfig.tiny().vocab_size, (4, 16))
    want = EvalStep(pm)(ids).numpy()
    outs = run_ranks(torch_dist_ranks.eval_step_dp, 2, _state(pm), ids)
    for out in outs:
        np.testing.assert_array_equal(out, want)
    with pytest.raises(TypeError, match="HybridCommunicateGroup"):
        EvalStep(pm, mesh=object())


class TestHapiTrainingHealth:
    @staticmethod
    def _model():
        torch.manual_seed(0)
        net = torch.nn.Sequential(port.nn.Linear(4, 4, device="cpu"), port.nn.ReLU(),
                                  port.nn.Linear(4, 2, device="cpu"))
        model = port.Model(net)
        model.prepare(port.optimizer.Adam(learning_rate=1e-2, parameters=net.parameters()),
                      port.nn.CrossEntropyLoss())
        return model

    @staticmethod
    def _batches(n, poison=()):
        rng = np.random.default_rng(0)
        out = []
        for i in range(n):
            x = rng.normal(size=(4, 4)).astype("float32")
            if i in poison:
                x[:] = np.nan
            out.append((x, np.zeros((4,), np.int64)))
        return out

    def test_stops_fit_on_divergence(self):
        """NaN inputs from some batch on make every loss non-finite; the
        callback stops fit instead of burning the remaining epochs."""
        model = self._model()
        cb = pcb.TrainingHealth(k_bad_steps=2, verbose=0)
        hist = model.fit(self._batches(8, poison=range(3, 8)), epochs=3, callbacks=[cb],
                         verbose=0)
        assert model.stop_training and len(hist) == 1

    def test_rolls_back_with_manager(self, tmp_path):
        from paddle_tpu_torch.distributed.resilience import CheckpointManager

        model = self._model()
        mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_k=3)
        cb = pcb.TrainingHealth(manager=mgr, k_bad_steps=2, checkpoint_every=2, verbose=0)
        model.fit(self._batches(8, poison=(4, 5)), epochs=1, callbacks=[cb], verbose=0)
        assert cb.monitor.rollbacks == 1
        assert not model.stop_training
        assert all(torch.isfinite(p).all() for p in model.parameters())


def test_metrics_logger_and_lr_scheduler_callbacks():
    from paddle_tpu_torch.observability import metrics

    net = PLeNet(device="cpu")
    sched = port.optimizer.lr.StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
    model = port.Model(net)
    model.prepare(port.optimizer.SGD(learning_rate=sched, parameters=net.parameters()),
                  port.nn.CrossEntropyLoss(), port.metric.Accuracy())
    model.fit(_mnist(PDataset, 32, 0), batch_size=16, epochs=1, verbose=0,
              callbacks=[pcb.LRScheduler(by_step=True)])
    assert sched.last_epoch == 2  # stepped once per train batch
    assert {"hapi.loss", "hapi.lr", "hapi.acc"} <= set(metrics.gauges("hapi."))
    assert metrics.find_histogram("hapi.step").count >= 2
    assert set(metrics.HAPI_GAUGES) <= set(metrics.gauges("hapi."))
    with pytest.raises(ValueError, match="exactly one"):
        pcb.LRScheduler(by_step=True, by_epoch=True)

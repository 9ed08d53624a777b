"""hapi's ``Model`` in the port (``paddle_tpu/hapi/model.py``; parity:
python/paddle/hapi/model.py: ``fit``/``evaluate``/``predict``/``save``/
``load`` after ``prepare(optimizer, loss, metrics, amp_configs)``).

``fit`` trains through one :class:`~paddle_tpu_torch.jit.TrainStep`
(``amp_level`` from ``amp_configs``, ``return_outputs`` when metrics are
set); ``evaluate`` and ``predict`` run an
:class:`~paddle_tpu_torch.jit.EvalStep`. The callbacks fire around the
steps with the reference's per-step semantics: the logs a callback sees at
step ``i`` hold step ``i``'s loss as a host float, so each step ends in one
host sync. A map-style dataset is wrapped in a
:class:`~paddle_tpu_torch.io.DataLoader` on the network's device (``batch_size``,
``shuffle``, ``drop_last``, ``num_workers``); any other iterable of
``(inputs, labels...)`` batches is used as it is. The step updates the
network's parameters in place, so there is nothing to sync back before
``save`` or ``evaluate`` (the reference's ``sync_to_model``). ``save``
writes ``<path>.pdparams`` (and ``<path>.pdopt``) in the reference's pickle
format (:mod:`paddle_tpu_torch.framework.io`), so either package loads the
other's files.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..framework.device import resolve_device
from ..framework.io import load as _load
from ..framework.io import save as _save
from .callbacks import config_callbacks


def _np(o):
    return o.detach().cpu().numpy() if isinstance(o, torch.Tensor) else np.asarray(o)


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        param = next(network.parameters(), None)
        self.device = param.device if param is not None else resolve_device(None)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp_level = None
        self._train_step = None
        self._eval_step = None
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else ([metrics] if metrics else [])
        if isinstance(amp_configs, str):
            self._amp_level = amp_configs
        elif isinstance(amp_configs, dict):
            self._amp_level = amp_configs.get("level", "O1")
        self._train_step = None
        self._eval_step = None
        return self

    # -- steps -------------------------------------------------------------
    def _loss_adapter(self):
        loss = self._loss

        def fn(outputs, *labels):
            outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
            return loss(*outs, *labels)

        return fn

    def _get_train_step(self):
        if self._train_step is None:
            from ..jit import TrainStep

            self._train_step = TrainStep(self.network, self._optimizer, self._loss_adapter(),
                                         amp_level=self._amp_level,
                                         return_outputs=bool(self._metrics))
        return self._train_step

    def _get_eval_step(self):
        if self._eval_step is None:
            from ..jit import EvalStep

            self._eval_step = EvalStep(self.network)
        return self._eval_step

    def _tensors(self, xs):
        return [torch.as_tensor(x, device=self.device) for x in _as_list(xs)]

    # -- single-batch eager APIs (reference parity) ------------------------
    def train_batch(self, inputs, labels=None):
        """One eager step (forward, backward, ``optimizer.step()``); the loss
        as a numpy array."""
        self.network.train()
        outputs = self.network(*self._tensors(inputs))
        losses = self._loss_adapter()(outputs, *self._tensors(labels))
        losses.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        return _np(losses)

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        outputs = self.network(*self._tensors(inputs))
        losses = self._loss_adapter()(outputs, *self._tensors(labels))
        return _np(losses), outputs

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        return self.network(*self._tensors(inputs))

    # -- data plumbing -----------------------------------------------------
    def _to_loader(self, data, batch_size, shuffle=False, drop_last=False, num_workers=0):
        if data is None:
            return None
        if hasattr(data, "__getitem__") and not hasattr(data, "batch_size") \
                and not isinstance(data, (list, tuple)):
            from ..io import DataLoader

            return DataLoader(data, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
                              num_workers=num_workers, device=self.device)
        return data  # already an iterable of batches (a DataLoader, a generator, ...)

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return batch[0], list(batch[1:])
        return batch, []

    # -- main loops --------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1, eval_freq=1,
            log_freq=10, save_dir=None, save_freq=1, callbacks=None, verbose=1, shuffle=True,
            drop_last=False, num_workers=0):
        """Train for ``epochs``; returns each epoch's mean loss."""
        loader = self._to_loader(train_data, batch_size, shuffle, drop_last, num_workers)
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs, steps=steps,
                                log_freq=log_freq, verbose=verbose,
                                metrics=[m.name() for m in self._metrics])
        if save_dir is not None:
            from .callbacks import ModelCheckpoint

            cbks.callbacks.append(ModelCheckpoint(save_freq, save_dir))
            cbks.callbacks[-1].set_model(self)
            cbks.callbacks[-1].set_params({})
        step_fn = self._get_train_step()
        self.network.train()
        self.stop_training = False
        history = []
        cbks.on_train_begin()
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            losses = []
            for i, batch in enumerate(loader):
                cbks.on_train_batch_begin(i)
                x, ys = self._split_batch(batch)
                metrics = step_fn(_as_list(x), ys)
                logs = {"loss": float(metrics["loss"]), "lr": float(metrics["lr"])}
                losses.append(logs["loss"])
                if self._metrics and "outputs" in metrics:
                    outs = metrics["outputs"]
                    for m in self._metrics:
                        m.update(*m.compute(outs, *ys))
                        logs[m.name()] = m.accumulate()
                cbks.on_train_batch_end(i, logs)
            epoch_logs = {"loss": float(np.mean(losses)) if losses else 0.0}
            for m in self._metrics:
                epoch_logs[m.name()] = m.accumulate()
            history.append(epoch_logs["loss"])
            cbks.on_epoch_end(epoch, epoch_logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, batch_size=batch_size, verbose=0,
                                          num_workers=num_workers)
                cbks.on_eval_end(eval_logs)
            if self.stop_training:
                break
        cbks.on_train_end({"loss": history[-1] if history else 0.0})
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=1, num_workers=0,
                 callbacks=None):
        """The mean loss and the metrics over ``eval_data``."""
        loader = self._to_loader(eval_data, batch_size, num_workers=num_workers)
        cbks = config_callbacks(callbacks, model=self,
                                steps=len(loader) if hasattr(loader, "__len__") else None,
                                log_freq=log_freq, verbose=verbose)
        eval_step = self._get_eval_step()
        for m in self._metrics:
            m.reset()
        losses = []
        cbks.on_eval_begin()
        for i, batch in enumerate(loader):
            cbks.on_eval_batch_begin(i)
            x, ys = self._split_batch(batch)
            outputs = eval_step(*_as_list(x))
            if self._loss is not None:
                with torch.no_grad():
                    losses.append(float(self._loss_adapter()(outputs, *self._tensors(ys))))
            for m in self._metrics:
                m.update(*m.compute(outputs, *ys))
            cbks.on_eval_batch_end(i, {"loss": losses[-1] if losses else 0.0})
        result = {"loss": float(np.mean(losses)) if losses else 0.0}
        for m in self._metrics:
            result[m.name()] = m.accumulate()
        cbks.on_eval_end(result)
        return result

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False, callbacks=None,
                verbose=1):
        """Each batch's outputs; with ``stack_outputs`` one host array per
        output field, the batches concatenated."""
        loader = self._to_loader(test_data, batch_size, num_workers=num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=0)
        eval_step = self._get_eval_step()
        outs = []
        cbks.on_predict_begin()
        for i, batch in enumerate(loader):
            cbks.on_predict_batch_begin(i)
            x, _ = self._split_batch(batch)
            outs.append(eval_step(*_as_list(x)))
            cbks.on_predict_batch_end(i)
        cbks.on_predict_end()
        if stack_outputs:
            # a multi-output network: one array per output field, as the
            # reference stacks each fetch apart
            if outs and isinstance(outs[0], (tuple, list)):
                return [np.concatenate([_np(o[j]) for o in outs], axis=0)
                        for j in range(len(outs[0]))]
            return [np.concatenate([_np(o) for o in outs], axis=0)]
        return outs

    # -- persistence -------------------------------------------------------
    def save(self, path, training=True):
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None and hasattr(self._optimizer, "state_dict"):
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Parameters (and buffers) from ``<path>.pdparams`` into the
        network in place; the optimizer's state from ``<path>.pdopt`` when
        it exists, unless ``reset_optimizer``."""
        params = path if path.endswith(".pdparams") else path + ".pdparams"
        state = _load(params, return_numpy=True)
        self.network.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()},
                                     strict=not skip_mismatch)
        self._train_step = None
        self._eval_step = None
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and os.path.exists(opt_path):
            self._optimizer.set_state_dict(_load(opt_path, return_numpy=True))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        n_params = sum(p.numel() for p in self.network.parameters())
        print(f"{type(self.network).__name__}: {n_params:,} parameters")
        return {"total_params": n_params}

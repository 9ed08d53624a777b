"""hapi's callback protocol in the port (``paddle_tpu/hapi/callbacks.py``;
parity: python/paddle/hapi/callbacks.py: Callback:180, CallbackList,
ProgBarLogger:280, ModelCheckpoint:450, LRScheduler:520, EarlyStopping:580),
plus the reference's ``MetricsLogger`` (the ``hapi.*`` series of the port's
metrics registry) and ``TrainingHealth`` (over the port's
``stability.HealthMonitor`` and ``distributed.resilience.CheckpointManager``).
The hooks run on the host between steps; the logs they see hold host
floats."""
from __future__ import annotations

import time

import numpy as np


class Callback:
    """Base class; subclasses override the hooks they need."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    # lifecycle hooks (names match the reference exactly)
    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None, model=None, params=None):
        self.callbacks = list(callbacks or [])
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Per-epoch progress + steps/sec (reference ProgBarLogger, without the
    terminal progress bar widget — one line per log_freq steps)."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._step = 0
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        if self.verbose and self.log_freq and self._step % self.log_freq == 0:
            ips = self._step / max(time.time() - self._t0, 1e-9)
            items = " - ".join(f"{k}: {float(np.asarray(v)):.4f}" for k, v in (logs or {}).items() if np.ndim(v) == 0)
            total = self.params.get("steps")
            print(f"step {self._step}/{total or '?'} - {items} - {ips:.1f} step/s")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = " - ".join(f"{k}: {float(np.asarray(v)):.4f}" for k, v in (logs or {}).items() if np.ndim(v) == 0)
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')} - {items}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = " - ".join(f"{k}: {float(np.asarray(v)):.4f}" for k, v in (logs or {}).items() if np.ndim(v) == 0)
            print(f"Eval - {items}")


class MetricsLogger(Callback):
    """Bridge ``Model.fit``/``evaluate`` into the observability spine
    (paddle_tpu_torch.observability): per-batch scalar logs become gauges
    (``hapi.loss``, ``hapi.lr``, …), batch latency feeds the ``hapi.step``
    histogram, and epoch/eval summaries are emitted as structured run-log
    events. Appended automatically by ``config_callbacks`` when
    ``FLAGS_monitor`` is on."""

    @staticmethod
    def _scalars(logs):
        return {k: float(np.asarray(v)) for k, v in (logs or {}).items()
                if np.ndim(v) == 0}

    def on_train_begin(self, logs=None):
        from ..observability import runlog

        self._t = None
        runlog.emit("fit_begin", epochs=self.params.get("epochs"),
                    steps=self.params.get("steps"))

    def on_train_batch_begin(self, step, logs=None):
        self._t = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        from ..framework.flags import flag
        from ..observability import metrics

        if not flag("FLAGS_monitor"):
            return
        if getattr(self, "_t", None) is not None:
            metrics.observe("hapi.step", time.perf_counter() - self._t)
        for k, v in self._scalars(logs).items():
            metrics.gauge_set(f"hapi.{k}", v)

    def on_epoch_end(self, epoch, logs=None):
        from ..observability import runlog

        runlog.emit("epoch", epoch=int(epoch), **self._scalars(logs))

    def on_eval_end(self, logs=None):
        from ..observability import runlog

        runlog.emit("eval", **self._scalars(logs))

    def on_train_end(self, logs=None):
        from ..observability import runlog

        runlog.emit("fit_end", **self._scalars(logs))


class ModelCheckpoint(Callback):
    """Save `<save_dir>/{epoch}` every save_freq epochs + `<save_dir>/final`
    (reference ModelCheckpoint semantics)."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.save_dir and self.model:
            self.model.save(f"{self.save_dir}/final")


class TrainingHealth(Callback):
    """Divergence guard for ``Model.fit`` (the ``stability`` wiring):
    watches the per-batch loss with a :class:`~paddle_tpu_torch.stability.
    HealthMonitor` (non-finite losses and sustained loss-EMA spikes count
    as bad steps). With a ``CheckpointManager`` the monitor periodically
    checkpoints the fitted TrainStep state (``checkpoint_every`` batches)
    and on divergence rewinds it via ``restore_latest`` — fit just keeps
    going with the restored weights. Without a manager (or when recovery
    is impossible) divergence stops training like EarlyStopping, instead
    of burning the rest of the epochs on NaN."""

    def __init__(self, manager=None, k_bad_steps=3, spike_factor=4.0,
                 spike_patience=5, ema_alpha=0.05, checkpoint_every=0,
                 lr_backoff=None, max_rollbacks=3, stop_on_divergence=True,
                 verbose=1):
        super().__init__()
        self.manager = manager
        self.stop_on_divergence = stop_on_divergence
        self.verbose = verbose
        self._kw = dict(k_bad_steps=k_bad_steps, spike_factor=spike_factor,
                        spike_patience=spike_patience, ema_alpha=ema_alpha,
                        checkpoint_every=checkpoint_every,
                        lr_backoff=lr_backoff, max_rollbacks=max_rollbacks)
        self.monitor = None

    def on_train_begin(self, logs=None):
        from ..stability import HealthMonitor

        self.monitor = HealthMonitor(manager=self.manager, **self._kw)

    def on_train_batch_end(self, step, logs=None):
        from ..stability import DivergenceError

        if self.monitor is None:
            return
        if self.monitor.train_step is None:
            # the fitted TrainStep exists only once fit() built it
            self.monitor.train_step = getattr(self.model, "_train_step", None)
        loss = (logs or {}).get("loss")
        if loss is None:
            return
        try:
            info = self.monitor.observe_loss(float(np.asarray(loss)))
        except DivergenceError as exc:
            if not self.stop_on_divergence:
                raise
            if self.model is not None:
                self.model.stop_training = True
            if self.verbose:
                print(f"TrainingHealth: stopping fit — {exc}")
            return
        if info is not None and self.verbose:
            print(f"TrainingHealth: rolled back to step "
                  f"{info['restored_step']} ({info['reason']})")


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (by_step or by_epoch). A
    ``TrainStep`` reads its rate at its own step count
    (``optimizer.lr_at``), as the reference's does; the schedule's
    ``last_epoch`` moves for eager users and for ``state_dict``."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step == by_epoch:
            raise ValueError("LRScheduler: exactly one of by_step/by_epoch")
        self.by_step = by_step

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if not self.by_step and s is not None:
            s.step()


class EarlyStopping(Callback):
    """Stop fit() when the monitored eval metric stops improving."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1, min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.verbose = verbose
        if mode == "auto":
            mode = "max" if "acc" in monitor.lower() else "min"
        self.mode = mode
        self.best = None
        self.wait = 0

    def _improved(self, value):
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_train_begin(self, logs=None):
        self.best = self.baseline
        self.wait = 0

    def on_eval_end(self, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        value = float(np.asarray(value))
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                if self.model is not None:
                    self.model.stop_training = True
                if self.verbose:
                    print(f"EarlyStopping: no {self.monitor} improvement for {self.wait} evals")


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None, log_freq=10, verbose=2, metrics=None, mode="train"):
    """Parity: hapi/callbacks.py config_callbacks — ensure a ProgBarLogger
    is present and bind model/params."""
    from ..framework.flags import flag

    cbks = list(callbacks or [])
    if verbose and not any(isinstance(c, ProgBarLogger) for c in cbks):
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if flag("FLAGS_monitor") and not any(isinstance(c, MetricsLogger) for c in cbks):
        cbks.append(MetricsLogger())
    params = {"epochs": epochs, "steps": steps, "verbose": verbose, "metrics": metrics or []}
    return CallbackList(cbks, model=model, params=params)

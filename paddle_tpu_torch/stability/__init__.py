"""Training stability of the port (``paddle_tpu/stability``): host-side
divergence detection and rollback.

The on-device half of the training-health guard lives in ``jit.TrainStep``
(``guard=True`` / ``FLAGS_train_guard``): one all-finite reduction over
loss+grads whose bad-step flag sets the param/opt/buffer update back on the
card, so a NaN/Inf gradient costs one wasted step instead of a poisoned
run. This module is the host-side half — the policy layer that consumes
the device-resident ``health`` metrics leaf (every N steps, no per-step
sync) and answers the failures the skip cannot:

- **Divergence** (Chowdhery et al. 2022 — PaLM's spike-rewind): a loss-EMA
  spike detector plus a consecutive-bad-step counter; on K consecutive bad
  steps or a sustained spike the :class:`HealthMonitor` rewinds to the
  newest valid checkpoint via ``CheckpointManager.restore_latest``, with
  optional LR backoff and a reshuffle hook for the data order.
- **Supervised loops**: with ``raise_on_divergence=True`` the monitor
  raises :class:`DivergenceFault` (a ``WorkerFault``), which
  ``run_resilient`` answers with restore-WITHOUT-save — the diverged state
  is never made durable.

Everything emits through the observability spine: ``bad_step`` /
``loss_spike`` / ``rollback`` run-log events, ``train_step.skipped`` and
``stability.rollbacks`` counters.

The monitor checkpoints and restores the ``TrainStep`` itself (written
whole, restored onto its mesh: :mod:`~paddle_tpu_torch.distributed.converter`).
The chaos injector's armed count is an attribute of the step, not part of
its state, so a rollback never re-arms it (the reference keeps it out of
the restore for the same reason).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..distributed.resilience import WorkerFault
from ..observability import runlog as _runlog
from ..observability.metrics import counter_inc as _counter_inc
from ..observability.metrics import gauge_set as _gauge_set

__all__ = ["HealthMonitor", "DivergenceError", "DivergenceFault",
           "state_to_savable", "state_from_savable"]


class DivergenceError(RuntimeError):
    """Training diverged and could not be recovered (no valid checkpoint,
    or the rollback budget is exhausted)."""


class DivergenceFault(WorkerFault):
    """Training diverged; raised by :class:`HealthMonitor` in
    ``raise_on_divergence`` mode for a supervisor (``run_resilient``) to
    answer with a checkpoint rewind. Subclasses ``WorkerFault`` so existing
    supervisors catch it; ``run_resilient`` special-cases it to NOT persist
    the diverged state before restoring."""


def state_to_savable(state: dict) -> dict:
    """TrainStep state -> checkpointable tree. The reference turns its typed
    PRNG keys into raw key data here; the port's state has none, so this is
    a shallow copy."""
    return dict(state)


def state_from_savable(state: dict) -> dict:
    """Inverse of :func:`state_to_savable`."""
    return dict(state)


class HealthMonitor:
    """Consumes TrainStep metrics (per-step or ``[K]``-stacked from
    ``run_steps``), detects divergence, and rewinds.

    Detection — a step is **bad** when the in-graph guard flagged it
    (``metrics["health"]["bad_step"]``) or its loss is non-finite; a step
    **spikes** when its loss exceeds ``spike_factor`` x the running loss EMA
    (spiking losses are quarantined from the EMA so a sustained spike cannot
    normalize itself away). ``k_bad_steps`` consecutive bad steps or
    ``spike_patience`` consecutive spikes trigger divergence handling.

    Handling — with a ``manager`` (``CheckpointManager``) and ``train_step``
    attached, the monitor rolls back: restore the newest valid checkpoint
    into the TrainStep (``restore_latest``), optionally back off the
    learning rate by ``lr_backoff`` (the step reads the new rate from its
    next update), bump the reshuffle seed and call ``reshuffle``
    so the replayed data order differs, and resume. With
    ``raise_on_divergence=True`` it raises :class:`DivergenceFault` instead
    (the ``run_resilient`` wiring). ``checkpoint_every`` > 0 also makes the
    monitor save the TrainStep every that-many observed steps, so the
    rollback target exists without separate wiring.

    Syncing — ``observe`` buffers device metrics and only materializes them
    on every ``check_every``-th call, keeping the hot loop free of host
    syncs; rollback latency is bounded by ``check_every`` dispatches.
    """

    def __init__(self, manager=None, train_step=None, *, k_bad_steps: int = 3,
                 spike_factor: float = 4.0, spike_patience: int = 5,
                 ema_alpha: float = 0.05, check_every: int = 1,
                 checkpoint_every: int = 0, lr_backoff: Optional[float] = None,
                 max_rollbacks: int = 3, reshuffle: Optional[Callable[[int], Any]] = None,
                 on_rollback: Optional[Callable[[dict], Any]] = None,
                 raise_on_divergence: bool = False):
        if k_bad_steps < 1:
            raise ValueError(f"k_bad_steps must be >= 1, got {k_bad_steps}")
        if spike_factor <= 1.0:
            raise ValueError(f"spike_factor must be > 1, got {spike_factor}")
        self.manager = manager
        self.train_step = train_step
        self.k_bad_steps = int(k_bad_steps)
        self.spike_factor = float(spike_factor)
        self.spike_patience = int(spike_patience)
        self.ema_alpha = float(ema_alpha)
        self.check_every = max(int(check_every), 1)
        self.checkpoint_every = int(checkpoint_every)
        self.lr_backoff = lr_backoff
        self.max_rollbacks = int(max_rollbacks)
        self.reshuffle = reshuffle
        self.on_rollback = on_rollback
        self.raise_on_divergence = raise_on_divergence
        self.step = 0                # host-observed step count
        self.rollbacks = 0
        self.reshuffle_seed = 0
        self.ema: Optional[float] = None
        self._bad_streak = 0
        self._spike_streak = 0
        self._last_skipped = 0.0     # guard's cumulative skip count last seen
        self._pending: list = []     # buffered (loss, health) device leaves

    # ---------------------------------------------------------------- feed
    @staticmethod
    def _unwrap(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        return np.atleast_1d(np.asarray(x))

    def observe(self, metrics: dict) -> Optional[dict]:
        """Feed one TrainStep metrics dict (``__call__`` or ``run_steps``
        output). Returns a rollback info dict when this call triggered a
        rollback, else None. May raise :class:`DivergenceFault` (in
        ``raise_on_divergence`` mode) or :class:`DivergenceError`."""
        self._pending.append((metrics.get("loss"), metrics.get("health")))
        if len(self._pending) < self.check_every:
            return None
        return self.flush()

    def observe_loss(self, loss) -> Optional[dict]:
        """Loss-only feed for paths without the in-graph guard (hapi)."""
        return self.observe({"loss": loss})

    # ------------------------------------------------------------- process
    def flush(self) -> Optional[dict]:
        """Materialize buffered metrics (the one host sync) and run
        detection. Returns rollback info if a rollback happened."""
        pending, self._pending = self._pending, []
        info = None
        for loss_leaf, health_leaf in pending:
            losses = self._unwrap(loss_leaf) if loss_leaf is not None else np.asarray([np.nan])
            if health_leaf is not None:
                bads = self._unwrap(health_leaf["bad_step"]).astype(bool)
                gnorms = self._unwrap(health_leaf["grad_norm"])
                skipped = self._unwrap(health_leaf["skipped"])
            else:
                bads = gnorms = skipped = None
            for i, loss in enumerate(np.asarray(losses, np.float64).ravel()):
                out = self._observe_one(
                    float(loss),
                    bad=bool(bads[i]) if bads is not None else None,
                    grad_norm=float(gnorms[i]) if gnorms is not None else None,
                    skipped_total=float(skipped[i]) if skipped is not None else None)
                if out is not None:
                    # rolled back: the rest of the buffer describes the
                    # now-discarded trajectory — drop it
                    return out
        return info

    def _observe_one(self, loss, bad=None, grad_norm=None, skipped_total=None):
        self.step += 1
        finite = np.isfinite(loss)
        is_bad = bool(bad) if bad is not None else not finite
        if is_bad:
            self._bad_streak += 1
            self._spike_streak = 0
            if skipped_total is not None and skipped_total > self._last_skipped:
                _counter_inc("train_step.skipped", skipped_total - self._last_skipped)
                self._last_skipped = skipped_total
            elif skipped_total is None:
                _counter_inc("train_step.skipped")
            _runlog.emit("bad_step", step=self.step, component="train_step",
                         loss=loss if finite else None, grad_norm=grad_norm,
                         streak=self._bad_streak)
        else:
            self._bad_streak = 0
            if skipped_total is not None:
                self._last_skipped = max(self._last_skipped, skipped_total)
            spike = (self.ema is not None
                     and loss > self.spike_factor * max(self.ema, 1e-12))
            if spike:
                self._spike_streak += 1
                if self._spike_streak == 1:
                    _runlog.emit("loss_spike", step=self.step, loss=loss,
                                 ema=self.ema, factor=self.spike_factor)
            else:
                self._spike_streak = 0
                # quarantine spiking losses: EMA tracks healthy loss only
                self.ema = (loss if self.ema is None
                            else (1 - self.ema_alpha) * self.ema + self.ema_alpha * loss)
        if self._bad_streak >= self.k_bad_steps:
            return self._diverged(f"{self._bad_streak} consecutive bad steps")
        if self._spike_streak >= self.spike_patience:
            return self._diverged(
                f"loss spike sustained {self._spike_streak} steps "
                f"(loss {loss:.4g} vs ema {self.ema:.4g})")
        if (self.checkpoint_every > 0 and self.manager is not None
                and self.train_step is not None
                and self.step % self.checkpoint_every == 0
                and self._bad_streak == 0):  # never persist mid-incident
            self.manager.save(self.train_step, self.step)
        return None

    # ------------------------------------------------------------ recovery
    def _diverged(self, reason: str):
        self._bad_streak = 0
        self._spike_streak = 0
        if self.raise_on_divergence:
            raise DivergenceFault(f"training diverged: {reason}")
        if self.manager is None or self.train_step is None:
            raise DivergenceError(
                f"training diverged ({reason}) and no CheckpointManager/"
                "TrainStep is attached to roll back to")
        return self.rollback(reason)

    def rollback(self, reason: str = "manual") -> dict:
        """Rewind the attached TrainStep to the newest valid checkpoint.
        LR backoff (if configured) sets the optimizer's rate, which the
        step reads at its next update (the reference rebuilds its compiled
        step for it)."""
        if self.rollbacks >= self.max_rollbacks:
            raise DivergenceError(
                f"training diverged ({reason}) but the rollback budget "
                f"({self.max_rollbacks}) is exhausted")
        # restored into the step in place (its chaos budget, not part of
        # the state, keeps its current value)
        restored = self.manager.restore_latest(target=self.train_step)
        if restored is None:
            raise DivergenceError(
                f"training diverged ({reason}) and no valid checkpoint "
                "exists to roll back to")
        _, ck_step = restored
        skipped = self.train_step.skipped
        if self.lr_backoff:
            opt = self.train_step.optimizer
            new_lr = float(opt.get_lr()) * float(self.lr_backoff)
            opt.set_lr(new_lr)
            _gauge_set("stability.lr", new_lr)
        self.rollbacks += 1
        self.reshuffle_seed += 1
        if self.reshuffle is not None:
            self.reshuffle(self.reshuffle_seed)
        self.ema = None  # re-seed the EMA at the restored loss level
        self._last_skipped = float(skipped)
        info = {"reason": reason, "restored_step": int(ck_step),
                "at_step": self.step, "rollbacks": self.rollbacks,
                "lr_backoff": self.lr_backoff,
                "reshuffle_seed": self.reshuffle_seed}
        _counter_inc("stability.rollbacks")
        _runlog.emit("rollback", step=self.step, restored_step=int(ck_step),
                     reason=reason, rollbacks=self.rollbacks)
        if self.on_rollback is not None:
            self.on_rollback(info)
        return info

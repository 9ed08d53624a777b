"""Flag registry of the port: the flags its ported modules read, with the
names and defaults of ``paddle_tpu/framework/flags.py``. A flag is
overridable from the environment (``FLAGS_*``) when it is defined."""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default, help_str: str = ""):
    env = os.environ.get(name)
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _REGISTRY[name] = value
    return value


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        if k not in _REGISTRY:
            raise KeyError(f"unknown flag {k!r}")
        _REGISTRY[k] = v


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    return {k: _REGISTRY[k] for k in flags}


def flag(name: str):
    return _REGISTRY[name]


define_flag("FLAGS_use_flash_attention", True, "use the hand-written flash-attention kernel where it takes the call")
define_flag("FLAGS_flash_flat", False, "route masked/GQA sdpa (impl flash_flat_gqa) and attention_core (impl flash_packed) to the flat flash kernels K3/K3b; off by default, as in the reference")
define_flag("FLAGS_kernel_overrides", "", "force kernel-registry implementations per kernel, e.g. 'attention_core=xla' (see paddle_tpu_torch.ops.registry); forced impls bypass availability predicates; unknown impl names raise at dispatch")
define_flag("FLAGS_remat_policy", "none", "default rematerialization policy for jit steps: any value but 'none' turns TrainStep's remat on")
define_flag("FLAGS_compile_cache_dir", "", "the reference's on-disk AOT executable cache for serving programs; the port has no compiled serving programs to store, and DecodeEngine raises while it is set (ROADMAP.md, Queue 1 item 4); observability/measured.py keeps measured step times under its measured/ subdirectory")

# telemetry and tracing (observability/runlog.py, trace.py, flightrec.py)
define_flag("FLAGS_monitor", True, "always-on runtime telemetry: run-log events and trace spans (spans become no-ops when off)")
define_flag("FLAGS_run_log_dir", "", "directory for the structured run log (JSONL, one run-<pid>.jsonl per process); empty keeps events only in the in-memory ring")
define_flag("FLAGS_run_log_max_mb", 64.0, "size-based run-log rotation: past this many MiB run-<pid>.jsonl is renamed to run-<pid>.1.jsonl and a fresh file opened; 0 disables rotation")
define_flag("FLAGS_run_log_keep", 16, "keep-last-k GC of stale run logs: opening a run log deletes dead pids' run-*.jsonl files beyond the newest k; 0 disables the GC")
define_flag("FLAGS_trace", True, "distributed tracing plane (observability/trace.py): trace ids propagated through the serving fleet and span run-log events; off allocates no ids and emits no spans")
define_flag("FLAGS_flightrec_events", 256, "crash flight recorder (observability/flightrec.py): dump the last N run-log ring events plus a metrics snapshot to flightrec-<pid>.json on a replica's death; 0 disables it")
# the judgment layer (observability/slo.py, regress.py), the live exporter
# (observability/exporter.py) and the runtime sanitizer (analysis/sanitizer.py)
define_flag("FLAGS_slo", False, "judgment layer (observability/slo.py + regress.py): install the default SLO spec set on the first serving or training tick (scheduler, fleet and process-fleet step, TrainStep.run_steps) and evaluate it on the FLAGS_slo_eval_every_s cadence: error budgets, multi-window burn-rate alerts ('alert' run-log events, /alerts, a degraded /healthz while a page fires) and the perf-regression sentinel; off keeps every tick hook a single flag check (an explicit slo.install() still works)")
define_flag("FLAGS_slo_eval_every_s", 5.0, "SLOMonitor evaluation cadence in seconds: the tick hooks evaluate the registered spec set at most this often; an evaluation reads the host metrics registries, never the device")
define_flag("FLAGS_slo_fast_window_s", 300.0, "fast burn-rate window (seconds): a burn rate >= the spec's page_burn sustained over it pages")
define_flag("FLAGS_slo_slow_window_s", 3600.0, "slow burn-rate window (seconds): the warn window, and the second gate of the page condition for ratio SLOs")
define_flag("FLAGS_metrics_port", 0, "live metrics export (observability/exporter.py): serve /metrics (Prometheus text), /healthz, /alerts and /snapshot (JSON) on this localhost port from a stdlib HTTP server that ServingFleet starts; 0 (default) disables the server")
define_flag("FLAGS_sanitize", False, "runtime sanitizer (analysis/sanitizer.py): in the port it arms only the host-ledger growth sentinel on the in-process and cross-process fleets' ticks (sanitizer.ledger_growth, a 'sanitizer' run-log event, a warning or under FLAGS_sanitize_strict a LedgerGrowthError); the reference's transfer guard, recompile-churn sentinel and donated-state poisoning in TrainStep and DecodeEngine are not ported (ROADMAP.md, Queue 1 item 15), so the flag checks nothing there")
define_flag("FLAGS_sanitize_strict", False, "escalate the sanitizer's ledger-growth warning to a raise; forwarded to replica processes with FLAGS_sanitize")
define_flag("FLAGS_sanitize_max_recompiles", 8, "the reference's recompile-churn threshold; nothing in the port reads it (the sentinel is not ported, ROADMAP.md Queue 1 item 15); forwarded to replica processes with FLAGS_sanitize, as in the reference")
# store hardening, the watchdog and the training guard (distributed/resilience.py, jit/train_step.py)
define_flag("FLAGS_collective_timeout_s", 0.0, "watchdog: report a cross-process collective still pending after this many seconds (0 = off)")
define_flag("FLAGS_train_guard", False, "run an all-finite check over loss+grads in every jit.TrainStep step and skip the param/opt/step update when it trips (state stays bitwise at its pre-step value); read at TrainStep construction")
define_flag("FLAGS_store_retry_jitter", True, "full jitter on the retry/RetryingStore exponential backoff: attempt i sleeps uniform(0, min(max_delay, base_delay*2**i)) from a seeded host stream instead of the deterministic cap")

# deterministic fault injection (testing/chaos.py): every hook is a no-op
# unless FLAGS_chaos is on; each knob below selects one failure mode
define_flag("FLAGS_chaos", False, "master switch for deterministic fault injection")
define_flag("FLAGS_chaos_crash_point", "", "named crash point to fire (e.g. 'checkpoint_save', 'train_step')")
define_flag("FLAGS_chaos_crash_at_step", -1, "step index at which the crash point fires (-1: first hit)")
define_flag("FLAGS_chaos_corrupt_ckpt", False, "flip bytes in the next published checkpoint (on-disk corruption)")
define_flag("FLAGS_chaos_store_drop_ops", "", "comma list of store ops to fail, each 'op' or 'op:key-prefix'")
define_flag("FLAGS_chaos_store_drop_count", -1, "fail only the first N matching store ops, then heal (-1: always)")
define_flag("FLAGS_chaos_store_delay_s", 0.0, "sleep this long before every store op")
define_flag("FLAGS_chaos_freeze_heartbeat", "", "comma list of elastic node ids whose heartbeat stops refreshing")
define_flag("FLAGS_chaos_nan_at_step", -1, "inject non-finite gradients at this TrainStep step index (-1 = off)")
define_flag("FLAGS_chaos_nan_steps", 1, "number of consecutive steps the NaN-gradient injection fires for")
define_flag("FLAGS_chaos_replica_kill_at", "", "kill a serving-fleet engine replica mid-stream: 'R:K' kills replica R after its K-th decode tick (once per replica per process)")
define_flag("FLAGS_chaos_replica_slow_ms", "", "per-tick latency for serving-fleet replicas: 'MS' for every replica, 'R:MS' for replica R")
define_flag("FLAGS_chaos_replica_sigkill_at", "", "SIGKILL a cross-process serving replica mid-stream: 'R:K' after the parent harvested its K-th tick message (once per replica per process)")
define_flag("FLAGS_chaos_replica_hang_ms", "", "wedge a cross-process replica without exiting: 'MS' (every replica) or 'R:MS' (one) stops its heartbeat for MS milliseconds after its first served tick (once per replica per process)")
define_flag("FLAGS_chaos_socket_drop_at", "", "kill the fast-path RPC socket mid-stream: 'R:K' (replica R) or 'K' (any) right before the K-th socket send (once per replica per process)")
define_flag("FLAGS_chaos_ingress_disconnect_at", -1, "drop the HTTP client connection after N streamed chunks (once per process; -1 = off)")
define_flag("FLAGS_chaos_net_delay_ms", 0.0, "sleep this many milliseconds before every fast-path socket frame send")

# the input pipeline (io/dataloader.py)
define_flag("FLAGS_dataloader_max_bad_batches", 0, "DataLoader: skip up to this many batches whose sample/collate raised (per iteration) instead of killing the iterator; 0 keeps the raise-through behavior")

"""Run-log reader of the port: ``python -m paddle_tpu_torch.observability
report <run.jsonl>``.

A copy of ``paddle_tpu/observability/__main__.py``: the same analysis
documents from the same events, so it reads either package's run logs.
Prints, from one structured run log (see :mod:`.runlog`):

- event counts per kind and the run's wall span,
- a per-phase time breakdown (every event carrying ``seconds``, grouped by
  event kind / component — compile vs step vs checkpoint vs dataloader),
- step-time percentiles (p50/p90/p99) and fused-dispatch stats,
- a training-stability section (bad-step rate, loss spikes, rollbacks,
  final loss scale) when the run produced any ``bad_step``/``loss_spike``/
  ``rollback``/``loss_scale`` events,
- a serving section (request rate, queue depth, prefill/decode time split,
  latency p50/p99 and time-to-first-token, prefix-cache hit rate, fused
  decode depth, chunked-prefill stall percentiles, cancellations and
  deadline expiries) when the run produced ``request`` events (the
  continuous-batching scheduler's stream),
- a serving-fleet section (replicas alive/dead with death reasons,
  requeues, load sheds, deadline hits, scale-outs, and per-replica
  request rates) when the run produced ``fleet`` events
  (inference/fleet.py's router + replica health stream),
- a kernel-selection section (picked vs fallback per registry kernel, with
  the per-implementation breakdown) when the run produced
  ``kernel_select`` events (the ops kernel registry's stream),
- an auto-parallel planner section (searches, plan-cache hits, candidate/
  pruned counts, search time, the last chosen plan, and cross-mesh
  checkpoint-reshard totals) when the run produced ``plan`` or ``reshard``
  events (distributed/planner.py + converter.py).

``--json`` emits the same analysis as one JSON object for tooling.

Fleet-wide: ``report --merge <dir>`` collects EVERY
``run-*.jsonl`` under a directory (rotated ``run-<pid>.1.jsonl``
generations included, replayed first), aligns each process's clock by the
offset its ``clock_sync`` event recorded against rank 0 (see
``trace.sync_clocks``), and renders one fleet-wide report on top of the
single-log analysis: per-process table, per-replica request lanes,
requeue edges (which request moved from which dead replica to which
survivor), cross-rank step skew percentiles, and per-trace event paths.
``trace <dir> --out trace.json`` renders the same merged, clock-aligned
timeline as a chrome trace (``chrome://tracing`` / Perfetto) with one
track per process. ``watch <dir>`` renders the live fleet console
(``--once`` for one frame), scraping every exporter the run logs name.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from collections import defaultdict
from typing import Dict, List


def load_events(path: str) -> List[dict]:
    events = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                print(f"[report] {path}:{lineno}: unparseable line skipped",
                      file=sys.stderr)
    return events


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = (q / 100.0) * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (idx - lo)


def analyze(events: List[dict]) -> dict:
    counts: dict = defaultdict(int)
    phase_seconds: dict = defaultdict(float)
    step_secs: List[float] = []
    step_count = 0
    for ev in events:
        kind = ev.get("event", "?")
        counts[kind] += 1
        secs = ev.get("seconds")
        if isinstance(secs, (int, float)):
            comp = ev.get("component")
            phase_seconds[f"{kind}[{comp}]" if comp else kind] += secs
        if kind == "step":
            step_count += int(ev.get("k", 1))
            if isinstance(secs, (int, float)):
                k = max(int(ev.get("k", 1)), 1)
                step_secs.extend([secs / k] * k)
    step_secs.sort()
    ts = [ev["ts"] for ev in events if isinstance(ev.get("ts"), (int, float))]
    wall = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    out = {
        "events": sum(counts.values()),
        "wall_seconds": wall,
        "counts": dict(sorted(counts.items())),
        "phase_seconds": dict(sorted(phase_seconds.items(),
                                     key=lambda kv: -kv[1])),
        "steps": step_count,
    }
    if step_secs:
        total = sum(step_secs)
        out["step_time"] = {
            "count": len(step_secs),
            "total_seconds": total,
            "mean_seconds": total / len(step_secs),
            "p50_seconds": _percentile(step_secs, 50),
            "p90_seconds": _percentile(step_secs, 90),
            "p99_seconds": _percentile(step_secs, 99),
            "steps_per_sec": (len(step_secs) / total) if total > 0 else None,
        }
    # training-stability events (bad_step / loss_spike / rollback from the
    # HealthMonitor + train guard, loss_scale from the fp16 GradScaler)
    bad = counts.get("bad_step", 0)
    spikes = counts.get("loss_spike", 0)
    rollbacks = counts.get("rollback", 0)
    scale_evs = [ev for ev in events if ev.get("event") == "loss_scale"]
    if bad or spikes or rollbacks or scale_evs:
        stability = {
            "bad_steps": bad,
            "bad_step_rate": (bad / step_count) if step_count else None,
            "loss_spikes": spikes,
            "rollbacks": rollbacks,
        }
        if scale_evs:
            stability["final_loss_scale"] = scale_evs[-1].get("value")
            stability["loss_scale_transitions"] = {
                r: sum(1 for ev in scale_evs if ev.get("reason") == r)
                for r in ("grow", "backoff")}
        out["stability"] = stability
    # serving section from the scheduler's request-event stream
    reqs = [ev for ev in events if ev.get("event") == "request"]
    if reqs:
        out["serving"] = _analyze_serving(reqs)
    # serving-fleet section from the fleet's membership/placement stream
    flt = [ev for ev in events if ev.get("event") == "fleet"]
    if flt:
        out["fleet"] = _analyze_fleet(flt)
    # HTTP front-door section from the ingress event stream
    ing = [ev for ev in events if ev.get("event") == "ingress"]
    if ing:
        out["ingress"] = _analyze_ingress(ing)
    # sharding-analysis section from the SPMD analyzer's shard_check events
    # (FLAGS_shard_check: one per analyzed specialization)
    checks = [ev for ev in events if ev.get("event") == "shard_check"]
    if checks:
        kinds: dict = defaultdict(int)
        codes: dict = defaultdict(int)
        for ev in checks:
            for k, n in (ev.get("collectives") or {}).items():
                kinds[k] += int(n)
            for c in ev.get("codes") or []:
                codes[c] += 1
        sev = defaultdict(int)
        for ev in checks:
            for s, n in (ev.get("diagnostics") or {}).items():
                sev[s] += int(n)
        peak = [ev["peak_bytes"] for ev in checks
                if isinstance(ev.get("peak_bytes"), (int, float))]
        out["sharding"] = {
            "programs_checked": len(checks),
            "collectives": dict(sorted(kinds.items())),
            "reshard_bytes_total": sum(int(ev.get("reshard_bytes") or 0)
                                       for ev in checks),
            "peak_bytes_max": max(peak) if peak else None,
            "diagnostics": dict(sev),
            "codes": dict(sorted(codes.items())),
            "programs": [{
                "label": ev.get("label"), "kind": ev.get("kind"),
                "component": ev.get("component"),
                "collectives": ev.get("collectives"),
                "reshard_bytes": ev.get("reshard_bytes"),
                "peak_bytes": ev.get("peak_bytes"),
                "codes": ev.get("codes"),
            } for ev in checks],
        }
    # dispatch-hygiene section: static findings (hygiene events, one per
    # dirty file) + runtime sanitizer trips (sanitizer events, one per
    # guard violation under FLAGS_sanitize)
    hyg = [ev for ev in events if ev.get("event") == "hygiene"]
    san = [ev for ev in events if ev.get("event") == "sanitizer"]
    if hyg or san:
        codes: dict = defaultdict(int)
        for ev in hyg:
            for c in ev.get("codes") or []:
                codes[c] += 1
        trips: dict = defaultdict(int)
        for ev in san:
            trips[ev.get("kind") or "unknown"] += 1
        out["hygiene"] = {
            "files_flagged": len(hyg),
            "findings": sum(int(ev.get("findings") or 0) for ev in hyg),
            "codes": dict(sorted(codes.items())),
            "sanitizer_trips": dict(sorted(trips.items())),
            "worst": sorted(
                ({"file": ev.get("file"), "findings": ev.get("findings"),
                  "codes": ev.get("codes")} for ev in hyg),
                key=lambda r: -(r["findings"] or 0))[:5],
        }
    # auto-parallel planner section from plan (search) + reshard
    # (cross-mesh checkpoint conversion) events
    plan_evs = [ev for ev in events if ev.get("event") == "plan"]
    reshard_evs = [ev for ev in events if ev.get("event") == "reshard"]
    if plan_evs or reshard_evs:
        planner = {
            "searches": len(plan_evs),
            "cache_hits": sum(1 for ev in plan_evs if ev.get("cached")),
            "candidates": sum(int(ev.get("candidates") or 0) for ev in plan_evs),
            "pruned": sum(int(ev.get("pruned") or 0) for ev in plan_evs),
            "search_ms_total": sum(float(ev.get("search_ms") or 0.0)
                                   for ev in plan_evs),
        }
        chosen = [ev.get("chosen") for ev in plan_evs if ev.get("chosen")]
        if chosen:
            planner["last_chosen"] = {
                k: chosen[-1].get(k) for k in
                ("label", "predicted_step_ms", "comm_bytes", "peak_bytes",
                 "feasible")}
        if reshard_evs:
            planner["reshards"] = len(reshard_evs)
            planner["reshard_bytes"] = sum(int(ev.get("bytes") or 0)
                                           for ev in reshard_evs)
            planner["reshard_seconds"] = sum(float(ev.get("seconds") or 0.0)
                                             for ev in reshard_evs)
        out["planner"] = planner
    # recommender section from the sharded-embedding exchange events (one
    # per ShardedEmbedding forward — per compiled program under jit) plus
    # checkpoint-rotation publication counts
    exch = [ev for ev in events if ev.get("event") == "embedding_exchange"]
    if exch:
        tables = sorted({(ev.get("vocab"), ev.get("dim")) for ev in exch})
        last = exch[-1]
        out["recsys"] = {
            "lookups": len(exch),
            "tables": [{"vocab": v, "dim": d} for v, d in tables],
            "shards": last.get("shards"),
            "ids_per_lookup": last.get("ids"),
            # one fused table -> one lookup per step; the latest event's
            # static payload is the per-step exchange cost
            "a2a_bytes_per_step": int(last.get("bytes_total") or 0),
            "exchange_capacity": last.get("capacity"),
            "checkpoints_rotated": counts.get("checkpoint_save", 0),
        }
    # kernel-selection section from the ops registry's kernel_select events
    # (one per distinct call signature: picked = a real kernel won,
    # fallback = the XLA composite served)
    sels = [ev for ev in events if ev.get("event") == "kernel_select"]
    if sels:
        kernels: dict = {}
        for ev in sels:
            row = kernels.setdefault(ev.get("kernel", "?"),
                                     {"picked": 0, "fallback": 0, "impls": {}})
            row["fallback" if ev.get("fallback") else "picked"] += 1
            impl = ev.get("impl", "?")
            row["impls"][impl] = row["impls"].get(impl, 0) + 1
        out["kernels"] = kernels
    return out


def _analyze_serving(reqs: List[dict]) -> dict:
    """Request-level serving stats from ``request`` events (submitted →
    admitted → finished) emitted by the continuous-batching scheduler."""
    by_status = defaultdict(list)
    for ev in reqs:
        by_status[ev.get("status", "?")].append(ev)
    finished = by_status.get("finished", [])
    ts = [ev["ts"] for ev in reqs if isinstance(ev.get("ts"), (int, float))]
    wall = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    out = {
        "submitted": len(by_status.get("submitted", [])),
        "admitted": len(by_status.get("admitted", [])),
        "finished": len(finished),
        "wall_seconds": wall,
        "requests_per_sec": (len(finished) / wall) if (finished and wall > 0) else None,
    }
    cancelled = len(by_status.get("cancelled", []))
    expired = len(by_status.get("deadline_exceeded", []))
    if cancelled or expired:
        out["cancelled"] = cancelled
        out["deadline_exceeded"] = expired
    depths = [ev["queue_depth"] for ev in reqs
              if isinstance(ev.get("queue_depth"), (int, float))]
    if depths:
        out["queue_depth"] = {"mean": sum(depths) / len(depths), "max": max(depths)}
    if finished:
        out["tokens_generated"] = sum(int(ev.get("new_tokens", 0)) for ev in finished)
        for field, key in (("total_seconds", "latency"), ("ttft_seconds", "ttft")):
            vals = sorted(ev[field] for ev in finished
                          if isinstance(ev.get(field), (int, float)))
            if vals:
                out[key] = {
                    "p50_seconds": _percentile(vals, 50),
                    "p99_seconds": _percentile(vals, 99),
                    "mean_seconds": sum(vals) / len(vals),
                }
        split = {}
        for field in ("queue_seconds", "prefill_seconds", "decode_seconds"):
            tot = sum(ev[field] for ev in finished
                      if isinstance(ev.get(field), (int, float)))
            split[field.replace("_seconds", "")] = tot
        out["phase_split_seconds"] = split
    # serving hot-path round 2: prefix reuse / fused depth / prefill stall
    admitted = by_status.get("admitted", [])
    prefixed = [ev for ev in admitted if isinstance(ev.get("prefix_tokens"), int)]
    if prefixed:
        hits = sum(1 for ev in prefixed if ev["prefix_tokens"] > 0)
        reused = sum(ev["prefix_tokens"] for ev in prefixed)
        prompted = sum(int(ev.get("prompt_tokens", 0)) for ev in finished) or None
        out["prefix_cache"] = {
            "hit_rate": hits / len(prefixed),
            "tokens_reused": reused,
            "token_reuse_rate": (reused / prompted) if prompted else None,
        }
    depths = sorted({int(ev["fuse"]) for ev in finished
                     if isinstance(ev.get("fuse"), int)})
    if depths:
        out["fuse_depths"] = depths
    # serving hot-path round 3: speculative decoding + quantized KV cache
    spec = [ev for ev in finished if isinstance(ev.get("spec_acceptance"), (int, float))]
    if spec:
        out["spec_decode"] = {
            "spec_k": sorted({int(ev["spec_k"]) for ev in spec
                              if isinstance(ev.get("spec_k"), int)}),
            "acceptance_rate": spec[-1]["spec_acceptance"],  # cumulative: last wins
        }
    kvb = [ev["kv_bytes_per_slot"] for ev in finished
           if isinstance(ev.get("kv_bytes_per_slot"), int)]
    if kvb:
        out["kv_cache"] = {"bytes_per_slot": max(kvb)}
    stalls = sorted(ev["stall_seconds"] for ev in admitted
                    if isinstance(ev.get("stall_seconds"), (int, float)))
    if stalls:
        out["prefill_stall"] = {
            "p50_seconds": _percentile(stalls, 50),
            "p99_seconds": _percentile(stalls, 99),
            "max_seconds": stalls[-1],
            "total_seconds": sum(stalls),
        }
    return out


def _analyze_fleet(flt: List[dict]) -> dict:
    """Fleet-level stats from ``fleet`` events (membership, placements,
    replica deaths, requeues, sheds, deadlines, scale-outs, completions)."""
    by_kind = defaultdict(list)
    for ev in flt:
        by_kind[ev.get("kind", "?")].append(ev)
    out = {
        "replica_deaths": len(by_kind.get("replica_dead", [])),
        "requeues": len(by_kind.get("requeue", [])),
        "sheds": len(by_kind.get("shed", [])),
        "deadline_hits": len(by_kind.get("deadline", [])),
        "scale_outs": sum(len(ev.get("replicas") or [1])
                          for ev in by_kind.get("scale_out", [])),
    }
    memb = by_kind.get("membership", [])
    if memb:
        out["replicas_alive"] = memb[-1].get("alive")
        out["replicas_dead"] = memb[-1].get("dead")
    deaths = by_kind.get("replica_dead", [])
    if deaths:
        out["death_reasons"] = {ev.get("replica"): ev.get("reason")
                                for ev in deaths}
    fin = by_kind.get("finished", [])
    if fin:
        ts = [ev["ts"] for ev in flt if isinstance(ev.get("ts"), (int, float))]
        wall = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
        per: dict = defaultdict(int)
        for ev in fin:
            per[ev.get("replica")] += 1
        out["finished"] = len(fin)
        out["wall_seconds"] = wall
        out["per_replica_rps"] = {
            r: (n / wall if wall > 0 else None) for r, n in sorted(per.items())}
        lats = sorted(ev["seconds"] for ev in fin
                      if isinstance(ev.get("seconds"), (int, float)))
        if lats:
            out["latency"] = {
                "p50_seconds": _percentile(lats, 50),
                "p99_seconds": _percentile(lats, 99),
            }
        replays = [ev for ev in fin if int(ev.get("attempts") or 1) > 1]
        out["finished_after_requeue"] = len(replays)
    return out


def _analyze_ingress(ing: List[dict]) -> dict:
    """HTTP front-door stats from ``ingress`` events (requests, responses,
    rejects by reason, disconnect cancels, drains)."""
    by_kind = defaultdict(list)
    for ev in ing:
        by_kind[ev.get("kind", "?")].append(ev)
    rejects = by_kind.get("reject", [])
    reasons: dict = defaultdict(int)
    for ev in rejects:
        reasons[ev.get("reason", "?")] += 1
    resp = by_kind.get("response", [])
    out = {
        "requests": len(by_kind.get("request", [])),
        "responses": len(resp),
        "rejects": dict(sorted(reasons.items())),
        "disconnect_cancels": len(by_kind.get("disconnect", [])),
        "idempotent_replays": sum(1 for ev in by_kind.get("request", [])
                                  if ev.get("idempotent")),
        "drains": len(by_kind.get("drain_begin", [])),
    }
    total = out["requests"] + len(rejects)
    out["reject_rate"] = (len(rejects) / total) if total else None
    lats = sorted(ev["seconds"] for ev in resp
                  if isinstance(ev.get("seconds"), (int, float)))
    if lats:
        out["latency"] = {
            "p50_seconds": _percentile(lats, 50),
            "p99_seconds": _percentile(lats, 99),
        }
    streamed = [ev for ev in resp if ev.get("stream")]
    if streamed:
        out["streamed"] = len(streamed)
        out["streamed_tokens"] = sum(int(ev.get("new_tokens") or 0)
                                     for ev in streamed)
    drains = by_kind.get("drain_done", [])
    if drains:
        out["drain_seconds"] = drains[-1].get("seconds")
        out["drain_cancelled"] = drains[-1].get("cancelled")
    return out


_RUN_LOG_NAME = re.compile(r"^run-(\d+)(\.1)?\.jsonl$")


def collect_run_logs(root: str) -> Dict[int, List[str]]:
    """Every ``run-<pid>.jsonl`` (+ rotated ``.1`` generation) under
    ``root``, recursively, grouped by pid — rotated generation first so a
    process's events replay in emission order."""
    by_pid: Dict[int, List[str]] = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            if _RUN_LOG_NAME.match(name):
                pid = int(_RUN_LOG_NAME.match(name).group(1))
                by_pid.setdefault(pid, []).append(os.path.join(dirpath, name))
    for paths in by_pid.values():
        paths.sort(key=lambda p: (not p.endswith(".1.jsonl"), p))
    return dict(sorted(by_pid.items()))


def load_processes(root: str) -> Dict[int, dict]:
    """Per-process event streams + the clock offset each process published
    (its ``clock_sync`` event; 0 when the process never synced)."""
    procs: Dict[int, dict] = {}
    for pid, paths in collect_run_logs(root).items():
        events: List[dict] = []
        for p in paths:
            events.extend(load_events(p))
        offset, rank = 0.0, None
        for ev in events:
            if ev.get("event") == "clock_sync":
                offset = float(ev.get("offset") or 0.0)
                rank = ev.get("rank")
        procs[pid] = {"events": events, "offset": offset, "rank": rank,
                      "files": [os.path.basename(p) for p in paths]}
    return procs


def merge_processes(procs: Dict[int, dict]) -> List[dict]:
    """One clock-aligned stream: every event stamped with its ``_pid`` and
    its ``ts`` shifted onto rank 0's clock, sorted by aligned time."""
    merged: List[dict] = []
    for pid, info in procs.items():
        for ev in info["events"]:
            aev = dict(ev)
            if isinstance(ev.get("ts"), (int, float)):
                aev["ts"] = ev["ts"] - info["offset"]
            aev["_pid"] = pid
            merged.append(aev)
    merged.sort(key=lambda e: e.get("ts") if isinstance(e.get("ts"), (int, float)) else 0.0)
    return merged


def _event_trace_ids(ev: dict) -> List[str]:
    tids = [ev["trace"]] if ev.get("trace") else []
    tids.extend(t for t in (ev.get("traces") or []) if t)
    return tids


def _path_label(ev: dict) -> str:
    kind = ev.get("event")
    if kind == "span":
        return str(ev.get("name"))
    if kind == "fleet":
        return f"fleet.{ev.get('kind')}"
    if kind == "request":
        return f"request.{ev.get('status')}"
    return str(kind)


_MAX_TRACE_PATHS = 100


def analyze_merged(root: str) -> dict:
    """The fleet-wide analysis over every run log under ``root``: the
    single-log :func:`analyze` on the merged clock-aligned stream, plus the
    cross-process sections (per-replica lanes, requeue edges, step skew,
    per-trace paths) only a merged view can produce."""
    procs = load_processes(root)
    merged = merge_processes(procs)
    out = {
        "processes": {pid: {
            "rank": info["rank"], "offset_seconds": info["offset"],
            "events": len(info["events"]), "files": info["files"],
        } for pid, info in procs.items()},
        "merged": analyze(merged) if merged else {},
    }
    # per-replica lanes: placed -> finished/deadline/cancelled intervals on
    # the aligned clock, the per-replica occupancy picture
    lanes: Dict[int, List[dict]] = defaultdict(list)
    open_by_id: Dict[int, tuple] = {}
    edges: List[dict] = []
    for ev in merged:
        if ev.get("event") != "fleet":
            continue
        kind = ev.get("kind")
        if kind == "placed":
            open_by_id[ev.get("id")] = (ev.get("replica"), ev.get("ts"))
        elif kind == "requeue":
            edges.append({"id": ev.get("id"), "from": ev.get("from_replica"),
                          "to": ev.get("replica"), "trace": ev.get("trace")})
        elif kind in ("finished", "deadline", "cancelled"):
            start = open_by_id.pop(ev.get("id"), (ev.get("replica"), None))
            lanes[ev.get("replica")].append({
                "id": ev.get("id"), "start_ts": start[1],
                "end_ts": ev.get("ts"), "status": kind,
                "attempts": ev.get("attempts"), "trace": ev.get("trace")})
    if lanes:
        out["lanes"] = {r: lanes[r] for r in sorted(lanes)}
    if edges:
        out["requeue_edges"] = edges
    # cross-rank step skew: for each step index reported by >= 2 processes,
    # the spread of aligned completion times — the straggler metric
    by_step: Dict[int, Dict[int, float]] = defaultdict(dict)
    for ev in merged:
        if (ev.get("event") == "step" and ev.get("step") is not None
                and isinstance(ev.get("ts"), (int, float))):
            by_step[ev["step"]][ev["_pid"]] = ev["ts"]
    spreads = sorted(max(d.values()) - min(d.values())
                     for d in by_step.values() if len(d) >= 2)
    if spreads:
        out["step_skew"] = {
            "steps_compared": len(spreads),
            "p50_seconds": _percentile(spreads, 50),
            "p99_seconds": _percentile(spreads, 99),
            "max_seconds": spreads[-1],
        }
    # per-trace event paths: every event carrying a trace id, in aligned
    # order — the submit->route->prefill->decode->requeue->delivery story
    paths: Dict[str, dict] = {}
    for ev in merged:
        for tid in _event_trace_ids(ev):
            row = paths.setdefault(tid, {"events": 0, "processes": [], "path": []})
            row["events"] += 1
            if ev["_pid"] not in row["processes"]:
                row["processes"].append(ev["_pid"])
            if len(paths) <= _MAX_TRACE_PATHS:
                row["path"].append(_path_label(ev))
    if paths:
        out["traces"] = {"count": len(paths), "paths": paths}
    return out


def chrome_trace_doc(root: str) -> dict:
    """The merged, clock-aligned timeline as a chrome-trace document: one
    track (pid) per process, complete events for everything that measured a
    duration (``seconds``; the event's ts is its END), instants otherwise."""
    procs = load_processes(root)
    merged = merge_processes(procs)
    stamps = [ev["ts"] for ev in merged if isinstance(ev.get("ts"), (int, float))]
    t0 = min(stamps) if stamps else 0.0
    events: List[dict] = []
    for pid, info in procs.items():
        label = (f"rank {info['rank']}" if info["rank"] is not None else "process")
        events.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                       "args": {"name": f"{label} (pid {pid})"}})
    arg_keys = ("trace", "span", "parent", "id", "step", "replica", "k",
                "kind", "status", "error", "chunk", "slot")
    for ev in merged:
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        kind = ev.get("event")
        base = {
            "name": _path_label(ev), "cat": kind, "pid": ev["_pid"],
            "tid": str(ev.get("component") or kind),
            "args": {k: ev[k] for k in arg_keys if ev.get(k) is not None},
        }
        secs = ev.get("seconds")
        if isinstance(secs, (int, float)) and secs > 0:
            base.update(ph="X", ts=(ts - t0 - secs) * 1e6, dur=secs * 1e6)
        else:
            base.update(ph="i", s="t", ts=(ts - t0) * 1e6)
        events.append(base)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def print_merged(root: str, m: dict) -> None:
    print(f"merged run logs: {root}")
    print("  processes:")
    for pid, p in m["processes"].items():
        rank = p["rank"] if p["rank"] is not None else "-"
        print(f"    pid {pid:<8} rank {rank!s:<3} offset "
              f"{p['offset_seconds'] * 1e3:+9.2f} ms   events {p['events']:<6} "
              f"files {', '.join(p['files'])}")
    sk = m.get("step_skew")
    if sk:
        print(f"  cross-rank step skew ({sk['steps_compared']} steps): "
              f"p50 {sk['p50_seconds'] * 1e3:.2f} ms   "
              f"p99 {sk['p99_seconds'] * 1e3:.2f} ms   "
              f"max {sk['max_seconds'] * 1e3:.2f} ms")
    lanes = m.get("lanes")
    if lanes:
        print("  per-replica lanes (aligned clock):")
        for rid, rows in lanes.items():
            spans = "  ".join(
                f"#{r['id']}[{r['status']}"
                + (f",x{r['attempts']}" if (r.get('attempts') or 1) > 1 else "")
                + "]" for r in rows)
            print(f"    replica {rid}: {spans}")
    for e in m.get("requeue_edges") or []:
        print(f"  requeue: request {e['id']} replica {e['from']} -> "
              f"{e['to']}" + (f"   trace {e['trace']}" if e.get("trace") else ""))
    tr = m.get("traces")
    if tr:
        print(f"  traces: {tr['count']}")
    if m.get("merged"):
        print_report("<merged>", m["merged"])


def print_report(path: str, a: dict) -> None:
    print(f"run log: {path}")
    print(f"  events: {a['events']}  wall: {a['wall_seconds']:.3f}s  "
          f"steps: {a['steps']}")
    print("  event counts:")
    for kind, n in a["counts"].items():
        print(f"    {kind:<22} {n}")
    if a["phase_seconds"]:
        total = sum(a["phase_seconds"].values())
        print("  per-phase time (instrumented host spans):")
        for phase, secs in a["phase_seconds"].items():
            pct = 100.0 * secs / total if total else 0.0
            print(f"    {phase:<28} {secs:9.4f}s  {pct:5.1f}%")
    st = a.get("step_time")
    if st:
        print("  step time (per training step, host dispatch span):")
        print(f"    mean {st['mean_seconds'] * 1e3:.3f} ms   "
              f"p50 {st['p50_seconds'] * 1e3:.3f} ms   "
              f"p90 {st['p90_seconds'] * 1e3:.3f} ms   "
              f"p99 {st['p99_seconds'] * 1e3:.3f} ms")
        if st.get("steps_per_sec"):
            print(f"    {st['steps_per_sec']:.2f} steps/sec (dispatch-span based)")
    sb = a.get("stability")
    if sb:
        print("  training stability:")
        rate = sb.get("bad_step_rate")
        print(f"    bad steps: {sb['bad_steps']}"
              + (f" ({rate * 100:.2f}% of steps)" if rate is not None else ""))
        print(f"    loss spikes: {sb['loss_spikes']}   "
              f"rollbacks: {sb['rollbacks']}")
        if "final_loss_scale" in sb:
            tr = sb.get("loss_scale_transitions", {})
            print(f"    loss scale: final {sb['final_loss_scale']:g} "
                  f"(grow x{tr.get('grow', 0)}, backoff x{tr.get('backoff', 0)})")
    sv = a.get("serving")
    if sv:
        print("  serving (continuous-batching request stream):")
        rps = sv.get("requests_per_sec")
        print(f"    requests: {sv['submitted']} submitted, {sv['admitted']} "
              f"admitted, {sv['finished']} finished"
              + (f"  ({rps:.2f} req/s)" if rps else ""))
        qd = sv.get("queue_depth")
        if qd:
            print(f"    queue depth: mean {qd['mean']:.2f}  max {qd['max']:.0f}")
        lat = sv.get("latency")
        if lat:
            print(f"    latency: p50 {lat['p50_seconds'] * 1e3:.2f} ms   "
                  f"p99 {lat['p99_seconds'] * 1e3:.2f} ms")
        tt = sv.get("ttft")
        if tt:
            print(f"    time to first token: p50 {tt['p50_seconds'] * 1e3:.2f} ms   "
                  f"p99 {tt['p99_seconds'] * 1e3:.2f} ms")
        sp = sv.get("phase_split_seconds")
        if sp:
            total = sum(sp.values()) or 1.0
            parts = "  ".join(f"{k} {v:.4f}s ({100 * v / total:.0f}%)"
                              for k, v in sp.items())
            print(f"    phase split: {parts}")
        if sv.get("tokens_generated") is not None:
            print(f"    tokens generated: {sv['tokens_generated']}")
        pc = sv.get("prefix_cache")
        if pc:
            rr = pc.get("token_reuse_rate")
            print(f"    prefix cache: {pc['hit_rate'] * 100:.0f}% of admissions hit, "
                  f"{pc['tokens_reused']} prompt tokens reused"
                  + (f" ({rr * 100:.0f}% of prompt tokens)" if rr is not None else ""))
        if sv.get("fuse_depths"):
            print(f"    fused decode depth: "
                  f"{'/'.join(str(d) for d in sv['fuse_depths'])} tokens/dispatch")
        sp = sv.get("spec_decode")
        if sp:
            print(f"    speculative decode: K="
                  f"{'/'.join(str(k) for k in sp['spec_k'])}   "
                  f"acceptance {sp['acceptance_rate'] * 100:.1f}%")
        kv = sv.get("kv_cache")
        if kv:
            print(f"    kv cache: {kv['bytes_per_slot']} bytes/slot")
        stall = sv.get("prefill_stall")
        if stall:
            print(f"    prefill stall: p50 {stall['p50_seconds'] * 1e3:.2f} ms   "
                  f"p99 {stall['p99_seconds'] * 1e3:.2f} ms   "
                  f"total {stall['total_seconds']:.4f}s")
        if sv.get("cancelled") or sv.get("deadline_exceeded"):
            print(f"    reclaimed: {sv.get('cancelled', 0)} cancelled, "
                  f"{sv.get('deadline_exceeded', 0)} deadline-expired")
    fl = a.get("fleet")
    if fl:
        print("  serving fleet (router + engine replicas):")
        alive = fl.get("replicas_alive")
        dead = fl.get("replicas_dead")
        if alive is not None:
            print(f"    replicas: {len(alive)} alive {alive}   "
                  f"{len(dead or [])} dead {dead or []}")
        print(f"    requeues: {fl['requeues']}   sheds: {fl['sheds']}   "
              f"deadline hits: {fl['deadline_hits']}   "
              f"scale-outs: {fl['scale_outs']}")
        for rid, reason in (fl.get("death_reasons") or {}).items():
            print(f"    replica {rid} died: {reason}")
        if fl.get("finished") is not None:
            line = (f"    finished: {fl['finished']} "
                    f"({fl.get('finished_after_requeue', 0)} after requeue)")
            lat = fl.get("latency")
            if lat:
                line += (f"   latency p50 {lat['p50_seconds'] * 1e3:.2f} ms"
                         f"  p99 {lat['p99_seconds'] * 1e3:.2f} ms")
            print(line)
        rps = fl.get("per_replica_rps")
        if rps:
            parts = "  ".join(
                f"r{rid} {v:.2f}/s" if v is not None else f"r{rid} -"
                for rid, v in rps.items())
            print(f"    per-replica throughput: {parts}")
    ig = a.get("ingress")
    if ig:
        print("  ingress (HTTP front door):")
        rej = "  ".join(f"{k} x{n}" for k, n in ig["rejects"].items()) or "none"
        rr = ig.get("reject_rate")
        print(f"    requests: {ig['requests']}   responses: {ig['responses']}   "
              f"rejects: {rej}"
              + (f" ({rr * 100:.1f}%)" if rr is not None else ""))
        print(f"    idempotent replays: {ig['idempotent_replays']}   "
              f"disconnect cancels: {ig['disconnect_cancels']}   "
              f"drains: {ig['drains']}")
        lat = ig.get("latency")
        if lat:
            print(f"    latency: p50 {lat['p50_seconds'] * 1e3:.2f} ms   "
                  f"p99 {lat['p99_seconds'] * 1e3:.2f} ms")
        if ig.get("streamed"):
            print(f"    streamed: {ig['streamed']} responses, "
                  f"{ig['streamed_tokens']} tokens")
        if ig.get("drain_seconds") is not None:
            print(f"    drain: {ig['drain_seconds']:.2f}s, "
                  f"{ig.get('drain_cancelled', 0)} cancelled at grace")
    sh = a.get("sharding")
    if sh:
        print("  sharding analysis (SPMD PTA2xx pre-flight, FLAGS_shard_check):")
        kinds = "  ".join(f"{k} x{n}" for k, n in sh["collectives"].items()) or "none"
        print(f"    programs checked: {sh['programs_checked']}   "
              f"collectives: {kinds}")
        line = (f"    est. reshard bytes/dispatch: "
                f"{sh['reshard_bytes_total']:,}")
        if sh.get("peak_bytes_max") is not None:
            line += (f"   peak per-device memory: "
                     f"{sh['peak_bytes_max'] / (1 << 20):.1f} MiB")
        print(line)
        dg = sh.get("diagnostics", {})
        if any(dg.values()):
            codes = "  ".join(f"{c} x{n}" for c, n in sh["codes"].items())
            print(f"    findings: {dg.get('error', 0)} error(s), "
                  f"{dg.get('warning', 0)} warning(s), "
                  f"{dg.get('info', 0)} info   [{codes}]")
        else:
            print("    findings: clean")
    hy = a.get("hygiene")
    if hy:
        print("  dispatch hygiene (PTA3xx static + FLAGS_sanitize runtime):")
        if hy.get("files_flagged"):
            codes = "  ".join(f"{c} x{n}" for c, n in hy["codes"].items())
            print(f"    static findings: {hy['findings']} across "
                  f"{hy['files_flagged']} file(s)   [{codes}]")
            for row in hy.get("worst") or []:
                print(f"      {row['file']}: {row['findings']} "
                      f"({', '.join(row.get('codes') or [])})")
        trips = hy.get("sanitizer_trips") or {}
        if trips:
            parts = "  ".join(f"{k} x{n}" for k, n in trips.items())
            print(f"    sanitizer trips: {parts}")
        if not hy.get("files_flagged") and not trips:
            print("    clean")
    pl = a.get("planner")
    if pl:
        print("  auto-parallel planner (plan search + elastic reshard):")
        print(f"    searches: {pl['searches']} ({pl['cache_hits']} from the "
              f"plan cache)   candidates: {pl['candidates']}   pruned: "
              f"{pl['pruned']}   search time: {pl['search_ms_total']:.1f} ms")
        ch = pl.get("last_chosen")
        if ch:
            pred = ch.get("predicted_step_ms")
            print(f"    chosen: {ch.get('label')}"
                  + (f"   predicted {pred:.3f} ms/step" if pred else "")
                  + f"   comm {int(ch.get('comm_bytes') or 0):,} B/step")
        if pl.get("reshards"):
            print(f"    checkpoint reshards: {pl['reshards']}   "
                  f"{pl['reshard_bytes']:,} bytes in "
                  f"{pl['reshard_seconds']:.4f}s")
    rc = a.get("recsys")
    if rc:
        print("  recommender (sharded-embedding exchange):")
        tables = "  ".join(f"[{t['vocab']}x{t['dim']}]"
                           for t in rc.get("tables", []))
        print(f"    lookups: {rc['lookups']}   tables: {tables or '-'}   "
              f"shards: {rc.get('shards')}")
        print(f"    ids/lookup: {rc.get('ids_per_lookup')}   "
              f"a2a bytes/step: {int(rc.get('a2a_bytes_per_step') or 0):,}   "
              f"capacity: {rc.get('exchange_capacity')}")
        if rc.get("checkpoints_rotated"):
            print(f"    checkpoints rotated: {rc['checkpoints_rotated']}")
    ks = a.get("kernels")
    if ks:
        print("  kernel selection (ops registry, one row per kernel):")
        for kernel, row in sorted(ks.items()):
            impls = "  ".join(f"{name} x{n}" for name, n in sorted(row["impls"].items()))
            print(f"    {kernel:<16} picked {row['picked']}  fallback "
                  f"{row['fallback']}   [{impls}]")


# --------------------------------------------------------------- watch verb
_WATCH_WINDOW_S = 60.0


def _scrape(address: str, path: str, timeout: float = 0.5):
    """Best-effort GET http://<address><path> → parsed JSON, or None."""
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://{address}{path}",
                                    timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except Exception:
        return None


def _watch_alert_key(ev: dict) -> str:
    if ev.get("event") == "perf_regression":
        return f"regress/{ev.get('kind')}/{ev.get('fingerprint')}"
    return f"slo/{ev.get('slo')}"


def build_watch_snapshot(root: str, window_s: float = _WATCH_WINDOW_S,
                         scrape: bool = True) -> dict:
    """One watch-console frame: tail every run log under ``root`` and
    (optionally) scrape each discovered exporter's /alerts + /healthz.

    The serving window anchors on the NEWEST event timestamp, not wall
    time, so a snapshot of a finished run still renders its last minute
    of traffic (the CI ``--once`` path)."""
    procs = load_processes(root)
    merged = merge_processes(procs)
    latest = max((e["ts"] for e in merged
                  if isinstance(e.get("ts"), (int, float))), default=0.0)
    cutoff = latest - window_s
    finished = [e for e in merged
                if e.get("event") == "request" and e.get("status") == "finished"
                and e.get("ts", 0.0) >= cutoff]
    lat = sorted(float(e["total_seconds"]) for e in finished
                 if e.get("total_seconds") is not None)
    ttft = sorted(float(e["ttft_seconds"]) for e in finished
                  if e.get("ttft_seconds") is not None)
    span = (min(window_s, latest - min(e["ts"] for e in finished))
            if finished else window_s)
    span = max(1.0, span)  # burst logs written in one flush stay sane
    serving = {
        "requests": len(finished),
        "rps": len(finished) / span if span > 0 else 0.0,
        "p50_ms": _percentile(lat, 50) * 1e3 if lat else None,
        "p99_ms": _percentile(lat, 99) * 1e3 if lat else None,
        "ttft_p50_ms": _percentile(ttft, 50) * 1e3 if ttft else None,
        "window_s": window_s,
    }
    # replica liveness: the newest membership event per process
    membership: Dict[int, dict] = {}
    for ev in merged:
        if ev.get("event") == "fleet" and ev.get("kind") == "membership":
            membership[ev["_pid"]] = {"alive": ev.get("alive") or [],
                                      "dead": ev.get("dead") or []}
    # firing alerts, replayed from the structured event stream: the last
    # state transition per alert key wins
    firing: Dict[str, dict] = {}
    for ev in merged:
        if ev.get("event") not in ("alert", "perf_regression"):
            continue
        key = _watch_alert_key(ev)
        if ev.get("state") == "cleared":
            firing.pop(key, None)
        else:
            firing[key] = ev
    # exporter discovery (metrics_exporter events) + live scrape
    exporters: Dict[int, dict] = {}
    for ev in merged:
        if ev.get("event") == "metrics_exporter" and ev.get("address"):
            exporters[ev["_pid"]] = {"address": ev["address"]}
    if scrape:
        for doc in exporters.values():
            alerts = _scrape(doc["address"], "/alerts")
            health = _scrape(doc["address"], "/healthz")
            doc["reachable"] = alerts is not None or health is not None
            if health is not None:
                doc["status"] = health.get("status",
                                           "ok" if health.get("ok") else "degraded")
            if alerts is not None:
                doc["firing"] = alerts.get("firing", 0)
                doc["page"] = alerts.get("page", 0)
                for a in alerts.get("alerts", []):
                    key = (f"slo/{a.get('slo')}" if a.get("slo")
                           else f"regress/{a.get('kind')}/{a.get('fingerprint')}")
                    firing.setdefault(key, a)
    # local SLO state (a monitor installed in THIS process — the bench and
    # the tests drive watch in-process): per-spec budget + burn table
    from . import slo as _slo

    mon = _slo.installed()
    slo_states = mon.states() if mon is not None else []
    return {"root": root, "latest_ts": latest,
            "processes": {pid: {"events": len(info["events"]),
                                "rank": info["rank"]}
                          for pid, info in procs.items()},
            "serving": serving, "membership": membership,
            "alerts": sorted(firing.values(),
                             key=lambda a: str(a.get("severity"))),
            "slo": slo_states, "exporters": exporters}


def _fmt_ms(v) -> str:
    return "-" if v is None else f"{v:.1f}ms"


def render_watch(snap: dict) -> str:
    """Render one snapshot as the fleet console frame (plain text)."""
    lines: List[str] = []
    ts = time.strftime("%H:%M:%S", time.localtime(snap["latest_ts"] or time.time()))
    nev = sum(p["events"] for p in snap["processes"].values())
    lines.append(f"paddle_tpu_torch watch — {snap['root']} @ {ts} "
                 f"({len(snap['processes'])} process(es), {nev} events)")
    s = snap["serving"]
    lines.append(f"  serving   rps {s['rps']:6.1f}   p50 {_fmt_ms(s['p50_ms']):>9} "
                 f"  p99 {_fmt_ms(s['p99_ms']):>9}   ttft p50 {_fmt_ms(s['ttft_p50_ms']):>9} "
                 f"  ({s['requests']} finished / {s['window_s']:g}s window)")
    for pid, m in sorted(snap["membership"].items()):
        lines.append(f"  fleet     pid {pid}: {len(m['alive'])} alive "
                     f"{sorted(m['alive'])}  {len(m['dead'])} dead {sorted(m['dead'])}")
    for doc in snap["exporters"].values():
        status = doc.get("status", "unreachable" if doc.get("reachable") is False else "?")
        extra = (f"  firing {doc['firing']} (page {doc['page']})"
                 if "firing" in doc else "")
        lines.append(f"  exporter  {doc['address']}  healthz={status}{extra}")
    for st in snap["slo"]:
        sev = st["severity"] or "ok"
        sli = "-" if st["sli"] is None else f"{st['sli']:.4g}"
        lines.append(f"  slo       {st['slo']:<28} [{sev:>4}]  sli {sli:>8} "
                     f" ({st['objective']})  burn {st['burn_fast']:.2f}/{st['burn_slow']:.2f} "
                     f" budget {st['budget_remaining'] * 100:.0f}%")
    if snap["alerts"]:
        for a in snap["alerts"]:
            name = a.get("slo") or a.get("fingerprint")
            detail = (f"sli {a.get('sli'):.4g} vs {a.get('objective')}"
                      if a.get("sli") is not None and a.get("objective")
                      else f"{a.get('before')} -> {a.get('after')}")
            lines.append(f"  ALERT     [{a.get('severity', '?'):>8}] {name}: {detail} "
                         f" burn {a.get('burn_fast', 0) or 0:.2f}/{a.get('burn_slow', 0) or 0:.2f}")
    else:
        lines.append("  alerts    none firing")
    return "\n".join(lines)


def _cmd_watch(args) -> int:
    if not collect_run_logs(args.path):
        print(f"[watch] no run-*.jsonl under {args.path}", file=sys.stderr)
        return 1
    if args.once:
        snap = build_watch_snapshot(args.path, args.window,
                                    scrape=not args.no_scrape)
        print(render_watch(snap))
        return 0
    try:
        while True:
            snap = build_watch_snapshot(args.path, args.window,
                                        scrape=not args.no_scrape)
            # clear screen + home, then one frame — a live console
            sys.stdout.write("\x1b[2J\x1b[H" + render_watch(snap) + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.observability")
    sub = p.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="summarize a run-log JSONL file "
                                        "(or, with --merge, a directory)")
    rep.add_argument("path", help="run-log .jsonl written under "
                                  "FLAGS_run_log_dir (a directory with --merge)")
    rep.add_argument("--merge", action="store_true",
                     help="PATH is a run-log directory: merge every "
                          "run-*.jsonl under it, clock-aligned via each "
                          "process's clock_sync offset")
    rep.add_argument("--json", action="store_true", help="emit the analysis as JSON")
    tr = sub.add_parser("trace", help="render a merged chrome trace from a "
                                      "run-log directory")
    tr.add_argument("path", help="run-log directory (FLAGS_run_log_dir)")
    tr.add_argument("--out", default="trace.json",
                    help="output chrome-trace path (default: trace.json)")
    w = sub.add_parser("watch", help="live fleet console: serving rps/p99/"
                                     "TTFT, SLO burn + budget, replica "
                                     "liveness, firing alerts")
    w.add_argument("path", help="run-log directory (FLAGS_run_log_dir)")
    w.add_argument("--once", action="store_true",
                   help="render one snapshot and exit (CI-able)")
    w.add_argument("--interval", type=float, default=2.0,
                   help="refresh period in seconds (default: 2)")
    w.add_argument("--window", type=float, default=_WATCH_WINDOW_S,
                   help="serving-stats window in seconds (default: 60)")
    w.add_argument("--no-scrape", action="store_true",
                   help="skip scraping discovered exporters' /alerts+/healthz")
    args = p.parse_args(argv)
    if args.cmd == "watch":
        return _cmd_watch(args)
    if args.cmd == "trace":
        doc = chrome_trace_doc(args.path)
        n = sum(1 for ev in doc["traceEvents"] if ev.get("ph") != "M")
        if not n:
            print(f"[trace] no events under {args.path}", file=sys.stderr)
            return 1
        with open(args.out, "w") as f:
            json.dump(doc, f)
        print(f"[trace] wrote {n} events from "
              f"{len(collect_run_logs(args.path))} process(es) to {args.out}")
        return 0
    if args.merge:
        m = analyze_merged(args.path)
        if not m["processes"]:
            print(f"[report] no run-*.jsonl under {args.path}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(m, indent=2))
        else:
            print_merged(args.path, m)
        return 0
    events = load_events(args.path)
    if not events:
        print(f"[report] no events in {args.path}", file=sys.stderr)
        return 1
    a = analyze(events)
    if args.json:
        print(json.dumps(a, indent=2))
    else:
        print_report(args.path, a)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Launcher of the port (``paddle_tpu/distributed/launch/main.py``). See
the package docstring.

Reference call stack being replaced: launch/main.py:18 ``launch()`` →
context.Context → CollectiveController.run → watch() (controllers/
controller.py) and ElasticManager.watch (fleet/elastic/manager.py:577).
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional


def _connect_store(host, port, is_master, world_size):
    """The launcher's TCPStore at ``host:port``: hosted here on the rank-0
    node, else connected to (retried while the master comes up)."""
    from ..store import TCPStore

    deadline = time.monotonic() + 60.0
    while True:
        try:
            return TCPStore(host=host, port=port, is_master=is_master,
                            world_size=world_size, timeout=60.0)
        except (ConnectionError, OSError):
            if is_master or time.monotonic() > deadline:
                raise
            time.sleep(0.2)


class WorkerProc:
    def __init__(self, rank: int, proc: subprocess.Popen, log_path: Optional[str]):
        self.rank = rank
        self.proc = proc
        self.log_path = log_path


class LaunchContext:
    def __init__(self, args, script_args):
        self.args = args
        self.script_args = script_args


class CollectiveController:
    """Spawns + watches the local slice of a collective job (reference
    controllers/collective.py). One process per local slot; global ranks are
    node_rank * nproc_per_node + i."""

    def __init__(self, ctx: LaunchContext):
        self.ctx = ctx
        self.procs: List[WorkerProc] = []

    def _env_for(self, local_rank: int, nnodes=None, node_rank=None) -> dict:
        a = self.ctx.args
        nnodes = a.nnodes if nnodes is None else nnodes
        node_rank = a.rank if node_rank is None else node_rank
        rank = node_rank * a.nproc_per_node + local_rank
        world = nnodes * a.nproc_per_node
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_MASTER": a.master,
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_NNODES": str(nnodes),
            "FLAGS_selected_devices": str(local_rank),
        })
        if a.devices:
            env["CUDA_VISIBLE_DEVICES"] = a.devices
        # the worker imports the package this launcher runs from
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        return env

    def spawn(self, nnodes=None, node_rank=None):
        a = self.ctx.args
        base = (a.rank if node_rank is None else node_rank) * a.nproc_per_node
        self.procs = []
        for i in range(a.nproc_per_node):
            log_path = None
            stdout = None
            if a.log_dir:
                os.makedirs(a.log_dir, exist_ok=True)
                log_path = os.path.join(a.log_dir, f"worker.{base + i}.log")
                stdout = open(log_path, "ab")
            cmd = [sys.executable, "-u", self.ctx.args.training_script] + self.ctx.script_args
            proc = subprocess.Popen(cmd, env=self._env_for(i, nnodes, node_rank), stdout=stdout, stderr=subprocess.STDOUT if stdout else None)
            self.procs.append(WorkerProc(base + i, proc, log_path))

    def poll(self):
        """(still_running, failed_ranks, done)"""
        failed, running = [], 0
        for w in self.procs:
            rc = w.proc.poll()
            if rc is None:
                running += 1
            elif rc != 0:
                failed.append(w.rank)
        return running, failed, running == 0 and not failed

    def terminate(self, sig=signal.SIGTERM, grace=5.0):
        for w in self.procs:
            if w.proc.poll() is None:
                try:
                    w.proc.send_signal(sig)
                except OSError:
                    pass
        t0 = time.time()
        while time.time() - t0 < grace and any(w.proc.poll() is None for w in self.procs):
            time.sleep(0.1)
        for w in self.procs:
            if w.proc.poll() is None:
                w.proc.kill()
        for w in self.procs:
            w.proc.wait()

    def watch(self, interval=0.5, tick=None) -> int:
        """Block until all workers exit; on any failure terminate the rest.
        Returns 0 on success, first failing signal/code otherwise. ``tick``
        (if given) is called each poll; if it returns a non-None value the
        watch stops and returns it (elastic membership interrupts)."""
        while True:
            running, failed, done = self.poll()
            if failed:
                self.terminate()
                return 1
            if done:
                return 0
            if tick is not None:
                r = tick()
                if r is not None:
                    return r
            time.sleep(interval)


class ElasticManager:
    """Fixed-world elastic loop (reference fleet/elastic/manager.py:131):
    when a worker dies, tear the job down and relaunch the whole collective
    — membership changes restart the world, training resumes from the
    user's own checkpoints."""

    def __init__(self, controller: CollectiveController, max_restarts: int):
        self.controller = controller
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, interval=0.5) -> int:
        self.controller.spawn()
        while True:
            rc = self.controller.watch(interval)
            if rc == 0:
                return 0
            if self.restarts >= self.max_restarts:
                print(f"[launch] worker failed; restart budget ({self.max_restarts}) exhausted", file=sys.stderr)
                return rc
            self.restarts += 1
            print(f"[launch] worker failed; elastic restart {self.restarts}/{self.max_restarts}", file=sys.stderr)
            self.controller.terminate()
            self.controller.spawn()


class ElasticMembershipManager:
    """True elasticity (reference ElasticManager watch loop,
    fleet/elastic/manager.py:577): TCPStore-heartbeat membership, HOLD on
    join/leave, RESTART with rescaled node ranks when the alive set settles
    inside the allowed np range. Training scripts resume from their own
    checkpoints (the reference contract)."""

    def __init__(self, controller: CollectiveController, np_range, max_restarts=10,
                 heartbeat_interval=0.5, node_timeout=3.0):
        from ..elastic import ElasticNode

        self.controller = controller
        self.min_np, self.max_np = np_range
        self.max_restarts = max_restarts
        a = controller.ctx.args
        host, port = a.master.rsplit(":", 1)
        # port map: <master> itself is the workers' torch.distributed
        # rendezvous store (env.py); +1 stays free, as in the reference; the
        # membership registry takes +2.
        # The node with --rank 0 hosts it; others connect (reference: etcd).
        self.store = _connect_store(host, int(port) + 2, a.rank == 0, a.nnodes)
        self.node = ElasticNode(self.store, heartbeat_interval, node_timeout)
        self.restarts = 0

    def run(self, interval=0.3) -> int:
        """Watch and relaunch until the job ends. SIGTERM is a graceful
        departure: the local workers are stopped and the node leaves the
        membership at once (its peers rescale without waiting for the
        heartbeat to go stale); the launcher then exits 143."""
        def leave(signum, frame):
            raise SystemExit(128 + signum)

        prior = None
        if threading.current_thread() is threading.main_thread():
            prior = signal.signal(signal.SIGTERM, leave)
        try:
            return self._run(interval)
        finally:
            self.controller.terminate()
            self.node.leave()
            if prior is not None:
                signal.signal(signal.SIGTERM, prior)

    def _run(self, interval) -> int:
        members = self.node.wait_for(self.min_np, self.max_np)
        while True:
            if self.node.node_id not in members:
                members = self.node.wait_for(self.min_np, self.max_np)
                continue
            nnodes = len(members)
            node_rank = members.index(self.node.node_id)
            print(f"[launch][elastic] membership={members} -> nnodes={nnodes} "
                  f"node_rank={node_rank}", file=sys.stderr, flush=True)
            self.controller.spawn(nnodes=nnodes, node_rank=node_rank)

            cur = members

            def membership_tick():
                # any membership change → HOLD (terminate + settle + respawn;
                # below-min worlds simply keep waiting inside wait_for)
                if self.node.alive_nodes() != cur:
                    return 100
                return None

            rc = self.controller.watch(interval, tick=membership_tick)
            if rc == 0:
                return 0
            self.controller.terminate()
            if rc != 100:  # genuine worker failure, not a membership event
                if self.restarts >= self.max_restarts:
                    print(f"[launch][elastic] restart budget ({self.max_restarts}) exhausted", file=sys.stderr)
                    return rc
                self.restarts += 1
            # HOLD → settle → RESTART with rescaled ranks
            members = self.node.wait_for(self.min_np, self.max_np)


class ServeController(CollectiveController):
    """``--serve``: every worker slot hosts one cross-process serving
    replica (``paddle_tpu_torch.inference.procfleet``'s ``CHILD_CMD``)
    instead of a training script. The rank-0 node hosts the fleet TCPStore at
    ``--master``; replicas connect to it, register store membership
    (``procfleet/<ns>/members_n`` + their heartbeat key), and idle until a
    serving front adopts them via ``ProcServingFleet.attach(master, ns=ns)``.
    The positional argument is a JSON spec file::

        {"ns": "serve", "model": {"seed": 0, "config": {...GPTConfig kwargs}},
         "engine_kwargs": {"max_batch_slots": 2, ...}, "beat_interval": 0.05,
         "device": "cpu"}

    (no ``device``: the replicas run on the card, and raise without one).

    A front-end ``shutdown()`` drains every replica (exit 0), so
    ``watch()`` returns 0 and the launcher exits clean."""

    def __init__(self, ctx: LaunchContext, spec: dict):
        super().__init__(ctx)
        self.spec = dict(spec)
        self.store = None

    def host_store(self):
        a = self.ctx.args
        if a.rank != 0:
            return
        host, port = a.master.rsplit(":", 1)
        self.store = _connect_store(host, int(port), True, 1)

    def spawn(self, nnodes=None, node_rank=None):
        import json

        from ...inference.procfleet import (CHILD_CMD, SPEC_ENV, child_env,
                                            current_torch_config)

        a = self.ctx.args
        base = (a.rank if node_rank is None else node_rank) * a.nproc_per_node
        self.procs = []
        for i in range(a.nproc_per_node):
            rid = base + i
            spec = dict(self.spec)
            spec.setdefault("ns", "serve")
            spec.setdefault("torch_config", current_torch_config())
            spec.update({"rid": rid, "endpoint": a.master})
            # trainer id 0 is the serving front (the attach() parent);
            # replicas take 1..N so trace/span id streams decorrelate
            env = child_env({SPEC_ENV: json.dumps(spec),
                             "PADDLE_TRAINER_ID": str(rid + 1)})
            log_path = None
            stdout = None
            if a.log_dir:
                os.makedirs(a.log_dir, exist_ok=True)
                log_path = os.path.join(a.log_dir, f"replica.{rid}.log")
                stdout = open(log_path, "ab")
            proc = subprocess.Popen(CHILD_CMD, env=env, stdout=stdout,
                                    stderr=subprocess.STDOUT if stdout else None)
            self.procs.append(WorkerProc(rid, proc, log_path))


def _serve(ns, script_args) -> int:
    import json

    spec = {}
    if ns.training_script:
        with open(ns.training_script) as f:
            spec = json.load(f)
    controller = ServeController(LaunchContext(ns, script_args), spec)
    controller.host_store()
    try:
        controller.spawn()
        print(f"[launch][serve] {ns.nproc_per_node} replica(s) on node "
              f"{ns.rank}; store endpoint {ns.master} ns "
              f"{spec.get('ns', 'serve')!r} — attach with "
              f"ProcServingFleet.attach({ns.master!r})",
              file=sys.stderr, flush=True)
        if ns.http is not None and ns.rank == 0:
            return _serve_http(ns, spec, controller)
        return controller.watch()
    finally:
        if controller.store is not None:
            try:
                controller.store.close()
            except OSError:
                pass


def _serve_http(ns, spec, controller) -> int:
    """``--serve --http PORT``: rank 0 also runs the front end — adopt the
    replicas it just spawned (``ProcServingFleet.attach``) and put a
    :class:`~...inference.ingress.ServingIngress` in front. SIGTERM drains
    the ingress gracefully (finish in-flight, then shut the fleet down) and
    the launcher exits 0. The front end runs on the spec's ``device`` (the
    card unless it says ``"cpu"``) with its ``engine_kwargs``, as the
    replicas do."""
    from ...inference.ingress import ServingIngress
    from ...inference.procfleet import ProcServingFleet

    fleet = ProcServingFleet.attach(
        ns.master, replicas=ns.nnodes * ns.nproc_per_node,
        ns=spec.get("ns", "serve"),
        boot_timeout=float(spec.get("boot_timeout", 120.0)),
        device=spec.get("device"), **spec.get("engine_kwargs", {}))
    ingress = ServingIngress(fleet, port=ns.http)
    print(f"[launch][serve] ingress on {ingress.url} "
          f"(POST /v1/generate, GET /healthz)", file=sys.stderr, flush=True)
    try:
        rc = ingress.serve_until_drained()
    finally:
        fleet.shutdown()
    return rc


def _parser():
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.distributed.launch", allow_abbrev=False, description="multi-host collective launcher (reference launch/main.py parity)")
    p.add_argument("--nnodes", type=int, default=1, help="number of nodes (hosts)")
    p.add_argument("--nproc_per_node", type=int, default=1, help="worker processes per node (one per card)")
    p.add_argument("--rank", type=int, default=int(os.environ.get("PADDLE_NODE_RANK", "0")), help="this node's rank")
    p.add_argument("--master", type=str, default=os.environ.get("PADDLE_MASTER", "127.0.0.1:49175"), help="rendezvous host:port (rank-0 node)")
    p.add_argument("--log_dir", type=str, default=None, help="per-worker log directory")
    p.add_argument("--devices", "--gpus", type=str, default=None, help="CUDA_VISIBLE_DEVICES for the workers")
    p.add_argument("--elastic_retries", type=int, default=0, help="relaunch the collective up to N times on worker failure")
    p.add_argument("--elastic_np", type=str, default=os.environ.get("PADDLE_ELASTIC_NP"), help="elastic node range 'min:max' (or 'n'): membership-managed launch with rescaling")
    p.add_argument("--elastic_timeout", type=float, default=3.0, help="heartbeat staleness (s) before a node is considered gone")
    p.add_argument("--serve", action="store_true", help="boot cross-process serving replicas (paddle_tpu_torch.inference.procfleet) instead of a training script; the positional argument is the fleet spec JSON (model config + engine kwargs), rank 0 hosts the store at --master, and a front-end adopts the fleet with ProcServingFleet.attach")
    p.add_argument("--http", type=int, default=None, metavar="PORT", help="with --serve: rank 0 also attaches the fleet and runs the HTTP ingress (ServingIngress) on PORT; SIGTERM drains gracefully and exits 0")
    p.add_argument("training_script", type=str)
    # everything after the script is the script's own (never read as a
    # launcher option, abbreviated or not)
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p


def launch(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ns = _parser().parse_args(argv)
    script_args = ns.script_args
    if ns.serve:
        return _serve(ns, script_args)
    ctx = LaunchContext(ns, script_args)
    controller = CollectiveController(ctx)
    if ns.elastic_np:
        from ..elastic import parse_np_range

        return ElasticMembershipManager(
            controller, parse_np_range(ns.elastic_np),
            max_restarts=ns.elastic_retries or 10,
            node_timeout=ns.elastic_timeout).run()
    if ns.elastic_retries > 0:
        return ElasticManager(controller, ns.elastic_retries).run()
    controller.spawn()
    return controller.watch()


def main():
    sys.exit(launch())

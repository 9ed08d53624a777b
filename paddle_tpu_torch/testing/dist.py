"""Run a function on every rank of a fresh ``torch.distributed`` world.

    results = run_ranks(fn, 2, x, device="cpu")

spawns ``world`` processes (``torch.multiprocessing``, start method
``spawn``) that join one world over a free local port (gloo on the CPU;
``backend`` names another: ``run_ranks(fn, 8, device="cuda:0",
backend="gloo")`` puts 8 ranks on one card, which NCCL refuses), each with
``OMP_NUM_THREADS=1`` (several torch
processes with a thread per core each run many times slower), calls
``fn(*args)`` on every rank after :func:`~paddle_tpu_torch.distributed.env.init_parallel_env`,
and returns the ranks' results in rank order. ``fn`` and its results must
pickle, so ``fn`` lives at the top level of a module that the children
can import. A rank that raises fails the call with its traceback; past
``timeout`` seconds every rank is killed and the call raises
``TimeoutError``.
"""
from __future__ import annotations

import os
import pickle
import queue as _queue
import socket
import time
import traceback


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, device, backend, args, results):
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    try:
        import torch
        import torch.distributed as dist

        from ..distributed.env import init_parallel_env

        torch.set_num_threads(1)
        init_parallel_env(backend=backend, device=device)
        out = fn(*args)
        dist.barrier()
        dist.destroy_process_group()
        # pickled here: a tensor in the result then travels by value, not as
        # a shared-memory handle that dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world, *args, device="cpu", backend=None, timeout=120.0):
    """``[fn(*args) on rank 0, ..., on rank world - 1]``, each rank a process
    of one ``torch.distributed`` world on ``device``."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    prior = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # read by each child at its start
    try:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, port, device, backend, args, results),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
    finally:
        if prior is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = prior
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {world - len(out)} of {world} ranks did not "
                                   f"finish within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in out]
                if dead:
                    raise RuntimeError(f"run_ranks: rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]

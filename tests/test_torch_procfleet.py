"""The port's cross-process serving fleet (``paddle_tpu_torch.inference.procfleet``)
over replica subprocesses on the CPU (``device="cpu"``), at ``GPTConfig.tiny()``.

Children rebuild the weights from the seed and must compute bitwise what
the port's in-process fleet computes: through a real SIGKILL mid-decode
(exactly once, streaming included), a hang caught by the stale-beat sweep,
a socket drop that degrades to the store, the store transport alone, and
replicas started by hand and adopted with ``attach``. Sampling is on, so
the tokens depend on every request's seed and position. Faults fire at
tick and message counts; waits that normally take milliseconds have limits
of a minute or more.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.framework.flags import get_flags, set_flags
from paddle_tpu_torch.inference import FleetDrainedError, ProcServingFleet, ServingFleet
from paddle_tpu_torch.inference.procfleet import (
    SPEC_ENV,
    apply_torch_config,
    child_env,
    current_torch_config,
    replica_main,
)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.observability import flightrec
from paddle_tpu_torch.testing import chaos

KW = dict(max_batch_slots=2, max_seq_len=64, prefill_chunk=8, fuse=2, do_sample=True)


@pytest.fixture(scope="module", autouse=True)
def _one_thread_children():
    """Each child takes one intra-op thread: several torch processes with a
    thread per core each would oversubscribe the CPU many times over."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    prev = get_flags(["FLAGS_run_log_dir", "FLAGS_compile_cache_dir"])
    yield
    set_flags(prev)
    chaos.reset()


def _prompts(n, lens=(5, 9, 3, 12, 7, 11)):
    rng = np.random.default_rng(42)
    return [rng.integers(0, 512, (lens[i % len(lens)],)) for i in range(n)]


@pytest.fixture(scope="module")
def want():
    """The port's in-process fleet on the same seed-0 weights: the tokens
    every cross-process run must give, by request (max_new_tokens 6,
    request i with seed i)."""
    model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=0).eval()
    fleet = ServingFleet(model, replicas=2, **KW)
    prompts = _prompts(6)
    fids = [fleet.submit(p, max_new_tokens=6, seed=i) for i, p in enumerate(prompts)]
    done = fleet.run()
    return [list(done[f].tokens) for f in fids]


def _fleet(**kw):
    return ProcServingFleet(GPTConfig.tiny(), model_seed=0, replicas=2, device="cpu",
                            **{**KW, "heartbeat_timeout": 60.0, **kw})


def _serve(fleet, n, stream_first=False):
    prompts = _prompts(n)
    fids, chunks = [], None
    if stream_first:
        stream = fleet.submit(prompts[0], max_new_tokens=6, seed=0, stream=True)
        fids.append(stream.fid)
    fids += [fleet.submit(p, max_new_tokens=6, seed=i) for i, p in enumerate(prompts)
             if i >= len(fids)]
    if stream_first:
        chunks = list(stream)
    fleet.run(timeout_s=300)
    return fids, chunks


@pytest.fixture(scope="module")
def pfleet():
    fleet = _fleet()
    yield fleet
    fleet.shutdown()


# ------------------------------------------------------------ fault-free
def test_children_equal_the_in_process_fleet_bitwise(pfleet, want):
    fids, chunks = _serve(pfleet, 6, stream_first=True)
    assert all(pfleet.requests[f].status == "finished" for f in fids)
    assert [list(pfleet.requests[f].tokens) for f in fids] == want
    assert chunks and all(chunks) and [t for c in chunks for t in c] == want[0]
    assert len({pfleet.requests[f].replica for f in fids}) == 2
    tr = pfleet.stats()["per_replica"][0]["transport"]
    assert tr["socket"] and tr["socket_msgs"] > 0 and tr["fallbacks"] == 0


def test_children_report_counters_and_zero_kernel_launches(pfleet):
    counters = pfleet.child_counters()
    assert sorted(counters) == [0, 1]
    for c in counters.values():
        # each child built its program signatures (the heartbeat's warm-up
        # counter); the port has no AOT cache to load them from
        assert c["compiles"] > 0 and c["aot_cache_hits"] == 0
        kernels = {k: v for k, v in c.items() if k.startswith("kernels.")}
        assert len(kernels) == 6 and not any(kernels.values())
    st = pfleet.stats()
    assert all(p["pid"] and p["pid"] != os.getpid() for p in st["per_replica"].values())
    assert pfleet.transport_lag()["out_backlog"] >= 0.0


def test_cancel_reaches_the_child(pfleet):
    """A cancel sent right behind its submit on the same ordered channel
    ends the request cancelled, short of its 50 tokens."""
    p = _prompts(1)[0]
    fid = pfleet.submit(p, max_new_tokens=50, seed=3, replica=1)
    assert pfleet.cancel(fid) is True
    pfleet.run(timeout_s=300)
    freq = pfleet.requests[fid]
    assert freq.status == "cancelled" and len(freq.tokens) < 50
    assert pfleet.cancel(fid) is False


def test_overload_sheds_on_the_parent_ledger(pfleet):
    from paddle_tpu_torch.inference import FleetOverloadError

    pfleet.max_queue_depth = 2
    try:
        pfleet.submit(_prompts(1)[0], max_new_tokens=2)
        pfleet.submit(_prompts(1)[0], max_new_tokens=2)
        with pytest.raises(FleetOverloadError) as ei:
            pfleet.submit(_prompts(1)[0], max_new_tokens=2)
        assert (ei.value.queued, ei.value.limit, ei.value.replicas_alive) == (2, 2, 2)
        pfleet.run(timeout_s=300)
    finally:
        pfleet.max_queue_depth = 64


# ------------------------------------------------------------------ faults
def test_sigkill_mid_decode_exactly_once_streaming(want, tmp_path):
    """A real kill -9 of replica 1 after its first tick message: every
    request, the streamed one too, finishes once with the in-process
    tokens; the parent dumps a flight record naming the dead replica and
    its in-flight requests; the children's run logs land beside the
    parent's."""
    set_flags({"FLAGS_run_log_dir": str(tmp_path)})
    flightrec.reset()
    with chaos.inject(FLAGS_chaos_replica_sigkill_at="1:1"):
        with _fleet() as fleet:
            fids, chunks = _serve(fleet, 5, stream_first=True)
            st = fleet.stats()
            got = [list(fleet.requests[f].tokens) for f in fids]
    assert st["dead"] == [1] and st["alive"] == [0]
    assert "rc=-9" in st["per_replica"][1]["death_reason"]
    assert st["requeues"] >= 1
    assert all(fleet.requests[f].status == "finished" for f in fids)
    assert got == want[:5]
    assert [t for c in chunks for t in c] == want[0]
    recs = [json.load(open(tmp_path / f)) for f in os.listdir(tmp_path)
            if f.startswith("flightrec-")]
    dead = [d for d in recs if d["reason"] == "replica_death"]
    assert dead and dead[0]["context"]["replica"] == 1 and dead[0]["context"]["inflight"]
    logs = [f for f in os.listdir(tmp_path) if f.startswith("run-") and f.endswith(".jsonl")]
    assert len(logs) >= 3  # the parent and both children


def test_hang_without_exit_detected_by_stale_beat(want):
    """Replica 1 stops beating for two minutes after its first served tick
    while its process stays up: the 5 s stale-beat sweep declares it dead,
    reaps it, and its work finishes on replica 0 with the same tokens."""
    with chaos.inject(FLAGS_chaos_replica_hang_ms="1:120000"):
        with _fleet(heartbeat_timeout=5.0) as fleet:
            fids, _ = _serve(fleet, 4)
            st = fleet.stats()
            got = [list(fleet.requests[f].tokens) for f in fids]
    assert st["dead"] == [1]
    assert "heartbeat lost" in st["per_replica"][1]["death_reason"]
    assert got == want[:4]


def test_socket_drop_mid_decode_degrades_to_the_store(want):
    with chaos.inject(FLAGS_chaos_socket_drop_at="1:2"):
        with _fleet() as fleet:
            fids, chunks = _serve(fleet, 4, stream_first=True)
            st = fleet.stats()
            got = [list(fleet.requests[f].tokens) for f in fids]
    assert st["dead"] == []
    assert got == want[:4] and [t for c in chunks for t in c] == want[0]
    tr = st["per_replica"][1]["transport"]
    assert tr["fallbacks"] >= 1 or tr["store_msgs"] > 0


def test_store_transport_alone_gives_the_same_tokens(want):
    with _fleet(use_sockets=False) as fleet:
        fids, _ = _serve(fleet, 6)
        st = fleet.stats()
        got = [list(fleet.requests[f].tokens) for f in fids]
    assert got == want
    for p in st["per_replica"].values():
        assert not p["transport"]["socket"] and p["transport"]["socket_msgs"] == 0
        assert p["transport"]["store_msgs"] > 0


def test_all_replicas_dead_raises_drained_with_lost_fids():
    with _fleet() as fleet:
        for rep in fleet.replicas.values():
            os.kill(rep.pid, signal.SIGKILL)
        for rep in fleet.replicas.values():
            rep.proc.wait(timeout=60)
        fids = [fleet.submit(p, max_new_tokens=6, seed=i) for i, p in enumerate(_prompts(3))]
        with pytest.raises(FleetDrainedError) as ei:
            for _ in range(1000):
                fleet.step()
                time.sleep(0.01)
        assert sorted(ei.value.lost) == sorted(fids)
        with pytest.raises(FleetDrainedError):
            fleet.submit(_prompts(1)[0], max_new_tokens=4)


# ---------------------------------------------------------- attach mode
_CHILD = ("import sys; from paddle_tpu_torch.inference.procfleet import replica_main; "
          "rc = replica_main(); "
          "print('FOREIGN', sorted(m for m in sys.modules "
          "if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))); sys.exit(rc)")


def test_attach_adopts_replicas_started_by_hand(want):
    """Two replicas started by hand under one ns (``spawn=False``) are
    adopted by ``attach``, serve the in-process tokens, drain on
    ``shutdown`` and exit 0; neither loaded jax or paddle_tpu."""
    store = TCPStore("127.0.0.1", 0, is_master=True, timeout=60.0)
    store.set("__obs__/0/epoch", repr(time.time()))
    ns = "attach-t"
    procs = []
    try:
        for rid in range(2):
            spec = {"rid": rid, "ns": ns, "endpoint": f"127.0.0.1:{store.port}",
                    "model": {"seed": 0, "config": GPTConfig.tiny().to_dict()},
                    "engine_kwargs": KW, "device": "cpu", "beat_interval": 0.05}
            env = child_env({SPEC_ENV: json.dumps(spec), "PADDLE_TRAINER_ID": str(rid + 1)})
            procs.append(subprocess.Popen([sys.executable, "-u", "-c", _CHILD], env=env,
                                          stdout=subprocess.PIPE, text=True))
        fleet = ProcServingFleet.attach(f"127.0.0.1:{store.port}", 2, ns=ns, device="cpu",
                                        heartbeat_timeout=60.0, boot_timeout=180.0, **KW)
        try:
            assert sorted(fleet.replicas) == [0, 1]
            assert all(rep.proc is None for rep in fleet.replicas.values())
            fids, _ = _serve(fleet, 6)
            assert [list(fleet.requests[f].tokens) for f in fids] == want
        finally:
            fleet.shutdown()
        outs = [p.communicate(timeout=120)[0] for p in procs]
        assert [p.returncode for p in procs] == [0, 0]
        assert all("FOREIGN []" in out for out in outs), outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        store.close()


def test_attach_structured_errors():
    store = TCPStore("127.0.0.1", 0, is_master=True, timeout=60.0)
    try:
        with pytest.raises(TimeoutError, match="no members"):
            ProcServingFleet.attach(f"127.0.0.1:{store.port}", ns="gone", boot_timeout=1.0,
                                    device="cpu")
    finally:
        store.close()
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(ConnectionError):
        ProcServingFleet.attach(f"127.0.0.1:{port}", boot_timeout=1.0, device="cpu")


# ------------------------------------------------ devices and numerics
def test_without_cuda_and_without_device_the_fleet_and_a_child_raise():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProcServingFleet(GPTConfig.tiny(), replicas=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replica_main({"rid": 0, "ns": "x", "endpoint": "127.0.0.1:1"})


def test_compile_cache_dir_raises_before_spawning():
    set_flags({"FLAGS_compile_cache_dir": "/nonexistent"})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _fleet()


def test_torch_numerics_settings_travel_in_the_spec():
    prev = current_torch_config()
    try:
        for cfg in ({"float32_matmul_precision": "high", "cuda_matmul_allow_tf32": True,
                     "cudnn_allow_tf32": False},
                    {"float32_matmul_precision": "highest", "cuda_matmul_allow_tf32": False,
                     "cudnn_allow_tf32": True}):
            apply_torch_config(cfg)
            assert current_torch_config() == cfg
    finally:
        apply_torch_config(prev)
    assert current_torch_config() == prev
    env = child_env({})
    assert env["PYTHONPATH"].split(os.pathsep)[0] == os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    assert env.get("CUDA_VISIBLE_DEVICES") == os.environ.get("CUDA_VISIBLE_DEVICES")
    assert env["FLAGS_chaos"] == "0"

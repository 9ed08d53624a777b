"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``)
on the CPU, as ``tests/test_launch.py`` and ``tests/test_elastic.py`` drive
the reference's: real subprocesses over gloo.

- a two-worker collective job; a worker's death answered by
  ``--elastic_retries`` (both workers run twice); a failure without it
  propagating;
- the elastic scale-in of ``tests/test_elastic.py:121-171`` on the port's
  elastic GPT worker (``examples/elastic_gpt_torch.py``): two launchers
  (``--nnodes 2 --nproc_per_node 1 --elastic_np 1:2``, ranks 0 and 1)
  train the tiny GPT at sdp 2 with ZeRO-2, AMP O2, a checkpoint every
  step; the second node leaves (SIGTERM: its launcher stops its worker and
  leaves the membership), the first relaunches at world 1, which restores
  the sdp-2 checkpoint through the converter (its state gathered back is
  bitwise the checkpoint's) and trains 2 more steps whose losses are
  bitwise those of one process that loads the same checkpoint; the world-2
  losses are within rtol 1e-4 of one process's plain steps on the whole
  batch (measured: 0 at the first step, 9.5e-6 at the second: bf16
  compute on half batches, their f32 gradients averaged); every step
  logs each rank's kernel launches (none on the CPU);
- ``--serve``: the launcher boots 2 tiny replicas, ``ProcServingFleet.attach``
  adopts them and serves the in-process engine's tokens, and the launcher
  exits 0 after ``shutdown()``; with ``--http PORT`` it boots 1 replica and
  its own front end (``ServingIngress``), which answers a ``POST
  /v1/generate`` with the in-process engine's tokens and drains on SIGTERM
  (exit 0).

These run in well under a minute together, so none is marked slow (the
reference's are: each of its workers imports JAX).
"""
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "examples", "elastic_gpt_torch.py")
WORLD2_RTOL = 1e-4


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def _launch(args, cwd, **kw):
    return subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch.distributed.launch", *args],
                            cwd=cwd, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, **kw)


DP_SCRIPT = """
import sys
import torch
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed.env import ParallelEnv, get_rank, get_world_size, init_parallel_env
init_parallel_env(device="cpu")
assert get_world_size() == 2 and ParallelEnv().local_rank == get_rank()
t = torch.full((4,), float(get_rank() + 1))
C.all_reduce(t)
open(f"done.{get_rank()}", "w").write(repr(t.tolist()))
"""


def test_launch_two_process_gloo_job(tmp_path):
    (tmp_path / "train.py").write_text(DP_SCRIPT)
    p = _launch(["--nnodes", "1", "--nproc_per_node", "2", "--master",
                 f"127.0.0.1:{_free_port()}", "train.py"], str(tmp_path))
    out, _ = p.communicate(timeout=120)
    assert p.returncode == 0, out
    assert (tmp_path / "done.0").read_text() == (tmp_path / "done.1").read_text() == \
        repr([3.0] * 4)


ELASTIC_SCRIPT = """
import os, time
rank = int(os.environ["PADDLE_TRAINER_ID"])
marker = f"attempt.{rank}"
n = int(open(marker).read()) if os.path.exists(marker) else 0
open(marker, "w").write(str(n + 1))
if rank == 1 and n == 0:
    time.sleep(0.3)
    os._exit(17)  # first attempt: worker 1 dies
time.sleep(1.0)
open(f"finished.{rank}", "w").write("ok")
"""


def test_launch_elastic_survives_worker_kill(tmp_path):
    (tmp_path / "train.py").write_text(ELASTIC_SCRIPT)
    p = _launch(["--nnodes", "1", "--nproc_per_node", "2", "--elastic_retries", "2", "train.py"],
                str(tmp_path))
    out, _ = p.communicate(timeout=120)
    assert p.returncode == 0, out
    assert "elastic restart 1/2" in out
    for r in (0, 1):
        assert (tmp_path / f"finished.{r}").exists()
        assert (tmp_path / f"attempt.{r}").read_text() == "2"  # the survivor is torn down too


def test_launch_failure_without_elastic_propagates(tmp_path):
    (tmp_path / "train.py").write_text(
        "import os, sys; sys.exit(3 if os.environ['PADDLE_TRAINER_ID'] == '1' else 0)\n")
    p = _launch(["--nnodes", "1", "--nproc_per_node", "2", "train.py"], str(tmp_path))
    p.communicate(timeout=60)
    assert p.returncode == 1


def _log(path):
    return [json.loads(line) for line in open(path)] if os.path.exists(path) else []


def test_elastic_scale_in_restores_through_the_converter(tmp_path):
    from paddle_tpu_torch.distributed.resilience import CheckpointManager
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    port = _free_port()
    ck, log = str(tmp_path / "ck"), str(tmp_path / "log.jsonl")
    common = ["--nnodes", "2", "--nproc_per_node", "1", "--master", f"127.0.0.1:{port}",
              "--elastic_np", "1:2", "--elastic_timeout", "5.0", WORKER, "--device", "cpu",
              "--ckpt", ck, "--log", log, "--world_steps", "2", "--total_steps", "4"]
    a = _launch(["--rank", "0"] + common, str(tmp_path))
    b = _launch(["--rank", "1"] + common, str(tmp_path))
    try:
        deadline = time.monotonic() + 120
        while sum(e["event"] == "step" for e in _log(log)) < 2:
            assert time.monotonic() < deadline and a.poll() is None and b.poll() is None, \
                "the world-2 steps did not come"
            time.sleep(0.2)
        b.send_signal(signal.SIGTERM)  # the second node leaves
        out_b, _ = b.communicate(timeout=60)
        out_a, _ = a.communicate(timeout=120)
    finally:
        for p in (a, b):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert b.returncode == 143, out_b
    assert a.returncode == 0, out_a
    assert "membership=[0, 1] -> nnodes=2" in out_a and "membership=[0] -> nnodes=1" in out_a
    events = _log(log)
    steps = [e for e in events if e["event"] == "step"]
    assert [(e["world"], e["step"]) for e in steps] == [(2, 0), (2, 1), (1, 2), (1, 3)]
    # each rank's kernel launches in each step: none on the CPU (a wrapper
    # counts only where it launches its kernel)
    zero = {n: 0 for n in ("flash_attention_fwd", "flash_attention_bwd", "flash_flat_fwd",
                           "flash_flat_bwd", "moe_grouped_ffn_fwd", "moe_grouped_ffn_bwd")}
    assert [e["launches_by_rank"] for e in steps] == [[zero] * e["world"] for e in steps]
    restored = [e for e in events if e["event"] == "restored"]
    assert len(restored) == 1 and restored[0]["step"] == 2 and restored[0]["world"] == 1
    assert restored[0]["bitwise"] is True

    cfg = GPTConfig.tiny()
    ids = torch.randint(0, cfg.vocab_size, (8, 32), generator=torch.Generator().manual_seed(2))

    def one_process():
        model = GPTForPretraining(cfg, device="cpu", seed=0)
        return TrainStep(model, AdamW(learning_rate=1e-3, parameters=model.parameters()),
                         GPTPretrainingCriterion(), amp_level="O2")

    plain = one_process()
    want2 = [float(plain(ids, ids)["loss"]) for _ in range(2)]
    np.testing.assert_allclose([e["loss"] for e in steps[:2]], want2, rtol=WORLD2_RTOL)
    resumed = one_process()
    mgr = CheckpointManager(ck, keep_last_k=3)
    mgr._load_verified(2, resumed, None)
    assert resumed.state["step"] == 2
    got = [float(resumed(ids, ids)["loss"]).hex() for _ in range(2)]
    assert got == [e["loss_hex"] for e in steps[2:]]  # bitwise


def test_serve_boots_replicas_that_attach_adopts(tmp_path):
    from paddle_tpu_torch.inference import ProcServingFleet, ServingFleet
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining

    kw = dict(max_batch_slots=2, max_seq_len=64, prefill_chunk=8, fuse=2, do_sample=True)
    spec = {"ns": "launch-serve", "model": {"seed": 0, "config": GPTConfig.tiny().to_dict()},
            "engine_kwargs": kw, "device": "cpu", "beat_interval": 0.05}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    master = f"127.0.0.1:{_free_port()}"
    prompts = [np.random.default_rng(7 + i).integers(0, 512, (4 + i,)) for i in range(4)]
    model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=0).eval()
    local = ServingFleet(model, replicas=1, **kw)
    fids = [local.submit(p, max_new_tokens=5, seed=i) for i, p in enumerate(prompts)]
    done = local.run()
    want = [list(done[f].tokens) for f in fids]
    p = _launch(["--serve", "--nnodes", "1", "--nproc_per_node", "2", "--master", master,
                 "spec.json"], str(tmp_path))
    try:
        fleet = ProcServingFleet.attach(master, 2, ns="launch-serve", device="cpu",
                                        heartbeat_timeout=60.0, boot_timeout=180.0, **kw)
        try:
            assert sorted(fleet.replicas) == [0, 1]
            fids = [fleet.submit(q, max_new_tokens=5, seed=i) for i, q in enumerate(prompts)]
            fleet.run(timeout_s=300)
            assert [list(fleet.requests[f].tokens) for f in fids] == want
        finally:
            fleet.shutdown()
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
        assert "attach with ProcServingFleet.attach" in out
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


def _in_process_tokens(kw, prompts, new_tokens):
    from paddle_tpu_torch.inference import ServingFleet
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining

    model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=0).eval()
    local = ServingFleet(model, replicas=1, **kw)
    fids = [local.submit(p, max_new_tokens=new_tokens, seed=i) for i, p in enumerate(prompts)]
    done = local.run()
    return [list(done[f].tokens) for f in fids]


def test_serve_http_front_end_answers_and_drains(tmp_path):
    from paddle_tpu_torch.models.gpt import GPTConfig

    kw = dict(max_batch_slots=2, max_seq_len=64, prefill_chunk=8, fuse=2)
    spec = {"ns": "launch-http", "model": {"seed": 0, "config": GPTConfig.tiny().to_dict()},
            "engine_kwargs": kw, "device": "cpu", "beat_interval": 0.05, "boot_timeout": 180.0}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    prompt = np.random.default_rng(11).integers(0, 512, (6,))
    want = _in_process_tokens(kw, [prompt], 5)[0]
    port = _free_port()
    p = _launch(["--serve", "--http", str(port), "--nnodes", "1", "--nproc_per_node", "1",
                 "--master", f"127.0.0.1:{_free_port()}", "spec.json"], str(tmp_path))
    try:
        deadline = time.monotonic() + 180
        while True:  # the front end is up once /healthz answers 200
            assert p.poll() is None and time.monotonic() < deadline, "no front end came up"
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                conn.request("GET", "/healthz")
                if conn.getresponse().status == 200:
                    conn.close()
                    break
                conn.close()
            except OSError:
                pass
            time.sleep(0.2)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/generate", headers={"Content-Type": "application/json"},
                     body=json.dumps({"prompt": prompt.tolist(), "max_new_tokens": 5,
                                      "seed": 0}).encode())
        r = conn.getresponse()
        doc = json.loads(r.read())
        conn.close()
        assert r.status == 200 and doc["status"] == "finished", doc
        assert doc["tokens"] == want
        p.send_signal(signal.SIGTERM)  # drain: finish in flight, shut the fleet down
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
        assert f"ingress on http://127.0.0.1:{port}" in out
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()

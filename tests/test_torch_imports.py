"""The port stands alone: no module of ``paddle_tpu_torch``, and not
``chip_smoke.py``, imports ``jax`` or ``paddle_tpu``; and its entry points
never fall back to the CPU silently."""
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def _run(args, cwd, timeout=180):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


# modules of the training slice that the import check must reach
TRAINING_MODULES = {"paddle_tpu_torch.jit", "paddle_tpu_torch.jit.train_step",
                    "paddle_tpu_torch.optimizer", "paddle_tpu_torch.optimizer.optimizer",
                    "paddle_tpu_torch.optimizer.functional", "paddle_tpu_torch.optimizer.lr",
                    "paddle_tpu_torch.nn.clip", "paddle_tpu_torch.nn.functional.loss"}
# modules of the GPT-MoE slice
MOE_MODULES = {"paddle_tpu_torch.distributed", "paddle_tpu_torch.distributed.moe",
               "paddle_tpu_torch.ops.moe_pallas", "paddle_tpu_torch.models.gpt",
               "paddle_tpu_torch.utils.convert"}
# modules of the BERT / masked-attention slice
BERT_MODULES = {"paddle_tpu_torch.ops.flash_attention_flat", "paddle_tpu_torch.models.bert",
                "paddle_tpu_torch.distributed.mp_layers", "paddle_tpu_torch.nn.layer",
                "paddle_tpu_torch.nn.layer.common", "paddle_tpu_torch.nn.layer.norm",
                "paddle_tpu_torch.nn.initializer", "paddle_tpu_torch.nn.functional.activation"}
# modules of the 1.3B / ERNIE slice
FLAGSHIP_MODULES = {"paddle_tpu_torch.distributed.recompute", "paddle_tpu_torch.distributed.pipeline",
                    "paddle_tpu_torch.models.ernie"}
# modules of the vision slice
VISION_MODULES = {"paddle_tpu_torch.vision", "paddle_tpu_torch.vision.models",
                  "paddle_tpu_torch.vision.models.resnet", "paddle_tpu_torch.models.lenet",
                  "paddle_tpu_torch.nn.functional.conv", "paddle_tpu_torch.nn.functional.pooling",
                  "paddle_tpu_torch.nn.functional.norm", "paddle_tpu_torch.nn.layer.conv",
                  "paddle_tpu_torch.nn.layer.pooling", "paddle_tpu_torch.nn.layer.activation",
                  "paddle_tpu_torch.nn.layer.loss"}
# modules of the serving knobs
SERVING_MODULES = {"paddle_tpu_torch.inference", "paddle_tpu_torch.inference.engine",
                   "paddle_tpu_torch.inference.scheduler", "paddle_tpu_torch.inference.prefix_cache",
                   "paddle_tpu_torch.quantization"}
# modules of the serving stack and the host-only pieces it runs on
SERVING_STACK_MODULES = {"paddle_tpu_torch.inference.router", "paddle_tpu_torch.inference.fleet",
                         "paddle_tpu_torch.inference.rpc", "paddle_tpu_torch.inference.procfleet",
                         "paddle_tpu_torch.inference.ingress", "paddle_tpu_torch.distributed.store",
                         "paddle_tpu_torch.distributed.resilience", "paddle_tpu_torch.testing",
                         "paddle_tpu_torch.testing.chaos", "paddle_tpu_torch.observability.trace",
                         "paddle_tpu_torch.observability.runlog",
                         "paddle_tpu_torch.observability.flightrec",
                         "paddle_tpu_torch.framework.random"}
# modules of the serving tier's judgment and export layers
OBSERVABILITY_MODULES = {"paddle_tpu_torch.analysis", "paddle_tpu_torch.analysis.sanitizer",
                         "paddle_tpu_torch.observability.slo",
                         "paddle_tpu_torch.observability.regress",
                         "paddle_tpu_torch.observability.exporter",
                         "paddle_tpu_torch.observability.measured",
                         "paddle_tpu_torch.observability.__main__"}

# modules of the recommender slice and the optimizer layer
RECSYS_MODULES = {"paddle_tpu_torch.models.dlrm", "paddle_tpu_torch.distributed.embedding",
                  "paddle_tpu_torch.framework.selected_rows", "paddle_tpu_torch.regularizer",
                  "paddle_tpu_torch.nn.functional.common"}

# modules of the distributed slice (collectives, DataParallel, tensor parallelism)
DISTRIBUTED_MODULES = {"paddle_tpu_torch.distributed.env", "paddle_tpu_torch.distributed.strategy",
                       "paddle_tpu_torch.distributed.topology",
                       "paddle_tpu_torch.distributed.collective",
                       "paddle_tpu_torch.distributed.parallel", "paddle_tpu_torch.distributed.fleet",
                       "paddle_tpu_torch.distributed.utils", "paddle_tpu_torch.testing.dist",
                       "paddle_tpu_torch.observability.spans"}
# modules of the ZeRO / pipeline / hybrid slice
HYBRID_MODULES = {"paddle_tpu_torch.distributed.sharding", "paddle_tpu_torch.distributed.pipeline",
                  "paddle_tpu_torch.models.gpt", "paddle_tpu_torch.models.ernie"}
# modules of the expert- and sequence-parallel slice
EP_SEP_MODULES = {"paddle_tpu_torch.distributed.ring_attention",
                  "paddle_tpu_torch.distributed.fleet_executor",
                  "paddle_tpu_torch.distributed.moe", "paddle_tpu_torch.distributed.utils"}


# modules of checkpoints, resume, the training guard and the launcher
RESILIENCE_MODULES = {"paddle_tpu_torch.distributed.checkpoint",
                      "paddle_tpu_torch.distributed.converter",
                      "paddle_tpu_torch.distributed.elastic", "paddle_tpu_torch.stability",
                      "paddle_tpu_torch.distributed.launch",
                      "paddle_tpu_torch.distributed.launch.main",
                      "paddle_tpu_torch.distributed.launch.__main__"}


# modules of AMP (O1, float16 with GradScaler) and the Paddle-named tensor functions
AMP_MODULES = {"paddle_tpu_torch.amp", "paddle_tpu_torch.tensor",
               "paddle_tpu_torch.nn.functional.loss", "paddle_tpu_torch.nn.functional.activation"}

# modules of dropout and the first half of the nn layer library
NN_LIBRARY_MODULES = {"paddle_tpu_torch.framework.random", "paddle_tpu_torch.nn.functional.common",
                      "paddle_tpu_torch.nn.functional.activation",
                      "paddle_tpu_torch.nn.layer.common", "paddle_tpu_torch.nn.layer.activation",
                      "paddle_tpu_torch.nn.layer.container",
                      "paddle_tpu_torch.nn.layer.transformer", "paddle_tpu_torch.nn.initializer",
                      "paddle_tpu_torch.distributed.recompute"}

# modules of parallel dropout and the rest of the nn layer library
NN_TAIL_MODULES = {"paddle_tpu_torch.framework.param_attr", "paddle_tpu_torch.nn.layer._attr",
                   "paddle_tpu_torch.nn.layer.rnn", "paddle_tpu_torch.nn.layer.extension",
                   "paddle_tpu_torch.nn.functional.extension_ops",
                   "paddle_tpu_torch.nn.functional.sequence", "paddle_tpu_torch.nn.functional.loss",
                   "paddle_tpu_torch.nn.layer.loss", "paddle_tpu_torch.utils.convert"}


# modules of the tensor API and the framework core
FRAMEWORK_CORE_MODULES = {"paddle_tpu_torch.tensor._helpers", "paddle_tpu_torch.tensor.creation",
                          "paddle_tpu_torch.tensor.math", "paddle_tpu_torch.tensor.manipulation",
                          "paddle_tpu_torch.tensor.logic", "paddle_tpu_torch.tensor.search",
                          "paddle_tpu_torch.tensor.stat", "paddle_tpu_torch.tensor.linalg",
                          "paddle_tpu_torch.framework.dtype", "paddle_tpu_torch.framework.io",
                          "paddle_tpu_torch.device", "paddle_tpu_torch.autograd",
                          "paddle_tpu_torch.autograd.py_layer",
                          "paddle_tpu_torch.autograd.functional",
                          "paddle_tpu_torch.utils.unique_name",
                          "paddle_tpu_torch.testing.tensor_cases"}


# modules of the rest of the nn library and the vision zoo
ZOO_MODULES = {"paddle_tpu_torch.nn.functional.norm", "paddle_tpu_torch.nn.functional.pooling",
               "paddle_tpu_torch.nn.functional.conv", "paddle_tpu_torch.nn.layer.norm",
               "paddle_tpu_torch.nn.layer.pooling", "paddle_tpu_torch.nn.layer.conv",
               "paddle_tpu_torch.framework", "paddle_tpu_torch.vision.models._common",
               "paddle_tpu_torch.vision.models.alexnet", "paddle_tpu_torch.vision.models.vgg",
               "paddle_tpu_torch.vision.models.squeezenet",
               "paddle_tpu_torch.vision.models.mobilenet",
               "paddle_tpu_torch.vision.models.shufflenetv2",
               "paddle_tpu_torch.vision.models.densenet",
               "paddle_tpu_torch.vision.models.googlenet",
               "paddle_tpu_torch.vision.models.inceptionv3"}


# modules of the input pipeline and the training loop
IO_HAPI_MODULES = {"paddle_tpu_torch.io", "paddle_tpu_torch.io.dataset",
                   "paddle_tpu_torch.io.dataloader", "paddle_tpu_torch.io.mp_worker",
                   "paddle_tpu_torch.io.record_feed", "paddle_tpu_torch.framework.native",
                   "paddle_tpu_torch.metric", "paddle_tpu_torch.jit.eval_step",
                   "paddle_tpu_torch.hapi", "paddle_tpu_torch.hapi.model",
                   "paddle_tpu_torch.hapi.callbacks", "paddle_tpu_torch.hapi.dynamic_flops",
                   "paddle_tpu_torch.callbacks", "paddle_tpu_torch.vision.functional",
                   "paddle_tpu_torch.vision.transforms", "paddle_tpu_torch.vision.datasets"}


def test_port_and_chip_smoke_import_no_jax_or_paddle_tpu():
    names = {m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    wanted = (TRAINING_MODULES | MOE_MODULES | BERT_MODULES | FLAGSHIP_MODULES | VISION_MODULES
              | SERVING_MODULES | SERVING_STACK_MODULES | OBSERVABILITY_MODULES | RECSYS_MODULES
              | DISTRIBUTED_MODULES | HYBRID_MODULES | EP_SEP_MODULES | RESILIENCE_MODULES
              | AMP_MODULES | NN_LIBRARY_MODULES | NN_TAIL_MODULES | FRAMEWORK_CORE_MODULES
              | ZOO_MODULES | IO_HAPI_MODULES)
    assert wanted <= names, sorted(wanted - names)
    proc = _run(["-c", _IMPORT_ALL], cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[0] == str(len(names)) and len(names) >= 90


_LOADER = r"""
import sys
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch.io import DataLoader, Dataset
from paddle_tpu_torch.vision import transforms as T


class Probe(Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        img = T.Compose([T.RandomResizedCrop(8, generator=i), T.Transpose()])(
            np.zeros((12, 12, 3), np.uint8))
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
        return img, np.int64(len(bad))


net = paddle.nn.Linear(3 * 8 * 8, 2, device="cpu")
model = paddle.Model(net)
model.prepare(paddle.optimizer.SGD(parameters=net.parameters()), paddle.nn.CrossEntropyLoss())
loader = DataLoader(Probe(), batch_size=2, num_workers=2, worker_mode="process", device="cpu")
counts = [int(y.sum()) for _, y in loader]
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
print(counts, bad)
sys.exit(1 if bad or any(counts) or len(counts) != 2 else 0)
"""


def test_process_workers_import_no_jax_or_paddle_tpu():
    """A DataLoader's process workers, running the port's transforms, and
    the parent with ``hapi.Model`` built import neither ``jax`` nor
    ``paddle_tpu``."""
    proc = _run(["-c", _LOADER], cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split("\n")[0] == "[0, 0] []"


def test_rank_processes_import_no_jax_or_paddle_tpu():
    """A rank that ``testing.dist.run_ranks`` spawns, running the parity
    tests' rank bodies (here a pipelined ZeRO-2 GPT step, a GPT-MoE step
    with its experts over dp and a GPT step over sep), imports neither
    ``jax`` nor ``paddle_tpu``, even from a test process that has both."""
    import jax  # noqa: F401  (the parent has the reference loaded)

    import torch_dist_ranks
    import torch_recsys_ranks
    from paddle_tpu_torch.testing.dist import run_ranks

    assert run_ranks(torch_dist_ranks.imported_reference_modules, 2) == [[], []]
    # nor does a rank of the row-sharded exchange, AMP and offload tests
    assert run_ranks(torch_recsys_ranks.imported_reference_modules, 2) == [[], []]


# a sitecustomize that records, at exit, the foreign modules its process
# imported (the launcher's workers and replicas run no code of the test's)
_PROBE = """
import atexit, os, sys

def _dump():
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
    with open(os.path.join(os.environ["IMPORT_PROBE_DIR"], f"{os.getpid()}.txt"), "w") as f:
        f.write(repr(bad))

atexit.register(_dump)
"""

_WORKER = """
import sys
import paddle_tpu_torch.distributed as D
from paddle_tpu_torch.distributed import checkpoint, converter, elastic, resilience  # noqa: F401
from paddle_tpu_torch import stability  # noqa: F401
D.init_parallel_env(device="cpu")
t = __import__("torch").ones(2)
D.all_reduce(t)
sys.exit(0 if float(t[0]) == D.get_world_size() else 1)
"""


def test_launched_workers_and_replicas_import_no_jax_or_paddle_tpu(tmp_path):
    """The launcher, two training workers it spawns (importing the
    checkpoint, converter, elastic, resilience and stability modules) and a
    serving replica it boots with ``--serve`` import neither ``jax`` nor
    ``paddle_tpu``, even from a test process that has both loaded."""
    import json
    import socket
    import time

    import jax  # noqa: F401  (the parent has the reference loaded)

    from paddle_tpu_torch.inference import ProcServingFleet
    from paddle_tpu_torch.models.gpt import GPTConfig

    site, probes = tmp_path / "site", tmp_path / "probes"
    site.mkdir()
    probes.mkdir()
    (site / "sitecustomize.py").write_text(_PROBE)
    (tmp_path / "train.py").write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=f"{site}{os.pathsep}{ROOT}", IMPORT_PROBE_DIR=str(probes),
               OMP_NUM_THREADS="1")

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    launch = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]
    proc = subprocess.run(launch + ["--nproc_per_node", "2", "--master",
                                    f"127.0.0.1:{free_port()}", "train.py"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    kw = dict(max_batch_slots=1, max_seq_len=32, prefill_chunk=8)
    spec = {"ns": "probe", "model": {"seed": 0, "config": GPTConfig.tiny().to_dict()},
            "engine_kwargs": kw, "device": "cpu"}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    master = f"127.0.0.1:{free_port()}"
    serve = subprocess.Popen(launch + ["--serve", "--master", master, "spec.json"], cwd=tmp_path,
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        fleet = ProcServingFleet.attach(master, 1, ns="probe", device="cpu",
                                        heartbeat_timeout=60.0, boot_timeout=120.0, **kw)
        try:
            fid = fleet.submit([1, 2, 3], max_new_tokens=2)
            fleet.run(timeout_s=120)
            assert fleet.requests[fid].status == "finished"
        finally:
            fleet.shutdown()
        out, _ = serve.communicate(timeout=60)
        assert serve.returncode == 0, out
    finally:
        if serve.poll() is None:
            serve.kill()
            serve.wait()
    deadline = time.monotonic() + 10
    while len(list(probes.iterdir())) < 5 and time.monotonic() < deadline:
        time.sleep(0.1)
    found = {p.name: p.read_text() for p in probes.iterdir()}
    # two launchers, two workers, one replica
    assert len(found) == 5 and set(found.values()) == {"[]"}, found


def test_observability_flags_arm_in_both_fleets(monkeypatch):
    """``FLAGS_slo``, ``FLAGS_metrics_port`` and ``FLAGS_sanitize`` no longer
    raise in the in-process or the process fleet: each serves a request
    while the SLO monitor installs itself, the in-process fleet starts the
    exporter on the port, and the sanitizer's ledger check runs."""
    import socket
    import urllib.request

    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.inference import ProcServingFleet, ServingFleet
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.observability import exporter, slo

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the replica process's threads
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    names = ["FLAGS_slo", "FLAGS_metrics_port", "FLAGS_sanitize"]
    prev = get_flags(names)
    set_flags({"FLAGS_slo": True, "FLAGS_metrics_port": port, "FLAGS_sanitize": True})
    kw = dict(max_batch_slots=2, max_seq_len=64, prefill_chunk=8)
    try:
        model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=0).eval()
        fleets = [ServingFleet(model, replicas=1, **kw)]
        assert exporter.current() is not None and exporter.current().port == port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
            assert r.status == 200
        fleets.append(ProcServingFleet(GPTConfig.tiny(), model_seed=0, replicas=1,
                                       device="cpu", heartbeat_timeout=60.0, **kw))
        try:
            for fleet in fleets:
                slo.uninstall()
                fid = fleet.submit(list(range(5)), max_new_tokens=3)
                fleet.run()
                assert fleet.requests[fid].status == "finished"
                assert slo.installed() is not None
        finally:
            fleets[1].shutdown()
    finally:
        slo.uninstall()
        exporter.stop()
        exporter.unregister_health("fleet")
        set_flags(prev)


def test_entry_points_raise_without_cuda_and_device():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.models.lenet import LeNet
    from paddle_tpu_torch.nn.layer import BatchNorm2D, Conv2D
    from paddle_tpu_torch.vision.models import resnet50

    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForPretraining(GPTConfig.tiny())
    for make in (lambda: resnet50(num_classes=1000), LeNet, lambda: Conv2D(3, 8, 3),
                 lambda: BatchNorm2D(8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert resnet50(device="cpu").fc.weight.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertForPretraining(BertConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErnieForPretraining(ErnieConfig.tiny())
    # the 1.3B config raises before it allocates anything
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForPretraining(GPTConfig.gpt3_1p3b(recompute=True, recompute_granularity="selective"))
    assert ErnieForPretraining(ErnieConfig.tiny(), device="cpu").sop.weight.device.type == "cpu"
    assert GPTForPretraining(GPTConfig.tiny(), device="cpu").gpt.layers.qkv_w.device.type == "cpu"
    from paddle_tpu_torch.distributed.embedding import ShardedEmbedding
    from paddle_tpu_torch.models.dlrm import DLRM, DLRMConfig
    from paddle_tpu_torch.nn.layer import Embedding

    for make in (lambda: DLRM(DLRMConfig.tiny()), lambda: ShardedEmbedding(8, 4),
                 lambda: Embedding(8, 4, sparse=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert DLRM(DLRMConfig.tiny(), device="cpu").embedding.weight.device.type == "cpu"


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    """Without a CUDA device, and in a directory holding only the script,
    ``chip_smoke.py`` exits non-zero and prints no ``ok`` result."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    proc = _run([os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout

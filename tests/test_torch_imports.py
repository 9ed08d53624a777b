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


def test_port_and_chip_smoke_import_no_jax_or_paddle_tpu():
    names = {m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    wanted = TRAINING_MODULES | MOE_MODULES | BERT_MODULES | FLAGSHIP_MODULES | VISION_MODULES
    assert wanted <= names, sorted(wanted - names)
    proc = _run(["-c", _IMPORT_ALL], cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[0] == str(len(names)) and len(names) >= 54


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

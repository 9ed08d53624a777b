"""Smoke run of the PyTorch + CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; it builds the kernels from the sources in this
checkout into ``build/paddle_tpu_torch/``. Without a CUDA device it exits
non-zero and prints no result. Phases, one JSON line each:

1. ``device``: the card's name, the device count, and ``nvidia-smi``'s name
   and power limit.
2. ``build``: every kernel of the path built from source, all ``nvcc``
   processes started together; ptxas's registers and spills, and the
   tensor-core instructions (``HGMMA``: wgmma, ``HMMA``: mma.sync) of every
   flash and grouped-FFN kernel by ``cuobjdump -sass``: each bf16 instance
   of K1, K2, K3 and K3b must hold some; each bf16 instance of K4 and K4b
   must hold HGMMA and no HMMA, and their f32 instances and small passes
   none.
3. ``kernels``: kernels K1 (flash-attention forward) and K2 (its backward)
   against their plain PyTorch versions at the main path's shapes, f32 and
   bf16, causal and not, d = 64 and 128, a ragged s, and packed-qkv
   strides, among them the d = 128 bf16 calls of phases 17 and 20
   (``[2, 2048, 16, 128]`` causal and ``[16, 512, 24, 128]`` full); with
   times of the kernel, the plain version and the one PyTorch call that
   computes the same function
   (``torch.nn.functional.scaled_dot_product_attention``, its backward for
   K2: a yardstick the port never calls) beside the bound of the card.
4. ``forward``: the full-sequence eval forward of the serving GPT at full
   width, through the ``attention_core`` kernel, against the same model with
   ``FLAGS_kernel_overrides="attention_core=xla"``.
5. ``serve``: ``DecodeEngine`` behind ``ContinuousBatchingScheduler``
   answering 16 greedy requests, each checked against ``generate()``.
6. ``train``: the flagship pretraining step of ``bench.py`` at full width:
   ``TrainStep`` with AMP O2 over ``AdamW``, 3 warm-up and 10 timed steps of
   ids ``[8, 1024]``; losses finite and falling, K1 and K2 launched once per
   layer and step; then one step under ``torch.profiler`` for the device
   time by kernel group and the device's idle share.
7. ``train_check``: one f32 step of the same model at batch 2 through
   ``attention_core``/``flash`` and through the plain ``xla`` impl from the
   same weights: the losses and every parameter's gradient agree.
8. ``moe_kernels`` (run after phase 9): kernels K4 (the grouped expert-FFN
   forward) and K4b (its backward) against their plain PyTorch versions at
   the GPT-MoE step's full-width shape, f32 and bf16: the main call at each
   MoE layer's live ``rows`` of phase 9's traced step (the routing of the
   step at seed 0) with junk in the padding rows, then every row live;
   plus an H <= 512 case, a capacity that is no multiple of the kernels'
   tile and a case ragged in every dimension; with the times of
   the kernel and the plain version beside the bound over the padded rows
   (``bound_ms``) and over the live rows (``bound_live_ms``; no single
   PyTorch call computes a grouped FFN, so there is no library time).
9. ``moe_train``: the GPT-MoE step of ``bench.py:_measure_moe`` at full
   width: f32 ``TrainStep`` over ``AdamW``, ids ``[8, 1024]``, GShard
   jitter on, 2 warm-up and 5 timed steps, through the ``moe`` kernel's
   ``pallas_sorted`` impl (K4/K4b) and then through ``moe=dense``; losses
   finite and falling, K4 and K4b launched once per MoE layer and step, K1
   and K2 once per layer and step; one step of each traced; the share of
   the f32 flops bound over the padded expert rows and over the live rows,
   and each MoE layer's ``rows`` at the traced step.
10. ``moe_check``: one f32 step at batch 2 through ``pallas_sorted`` and
    through ``dense`` from the same weights and routing seeds: the losses,
    every gradient and the eval logits agree.
11. ``flat_kernels`` (run after phase 3): kernels K3 (the flat flash
    forward with an additive bias) and K3b (its backward) against their
    plain PyTorch versions: BERT-base's padded call (q, k, v views of
    ``[16, 512, 3, 12, 64]``, bias ``[16, 1, 512, 512]``) in bf16 and f32,
    a ``[1, 1, s, s]`` bias, causal with a banded bias, GPT's packed causal
    call with no bias, GQA with ``h_kv = h/4``, a ragged s = 200, a fully
    masked query row and d = 128; with the times of the kernel, the plain
    version and ``scaled_dot_product_attention`` with the same mask (a
    yardstick the port never calls) beside the bound.
12. ``bert_forward``: the eval forward of BERT-base (``BertConfig()``,
    random weights from seed 0) on ids ``[16, 512]`` padded per row (lengths
    from seed 0 in [64, 512], the last row 512) under an additive f32 mask
    ``[16, 1, 512, 512]``, with ``FLAGS_flash_flat`` on: ``sdpa`` picks
    ``flash_flat_gqa`` (K3, 12 launches, no K1), and the MLM and NSP
    logits agree with the same model forced to ``sdpa=xla``.
13. ``bert_train``: BERT-base MLM + NSP pretraining on that batch as
    ``bench_suite.py:bench_bert`` runs it (AMP O2 ``TrainStep`` over
    ``AdamW(1e-4)``; MLM labels on the first 64 tokens), 3 warm-up and 10
    timed steps: tokens/s (all and non-pad), ms per step, peak memory, the
    share of the model-flops bound, losses finite and falling, K3 and K3b
    12 times per step; then one step traced.
14. ``bert_curves``: the same 13 O2 steps from the same weights through
    ``sdpa=xla``, whose losses agree with ``bert_train``'s at every step,
    and in f32 through K3/K3b, shown beside them.
15. ``bert_check``: one f32 step at batch 2 through ``flash_flat_gqa``
    (K3 + K3b) and through ``xla`` from the same weights: the losses and
    every gradient agree.
16. ``flat_check``: one f32 step of the serving GPT at batch 2 with
    ``FLAGS_flash_flat`` on, through ``attention_core``/``flash_packed``
    (K3 + K3b, 16 each) and through ``xla``, as phase 7.
17. ``gpt3_1p3b_train``: the GPT-3 1.3B step of
    ``bench_1p3b.py:_tpu_run(False)`` at full width and depth (selective
    recompute, 2 accumulated micro-batches of ``[4, 2048]``, AMP O2 over
    ``AdamW``), 2 warm-up and 6 timed steps: tokens/s, ms per step, peak
    memory, the share of the model-flops bound, losses finite and falling,
    96 K1 and 48 K2 launches per step; then one step traced, and the same
    step with ``"full"`` recompute and with none timed beside it.
18. ``recompute_check``: one f32 step with recompute off, ``"full"`` and
    ``"selective"`` from the same weights, the 1.3B's width at 2 layers
    and the GPT-MoE at 2 layers with GShard jitter on: losses and
    gradients agree.
19. ``accum_check``: one f32 step of the 2-layer 1.3B on ``[4, 2048]``
    with 2 accumulated micro-batches against one piece: they agree.
20. ``ernie_train``: the ERNIE 3.0 xbase step of
    ``bench_1p3b.py:_tpu_run(True)`` at full width and depth (MLM + SOP,
    ``[16, 512]``, AMP O2), 2 warm-up and 8 timed steps, as phase 17 (the
    losses finite; they need not fall):
    ``sdpa`` picks ``flash``, 12 K1 and 12 K2 per step, no K3.
21. ``ernie_check``: one f32 step of ERNIE at full width, 2 layers, batch
    2, through ``sdpa``/``flash`` and through ``sdpa=xla``, as phase 7.
22. ``resnet50_train``: the ResNet50 step of ``bench_suite.py:bench_resnet50``
    uncut (``resnet50(num_classes=1000)``, ``Momentum(0.1)``,
    ``CrossEntropyLoss``, AMP O2, ``[128, 3, 224, 224]`` normal inputs and
    int64 labels from seeds 0 and 1), NCHW, 3 warm-up and 20 timed steps:
    images/s, ms per step, peak memory, the share of the model-flops bound
    (derived from the conv and Linear shapes), losses finite, the batch
    norms' running buffers finite and moved; then one step traced (cuDNN
    conv forward, dgrad and wgrad, batch norm, elementwise, Momentum) and
    the same step with ``torch.backends.cudnn.benchmark`` on, timed beside
    it.
23. ``resnet_check``: ResNet50's step on the card against the same step on
    the CPU from the same weights and inputs (``[8, 3, 64, 64]``, TF32
    off), in f32 and in float64: the loss, every gradient, the running
    buffers after the step, and an eval forward on them.
24. ``lenet_train``: ``bench_suite.py:bench_mnist`` (LeNet, ``Momentum(0.01)``,
    ``[64, 1, 28, 28]``): the eager loop (``backward``, ``step``,
    ``clear_grad``), 20 timed after 3, and ``TrainStep``, 200 timed after
    3; steps/s of both, the losses falling.

The vision phases (22-24) launch none of K1-K4b: the reference runs no
Pallas kernel on that path (convolutions are cuDNN's, batch norms and pools
ATen's); the script checks that their counts stay 0.

Phases 4, 5, 6, 9 (its ``pallas_sorted`` run), 12, 13, 16, 17, 20, 22 and
24 are the main path: the kernel counts are set to 0 just before each of them and read just
after it. Then one JSON line lists every kernel with its launches in those
runs (K1 and K3 with a ``bf16_row`` too: their O2 steps' bf16 call; K4 and
K4b at the first MoE layer's rows of the traced step, whose ``bound_ms``
counts the live rows, the rows the kernels compute; K1 and K2 with
``d128_rows``: the d = 128 calls of phases 17 and 20) and the script's wall
time, and the last line is the ``{"ok": true, ...}`` result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside the
# tensor cores (the K1 kernel's f32 FMA path), and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# the serving configuration of bench_serve.py (GPT, h=1024, L=16, 16 heads),
# which is also the flagship training configuration of bench.py
SERVE_CFG = dict(vocab_size=50304, hidden_size=1024, num_layers=16, num_heads=16, max_seq_len=1024)
# bench.py's step: batch [8, 1024], AdamW(lr 1e-4), TrainStep(amp_level="O2")
TRAIN = dict(batch=8, seq=1024, lr=1e-4, warmup=3, steps=10, check_batch=2)
# the server: bench_serve.py's slots, cache length and prefill buckets
SERVE = dict(slots=8, max_seq_len=1024, buckets=(64, 128, 256, 512), requests=16, new_tokens=32,
             prompt_lens=(16, 480))
SEED = 0

# f32: atol 1e-5 / rtol 1e-4 (true f32 on both sides, sums in another order).
# bf16: the kernel's bf16 output against the plain version in f32 on the same
# bf16 inputs, atol 2e-2 (one bf16 rounding of values of order 1). lse is
# f32 on both sides in both cases.
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 0.0)}
LSE_TOL = (1e-5, 1e-4)
# K2's dq, dk, dv. f32: atol 2e-5 / rtol 1e-4, the reference's gradient
# tolerance for its own kernel pair (tests/test_flash_interpret.py). bf16:
# the kernel's bf16 gradients against the plain version in f32 on the same
# bf16 inputs, atol 2e-2 / rtol 1e-2 (one bf16 rounding is 2**-8 relative;
# gradients reach a few units).
GRAD_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
# logits of the whole forward, flash vs plain attention in f32: the
# attention outputs differ by f32 rounding (~1e-6), which 16 layers carry
# into logits of order 1
LOGITS_TOL = (1e-4, 1e-4)
# one f32 training step, flash vs plain attention: the loss (about ln V)
# within rtol 1e-5, and each parameter's gradient within a relative L2 error
# of 1e-4 (f32 rounding of the attention carried back through 16 layers)
TRAIN_CHECK_TOL = dict(loss_rtol=1e-5, grad_rel_l2_max=1e-4)

K1 = dict(name="flash_attention_fwd", route="cuda",
          source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
          replaces="paddle_tpu/ops/flash_attention.py:126")
K2 = dict(name="flash_attention_bwd", route="cuda",
          source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
          replaces="paddle_tpu/ops/flash_attention.py:237")
K4 = dict(name="moe_grouped_ffn_fwd", route="cuda",
          source="paddle_tpu_torch/csrc/moe_grouped_ffn_fwd.cu",
          replaces="paddle_tpu/ops/moe_pallas.py:324")
K4B = dict(name="moe_grouped_ffn_bwd", route="cuda",
           source="paddle_tpu_torch/csrc/moe_grouped_ffn_bwd.cu",
           replaces="paddle_tpu/ops/moe_pallas.py:370")
K3 = dict(name="flash_flat_fwd", route="cuda", source="paddle_tpu_torch/csrc/flash_flat_fwd.cu",
          replaces="paddle_tpu/ops/flash_attention_flat.py:236")
K3B = dict(name="flash_flat_bwd", route="cuda", source="paddle_tpu_torch/csrc/flash_flat_bwd.cu",
           replaces="paddle_tpu/ops/flash_attention_flat.py:293")
KERNELS = (K1, K2, K3, K3B, K4, K4B)

# the GPT-MoE of bench.py:_measure_moe (bench.py:304): h 1024, 8 layers, 16
# heads, 8 experts in every second block, capacity factor 2.0; its step is
# f32 AdamW (lr 1e-4) at ids [8, 1024]
MOE_CFG = dict(vocab_size=50304, hidden_size=1024, num_layers=8, num_heads=16, max_seq_len=1024,
               moe=8, moe_every=2, moe_capacity_factor=2.0)
MOE_TRAIN = dict(batch=8, seq=1024, lr=1e-4, warmup=2, steps=5, check_batch=2)
# K4 and K4b against their plain versions, for each output (y, s, dx, dw1,
# db1, dw2, db2): the largest |kernel - plain| over the largest |plain|.
# f32: 2e-5 (true f32 on both sides, sums of up to 4096 terms in another
# order). bf16: 1e-2, the kernel's bf16 outputs against the plain version in
# f32 on the same bf16 inputs (the kernel rounds h, dh and its outputs to
# bf16, 2**-8 relative each).
MOE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# one f32 step through pallas_sorted against one through dense from the same
# weights and routing seeds: the loss (about ln V) within rtol 1e-5, each
# gradient within a relative L2 error of 1e-4, the eval logits within
# atol 1e-4 / rtol 1e-4 (the expert FFN's f32 sums in another order, carried
# through 8 layers)
MOE_CHECK_TOL = dict(loss_rtol=1e-5, grad_rel_l2_max=1e-4, logits_atol=1e-4, logits_rtol=1e-4)
NO_LIBRARY = "none (no single PyTorch call computes a grouped FFN)"

# BERT-base MLM pre-training as bench_suite.py:bench_bert runs it (BertConfig(),
# ids [16, 512], AdamW lr 1e-4, AMP O2), on padded rows: lengths uniform in
# [64, 512] from seed 0, the last row 512 long
BERT_TRAIN = dict(batch=16, seq=512, lr=1e-4, warmup=3, steps=10, check_batch=2, mlm_tokens=64)
# K3 and K3b against their plain versions, for out and dq, dk, dv: the
# largest |kernel - plain| over the largest |plain|, as MOE_TOL (f32 sums in
# another order; bf16 results rounded once against the plain version in f32
# on the same bf16 inputs)
FLAT_TOL = MOE_TOL
# K3's row statistics against the plain version's: log l within atol 1e-4,
# the row max m within 1e-5 of max(1, |m|) (the f32 score of a row whose
# every key carries the -1e30 bias is about -1e30)
STATS_TOL = dict(log_l=1e-4, m_rel=1e-5)
# bert_curves: the 13 O2 losses through K3/K3b against those through
# sdpa=xla from the same weights, per step within rtol 2e-2 (about five bf16
# roundings, 2**-8 each: attention's bf16 gradients rounded at other places,
# carried through 12 AdamW updates)
BERT_CURVE_RTOL = 2e-2

# the two single-chip flagship steps of bench_1p3b.py:_tpu_run. GPT-3 1.3B
# (_tpu_run(False)): GPTConfig.gpt3_1p3b with selective recompute, AMP O2
# TrainStep over AdamW(1e-4) with 2 accumulated micro-batches, ids [4, 2048]
# from np.random.default_rng(0) with labels = ids, 2 warm-up and 6 timed
# steps. ERNIE 3.0 xbase (_tpu_run(True)): vocab 40000, MLM + SOP, no
# attention mask, ids [16, 512] with every second position's MLM label -100
# and random SOP labels, AMP O2 AdamW(1e-4), 2 warm-up and 8 timed steps.
GPT3_TRAIN = dict(batch=4, seq=2048, accumulate=2, lr=1e-4, warmup=2, steps=6)
ERNIE_TRAIN = dict(batch=16, seq=512, vocab=40000, lr=1e-4, warmup=2, steps=8, check_batch=2)
# bench_suite.py:bench_resnet50: resnet50(num_classes=1000), Momentum(lr 0.1,
# momentum 0.9), CrossEntropyLoss, AMP O2, [128, 3, 224, 224] normal inputs
# (np.random.default_rng(0)) and int64 labels (default_rng(1)), 3 warm-up and
# 20 timed steps; bench_mnist: LeNet, Momentum(lr 0.01), [64, 1, 28, 28],
# 3 warm-up then 20 timed eager steps and 200 timed TrainStep steps
RESNET_TRAIN = dict(batch=128, size=224, classes=1000, lr=0.1, warmup=3, steps=20)
LENET_TRAIN = dict(batch=64, lr=0.01, warmup=3, eager_steps=20, steps=200)
# resnet_check: one step of ResNet50 at [8, 3, 64, 64] on the card and on
# the CPU from the same weights and inputs, in f32 (TF32 off) and in float64.
# A ResNet at random initialisation is ill-conditioned in training mode: its
# batch norms over few values per channel and 16 residual blocks carry each
# f32 rounding into the gradients many thousandfold. Measured on the CPU at
# this shape: the port's f32 step against its float64 step, loss 2.3e-6
# relative, gradients up to 2.2e-2 relative L2 (median 1.6e-2), buffers
# 2.8e-5 apart, eval logits 1.8e-6; the f32 step on 1 thread against 8
# threads (sums in another order), gradients up to 1.0e-2; the float64
# step on 1 against 8 threads, gradients up to 5.0e-14, loss 1.7e-15,
# buffers 1.2e-14, eval 1.5e-15. So f32 holds the loss to rtol 1e-5, the
# buffers to atol 1e-4, the eval logits to a relative L2 of 1e-5 and the
# gradients to 5e-2, which catches only a gross fault; float64 holds the
# gradients to 1e-9 and the rest to 1e-12, which catches any fault above
# the rounding.
RESNET_CHECK = dict(batch=8, size=64, lr=0.1)
RESNET_CHECK_TOL = {
    torch.float32: dict(loss_rtol=1e-5, grad_rel_l2_max=5e-2, buffers_atol=1e-4,
                        eval_rel_l2_max=1e-5),
    torch.float64: dict(loss_rtol=1e-12, grad_rel_l2_max=1e-9, buffers_atol=1e-12,
                        eval_rel_l2_max=1e-12)}
# recompute_check, accum_check and ernie_check run the configs at full width
# cut to this depth
CHECK_LAYERS = 2
# the d = 128 attention calls of those steps, (b, s, h, d, causal), both bf16
# (AMP O2) through views of the packed [b, s, 3, h, d] projection: the 1.3B
# step's per micro-batch (attention_core, whose backward writes one packed
# gradient) and ERNIE's (sdpa/flash, whose backward makes three buffers)
D128_CALLS = {"gpt3_1p3b_train": (2, 2048, 16, 128, True), "ernie_train": (16, 512, 24, 128, False)}


def launch_counters():
    """Each kernel's wrapper, whose ``launches`` counts its kernel's
    launches."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_attention_flat as ff
    from paddle_tpu_torch.ops import moe_pallas as mp

    return {K1["name"]: fa.flash_attention_fwd, K2["name"]: fa.flash_attention_bwd,
            K3["name"]: ff.flash_flat_fwd, K3B["name"]: ff.flash_flat_bwd,
            K4["name"]: mp.moe_grouped_ffn_fwd, K4B["name"]: mp.moe_grouped_ffn_bwd}


def reset_launches():
    for wrapper in launch_counters().values():
        wrapper.launches = 0


def read_launches():
    return {name: wrapper.launches for name, wrapper in launch_counters().items()}


def emit(**fields):
    print(json.dumps(fields), flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds of ``fn`` on the card, by CUDA events over ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, s, h, d, causal, dtype, backward=False):
    """The least time (ms) the card needs for one attention forward or
    backward: the larger of the bytes it must move over the memory rate, and
    its matmul flops over the peak rate for the dtype. Forward: q, k, v read
    once, out and lse written once; 2 matmuls, 4 d flops per visible
    query-key pair. Backward: q, k, v, out, dout and lse read once, dq, dk,
    dv written once; 5 matmuls, 10 d flops per visible pair."""
    elem = torch.finfo(dtype).bits // 8
    tensors = 8 if backward else 4
    nbytes = tensors * b * s * h * d * elem + b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = (10 if backward else 4) * b * h * d * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit(phase="device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi.splitlines()[0], torch=torch.__version__, cuda=torch.version.cuda)


def sass_counts(library):
    """The tensor-core instructions of each kernel of a built library, from
    ``cuobjdump -sass``: ``{kernel: {"HGMMA": n, "HMMA": n}}``. HGMMA is
    wgmma (Hopper's warpgroup MMA), HMMA is mma.sync."""
    from pathlib import Path

    from paddle_tpu_torch.ops import _cuda

    tool = Path(_cuda.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :", 1)[1].strip()
            counts[kernel] = {"HGMMA": 0, "HMMA": 0}
        elif kernel is not None:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in line:
                    counts[kernel][op] += 1
    return counts


def ptxas_by_kernel(log):
    """Registers, stack frame and spills of each kernel in an ``nvcc -Xptxas
    -v`` report: ``{kernel: {"registers", "stack", "spill_stores",
    "spill_loads"}}`` (bytes, mangled names)."""
    import re

    out, kernel = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            kernel = m.group(1)
            out[kernel] = {}
        elif kernel is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            out[kernel].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        elif m := re.search(r"Used (\d+) registers", line):
            out[kernel]["registers"] = int(m.group(1))
    return out


def phase_build():
    """Builds every kernel, reports ptxas's registers and spills, and counts
    the tensor-core instructions in the kernels' SASS: every bf16 instance
    of K1, K2, K3 and K3b (the ``*_tc`` kernels; the bf16 di pre-kernel is
    SIMT, as is every f32 instance) must hold HGMMA or HMMA; every bf16
    instance of K4 and K4b (``*_tc``) HGMMA (wgmma) and no HMMA, and their
    other kernels (f32 SIMT, the fill and the column sums) neither."""
    from paddle_tpu_torch.ops import _cuda

    names = [K["name"] for K in KERNELS]
    seconds = _cuda.build(names)
    ptxas = {n: [ln.strip() for ln in _cuda.library_path(n).with_name(
        _cuda.library_path(n).name + ".log").read_text().splitlines()
        if "registers" in ln or ("spill" in ln and not ln.strip().startswith("0 bytes stack"))]
        for n in names}
    flash = [K["name"] for K in (K1, K2, K3, K3B)]
    moe = [K["name"] for K in (K4, K4B)]
    sass = {n: sass_counts(_cuda.library_path(n)) for n in flash + moe}
    bf16 = {n: {k: c for k, c in sass[n].items() if "_tc" in k} for n in flash + moe}
    missing = [n for n in flash + moe if not bf16[n]] + [
        k for n in flash for k, c in bf16[n].items() if c["HGMMA"] == 0 and c["HMMA"] == 0] + [
        k for n in moe for k, c in bf16[n].items() if c["HGMMA"] == 0 or c["HMMA"] > 0]
    simt_with_tensor_cores = [k for n in moe for k, c in sass[n].items()
                              if "_tc" not in k and c["HGMMA"] + c["HMMA"] > 0]
    # the bf16 d = 128 instances of K1 and K2 (the tensor-core kernels and
    # K2's di pre-kernel), which the 1.3B and ERNIE steps run
    d128 = {n: {k: v for k, v in ptxas_by_kernel(_cuda.library_path(n).with_name(
        _cuda.library_path(n).name + ".log").read_text()).items()
        if "Li128E" in k and ("_tc" in k or "nv_bfloat16" in k)} for n in (K1["name"], K2["name"])}
    ok = not missing and not simt_with_tensor_cores
    emit(phase="build", ok=ok, seconds=seconds, ptxas=ptxas, sass_tensor_core=sass,
         bf16_without_tensor_cores=missing, simt_with_tensor_cores=simt_with_tensor_cores,
         ptxas_bf16_d128=d128)
    if not ok:
        raise AssertionError(f"bf16 kernels without (or K4/K4b with mma.sync) tensor-core "
                             f"instructions: {missing}; K4/K4b SIMT kernels with them: "
                             f"{simt_with_tensor_cores}")


def phase_k1():
    """K1 against its plain version; returns the row of the main path's
    shape ([8, 1024, 16, 64] causal f32, as the forward calls it), the row
    of the O2 training step's call (the same shape in bf16, through views of
    one packed [b, s, 3, h, d] projection) and the rows of the d = 128 calls
    of the 1.3B and ERNIE steps (:data:`D128_CALLS`), by path."""
    from paddle_tpu_torch.ops import flash_attention as fa

    cases = [(8, 1024, 16, 64, causal, dt, False) for causal in (True, False)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 1024, 16, 128, True, dt, False) for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 1000, 16, 64, True, dt, False) for dt in (torch.float32, torch.bfloat16)]
    # views of one packed [b, s, 3, h, d] projection, as attention_core/flash
    # calls K1 in the forward and the training step
    cases += [(8, 1024, 16, 64, True, dt, True) for dt in (torch.float32, torch.bfloat16)]
    cases += [(*call, torch.bfloat16, True) for call in D128_CALLS.values()]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main_row, bf16_row, d128_rows, failures = None, None, {}, []
    for b, s, h, d, causal, dt, packed in cases:
        if packed:
            qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(dt)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
                       for _ in range(3))
        before = fa.flash_attention_fwd.launches
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        launched = fa.flash_attention_fwd.launches - before
        want, want_lse = fa._reference_attention(q.float(), k.float(), v.float(), causal)
        err = (out.float() - want).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        atol, rtol = TOL[dt]
        ok = (bool(torch.isfinite(out).all()) and launched == 1
              and bool(((out.float() - want).abs() <= atol + rtol * want.abs()).all())
              and bool(((lse - want_lse).abs() <= LSE_TOL[0] + LSE_TOL[1] * want_lse.abs()).all()))
        del want, want_lse
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal), iters=10)
        plain_ms = cuda_ms(lambda: fa._reference_attention(q, k, v, causal), iters=3, warmup=1)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal), iters=10)
        bound_ms, bound_by = attention_bound(b, s, h, d, causal, dt)
        row = dict(shape=[b, s, h, d], causal=causal, dtype=str(dt).split(".")[-1],
                   packed_qkv=packed, max_abs_err=err, lse_max_abs_err=lse_err, atol=atol,
                   rtol=rtol, ok=ok, launches=launched, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit(phase="kernels", kernel=K1["name"], **row)
        if not ok:
            failures.append(row)
        if (b, s, h, d, causal, dt, packed) == (8, 1024, 16, 64, True, torch.float32, False):
            main_row = row
        if (b, s, h, d, causal, dt, packed) == (8, 1024, 16, 64, True, torch.bfloat16, True):
            bf16_row = row
        d128_rows.update({path: row for path, call in D128_CALLS.items()
                          if (b, s, h, d, causal, dt, packed) == (*call, torch.bfloat16, True)})
        del q, k, v
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K1 disagrees with its plain version in {len(failures)} case(s)")
    return main_row, bf16_row, d128_rows


def _k2_cases():
    cases = [(8, 1024, 16, 64, causal, dt, False) for causal in (True, False)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 1024, 16, 128, True, dt, False) for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 1000, 16, 64, True, dt, False) for dt in (torch.float32, torch.bfloat16)]
    # views of one packed [b, s, 3, h, d] projection and gradient, as the
    # training step's attention_core/flash calls K2
    cases += [(8, 1024, 16, 64, True, dt, True) for dt in (torch.float32, torch.bfloat16)]
    # the d = 128 calls of the 1.3B step (packed gradient, as attention_core
    # writes it) and of ERNIE's (q, k, v views, new gradient buffers, as
    # sdpa/flash runs K2)
    cases += [(*D128_CALLS["gpt3_1p3b_train"], torch.bfloat16, True),
              (*D128_CALLS["ernie_train"], torch.bfloat16, "views")]
    return cases


def phase_k2():
    """K2 against its plain version; returns the row of the main path's
    call ([8, 1024, 16, 64] causal bf16 through packed-qkv strides, as the
    O2 training step makes it) and the rows of the d = 128 calls of the
    1.3B and ERNIE steps, by path. ``packed``: True for views of a packed
    projection whose gradient K2 writes into one packed buffer, ``"views"``
    for the same views with new gradient buffers."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    main_row, d128_rows, failures = None, {}, []
    for b, s, h, d, causal, dt, packed in _k2_cases():
        grads = None
        if packed:
            qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(dt)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if packed is True:
                dqkv = torch.empty_like(qkv)
                grads = (dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2])
        else:
            q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt) for _ in range(3))
            grads = None
        dout = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
        with torch.no_grad():
            out, lse = fa.flash_attention_fwd(q, k, v, causal)
        before = fa.flash_attention_bwd.launches
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal, grads=grads)
        torch.cuda.synchronize()
        launched = fa.flash_attention_bwd.launches - before
        want = fa._reference_attention_bwd(q.float(), k.float(), v.float(), out.float(), lse,
                                           dout.float(), causal)
        atol, rtol = GRAD_TOL[dt]
        errs = [(g.float() - w).abs().max().item() for g, w in zip(got, want)]
        ok = (launched == 1 and all(bool(torch.isfinite(g).all()) for g in got)
              and all(bool(((g.float() - w).abs() <= atol + rtol * w.abs()).all())
                      for g, w in zip(got, want))
              and (grads is None or all(g.data_ptr() == t.data_ptr() for g, t in zip(got, grads))))
        del want
        ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, causal, grads=grads),
                     iters=10)
        plain_ms = cuda_ms(lambda: fa._reference_attention_bwd(q, k, v, out, lse, dout, causal),
                           iters=3, warmup=1)
        # the backward alone of PyTorch's fused attention on the same inputs
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
        gh = dout.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh,
                                                         retain_graph=True), iters=10)
        del lib_out, qh, kh, vh
        bound_ms, bound_by = attention_bound(b, s, h, d, causal, dt, backward=True)
        row = dict(shape=[b, s, h, d], causal=causal, dtype=str(dt).split(".")[-1],
                   packed_qkv=bool(packed), packed_grads=grads is not None, max_abs_err=max(errs),
                   dq_dk_dv_max_abs_err=errs, atol=atol,
                   rtol=rtol, ok=ok, launches=launched, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit(phase="kernels", kernel=K2["name"], **row)
        if not ok:
            failures.append(row)
        if (b, s, h, d, causal, dt, packed) == (8, 1024, 16, 64, True, torch.bfloat16, True):
            main_row = row
        d128_rows.update({path: row for path, call in D128_CALLS.items()
                          if (b, s, h, d, causal, dt) == (*call, torch.bfloat16) and packed})
        del q, k, v, dout, out, lse, got, grads
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K2 disagrees with its plain version in {len(failures)} case(s)")
    return main_row, d128_rows


def phase_forward(model, ids):
    """The full-width eval forward through ``attention_core``/``flash``,
    against the same model forced onto the plain ``xla`` impl."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import registry

    registry.clear_cache()
    metrics.reset_counters("kernels.")
    before = fa.flash_attention_fwd.launches
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    picked = metrics.counters("kernels.attention_core.")
    launched = fa.flash_attention_fwd.launches - before
    peak = torch.cuda.max_memory_allocated()
    set_flags({"FLAGS_kernel_overrides": "attention_core=xla"})
    try:
        with torch.no_grad():
            ref = model(ids)
    finally:
        set_flags({"FLAGS_kernel_overrides": ""})
    torch.cuda.synchronize()
    L = model.gpt.cfg.num_layers
    diff = (logits - ref).abs()
    atol, rtol = LOGITS_TOL
    ok = (picked == {"kernels.attention_core.picked": 1, "kernels.attention_core.fallback": 0}
          and launched == L and fa.flash_attention_fwd.launches - before == L  # xla launched none
          and tuple(logits.shape) == (*ids.shape, model.gpt.cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and bool((diff <= atol + rtol * ref.abs()).all()))
    emit(phase="forward", ok=ok, ids=list(ids.shape), attention_core=picked, k1_launches=launched,
         logits_max_abs_err_vs_xla=diff.max().item(), atol=atol, rtol=rtol, seconds=seconds,
         tokens_per_s=ids.numel() / seconds, max_memory_allocated=peak)
    if not ok:
        raise AssertionError("forward phase failed")


def phase_serve(model):
    """16 greedy requests through DecodeEngine + ContinuousBatchingScheduler,
    each checked against ``model.generate()`` on its prompt."""
    from paddle_tpu_torch.inference import ContinuousBatchingScheduler, DecodeEngine
    from paddle_tpu_torch.ops import flash_attention as fa

    n_req, new_tokens = SERVE["requests"], SERVE["new_tokens"]
    lo, hi = SERVE["prompt_lens"]
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, model.gpt.cfg.vocab_size, (int(n),)) for n in rng.integers(lo, hi + 1, n_req)]
    engine = DecodeEngine(model, max_batch_slots=SERVE["slots"], max_seq_len=SERVE["max_seq_len"],
                          prefill_buckets=SERVE["buckets"])
    spent = {"prefill_step": [0, 0.0], "decode_step": [0, 0.0]}  # calls, seconds

    def timed(name):
        step = getattr(engine, name)

        def run(*a, **kw):  # both steps end in host values: synchronised
            t = time.perf_counter()
            out = step(*a, **kw)
            spent[name][0] += 1
            spent[name][1] += time.perf_counter() - t
            return out

        setattr(engine, name, run)

    timed("prefill_step")
    timed("decode_step")
    sched = ContinuousBatchingScheduler(engine)
    before = fa.flash_attention_fwd.launches
    t0 = time.perf_counter()
    rids = [sched.submit(p, max_new_tokens=new_tokens) for p in prompts]
    done = sched.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    served = [done[r].tokens for r in rids]
    # a decode step reads every weight and, attending over the whole static
    # cache, every K/V row of every slot: its least time is those bytes
    step_bytes = sum(p.numel() * p.element_size() for p in model.parameters()) + engine.cache_bytes()
    decode_tokens = sum(len(t) - 1 for t in served)  # the first token comes from prefill
    mismatched = [i for i, p in enumerate(prompts)
                  if served[i] != model.generate(p, max_new_tokens=new_tokens)[0, len(p):].tolist()]
    ok = not mismatched and all(len(t) == new_tokens for t in served)
    emit(phase="serve", ok=ok, requests=n_req, new_tokens=new_tokens,
         prompt_lens=[len(p) for p in prompts], mismatched_vs_generate=mismatched,
         seconds=seconds, requests_per_s=n_req / seconds,
         decode_tokens_per_s=decode_tokens / spent["decode_step"][1],
         prefills=spent["prefill_step"][0], prefill_seconds=spent["prefill_step"][1],
         decode_steps=spent["decode_step"][0], decode_seconds=spent["decode_step"][1],
         decode_step_bound_ms=1e3 * step_bytes / PEAK_BYTES,
         ttft_p50_s=float(np.median([done[r].ttft_seconds for r in rids])),
         k1_launches=fa.flash_attention_fwd.launches - before)
    if not ok:
        raise AssertionError(f"served tokens differ from generate() for requests {mismatched}")


def _model_flops_per_step(cfg, batch, seq):
    """Model flops of one training step: 6 per matmul weight and token (the
    trunk's qkv, out, ffn1 and ffn2 weights and the LM head, tied to the word
    embedding), plus the causal attention matmuls, forward (4 d flops per
    visible query-key pair and head) and backward (twice that)."""
    D, L, F = cfg.hidden_size, cfg.num_layers, cfg.ffn_hidden_size
    n_matmul = L * (3 * D * D + D * D + 2 * D * F) + cfg.vocab_size * D
    pairs = seq * (seq + 1) // 2
    attention = 12 * batch * cfg.num_heads * (D // cfg.num_heads) * pairs * L
    return 6 * n_matmul * batch * seq + attention


def _kernel_group(name):
    """The group of a device kernel by its name, for the step's breakdown."""
    if "flash_flat_fwd_kernel" in name:
        return "K3 flash_flat_fwd"
    if "flat_bwd_" in name:
        return "K3b flash_flat_bwd"
    if "moe_ffn_fwd_" in name:
        return "K4 moe_grouped_ffn_fwd"
    if "moe_ffn_bwd_" in name:
        return "K4b moe_grouped_ffn_bwd"
    if "flash_fwd_kernel" in name:
        return "K1 flash_attention_fwd"
    if "bwd_dq_kernel" in name or "bwd_dkv_kernel" in name or "bwd_di_kernel" in name:
        return "K2 flash_attention_bwd"
    # the vision step's cuDNN convolutions (implicit-GEMM kernels named by
    # pass), its layout transposes, batch norms (ATen) and pools
    if "wgrad" in name:
        return "conv wgrad (cuDNN)"
    if "dgrad" in name:
        return "conv dgrad (cuDNN)"
    if "fprop" in name or "convolve" in name or "conv2d" in name.lower():
        return "conv forward (cuDNN)"
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "NCHW <-> NHWC transposes"
    if "batch_norm" in name or "bn_fw" in name or "bn_bw" in name:
        return "batch norm"
    if "pool" in name.lower():
        return "pooling"
    if any(t in name for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "foreach" in name or "multi_tensor" in name:
        return "optimizer (foreach)"
    if "reduce" in name.lower():
        return "reductions"
    return "other elementwise"


def profile_step(step, inputs, labels):
    """One step under ``torch.profiler``: device time by kernel group, the
    busy time (union of kernel intervals) and the step's host time, so the
    device's idle share. Returns None where the trace holds no device
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(inputs, labels)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    groups, by_name = {}, {}
    for e in kernels:
        g = _kernel_group(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us()
        by_name[e.name[:100]] = by_name.get(e.name[:100], 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, -1.0
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(step_ms=wall_us / 1e3, device_busy_ms=busy / 1e3, idle_share=1 - busy / wall_us,
                kernels=len(kernels),
                device_ms_by_group={g: t / 1e3 for g, t in sorted(groups.items(), key=lambda x: -x[1])},
                top_kernels_ms={n: t / 1e3 for n, t in sorted(by_name.items(), key=lambda x: -x[1])[:12]})


def phase_train():
    """bench.py's flagship step at full width: AMP O2 TrainStep over AdamW,
    3 warm-up steps then 10 timed steps (synchronised) on one ids batch with
    labels = ids, then one step traced for its breakdown. Returns the K1 and
    K2 launches of the 13 counted steps."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(**SERVE_CFG)
    b, s = TRAIN["batch"], TRAIN["seq"]
    model = GPTForPretraining(cfg, seed=SEED)
    step = TrainStep(model, AdamW(learning_rate=TRAIN["lr"], parameters=model.parameters()),
                     GPTPretrainingCriterion(), amp_level="O2")
    ids = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
    registry.clear_cache()
    metrics.reset_counters("kernels.")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(ids, ids)["loss"]) for _ in range(TRAIN["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(ids, ids)["loss"] for _ in range(TRAIN["steps"])]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses += [float(x) for x in timed]
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    # one more step, traced: where its time goes (outside the counted steps)
    breakdown = profile_step(step, ids, ids)
    picked = metrics.counters("kernels.attention_core.")
    n_steps = TRAIN["warmup"] + TRAIN["steps"]
    per_step = {k: v / n_steps for k, v in launches.items()}
    ms_per_step = 1e3 * seconds / TRAIN["steps"]
    bound_ms = 1e3 * _model_flops_per_step(cfg, b, s) / PEAK_FLOPS[torch.bfloat16]
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0]
          and picked == {"kernels.attention_core.picked": 1, "kernels.attention_core.fallback": 0}
          and per_step == {K1["name"]: cfg.num_layers, K2["name"]: cfg.num_layers,
                           K3["name"]: 0, K3B["name"]: 0, K4["name"]: 0, K4B["name"]: 0}
          and all(p.dtype == torch.float32 for p in model.parameters()))
    emit(phase="train", ok=ok, ids=[b, s], amp_level="O2", losses=losses, attention_core=picked,
         launches=launches, launches_per_step=per_step, seconds=seconds, ms_per_step=ms_per_step,
         tokens_per_s=b * s * TRAIN["steps"] / seconds,
         max_memory_allocated=peak, model_flops_per_step=_model_flops_per_step(cfg, b, s),
         model_flops_bound_ms=bound_ms, bound_share=bound_ms / ms_per_step, profile=breakdown)
    if not ok:
        raise AssertionError("train phase failed")
    return launches


def _grad_rel_l2(grads, ref):
    """Each gradient's relative L2 distance from ``ref``'s."""
    return {n: (float((grads[n] - ref[n]).norm() / ref[n].norm()) if ref[n].norm() > 0
                else float(grads[n].norm())) for n in ref}


def check_step_against_xla(phase, model, inputs, labels, loss_fn, xla_override, bwd_kernel,
                           layers, flat=False):
    """One f32 step (no AMP) through the kernels and through the plain
    ``xla`` impl (``xla_override``), from the same weights, with
    ``FLAGS_flash_flat`` set to ``flat``: the losses and every parameter's
    gradient agree (``TRAIN_CHECK_TOL``), and ``bwd_kernel`` runs once per
    each of the model's ``layers`` on the kernel path and never on the
    plain one."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW

    start = {n: t.clone() for n, t in model.state_dict().items()}

    def one_step(overrides):
        model.load_state_dict(start)
        registry.clear_cache()
        set_flags({"FLAGS_kernel_overrides": overrides, "FLAGS_flash_flat": flat})
        try:
            before = read_launches()[bwd_kernel["name"]]
            step = TrainStep(model, AdamW(learning_rate=TRAIN["lr"], parameters=model.parameters()),
                             loss_fn)
            loss = float(step(inputs, labels)["loss"])
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            return loss, grads, read_launches()[bwd_kernel["name"]] - before
        finally:
            set_flags({"FLAGS_kernel_overrides": "", "FLAGS_flash_flat": False})
            registry.clear_cache()

    loss_k, g_k, n_k = one_step("")
    loss_xla, g_xla, n_xla = one_step(xla_override)
    rel = _grad_rel_l2(g_k, g_xla)
    worst = max(rel, key=rel.get)
    ok = (n_k == layers and n_xla == 0
          and abs(loss_k - loss_xla) <= TRAIN_CHECK_TOL["loss_rtol"] * abs(loss_xla)
          and rel[worst] <= TRAIN_CHECK_TOL["grad_rel_l2_max"])
    emit(phase=phase, ok=ok, ids=list(inputs[0].shape), flash_flat=flat, loss_kernels=loss_k,
         loss_xla=loss_xla, grad_rel_l2_worst=rel[worst], worst=worst, grad_rel_l2=rel,
         **TRAIN_CHECK_TOL, bwd_kernel=bwd_kernel["name"], bwd_launches=n_k)
    if not ok:
        raise AssertionError(f"{phase} phase failed: kernel and xla steps disagree")


def _gpt_check_model():
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining

    model = GPTForPretraining(GPTConfig(**SERVE_CFG), seed=SEED + 3)
    ids = torch.randint(0, SERVE_CFG["vocab_size"], (TRAIN["check_batch"], TRAIN["seq"]),
                        device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 4))
    return model, ids


def phase_train_check():
    """One f32 step of the full-width GPT at batch 2 through
    ``attention_core``/``flash`` (K1 + K2) and through ``xla``."""
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion

    model, ids = _gpt_check_model()
    check_step_against_xla("train_check", model, (ids,), (ids,), GPTPretrainingCriterion(),
                           "attention_core=xla", K2, SERVE_CFG["num_layers"])


def phase_flat_check():
    """As ``train_check`` with ``FLAGS_flash_flat`` on: ``attention_core``
    picks ``flash_packed`` (K3 + K3b over the packed projection, no mask),
    against ``xla``."""
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion

    model, ids = _gpt_check_model()
    check_step_against_xla("flat_check", model, (ids,), (ids,), GPTPretrainingCriterion(),
                           "attention_core=xla", K3B, SERVE_CFG["num_layers"], flat=True)


def moe_ffn_bound(E, cap, D, H, dtype, backward=False, live=None):
    """The least time (ms) the card needs for K4 or K4b over ``E * cap``
    rows of which ``live`` (default: all) hold a token: the larger of the
    bytes it must move over the memory rate, and its matmul flops over the
    peak rate for the dtype. Forward: the live rows of xg and w1, b1, w2, b2
    read once, y and the f32 s written once (every row); 2 products over the
    live rows, 4 L D H flops. Backward: the live rows of xg, dy and the f32 s
    and w1, w2 read once, dx (every row), dw1, db1, dw2, db2 written once; 4
    products, 8 L D H flops."""
    elem = torch.finfo(dtype).bits // 8
    R = E * cap
    L = R if live is None else live
    weights = 2 * E * D * H + E * (D + H)
    if backward:
        nbytes = (2 * L * D + 2 * E * D * H) * elem + L * H * 4 + (R * D + weights) * elem
    else:
        nbytes = (L * D + weights + R * D) * elem + R * H * 4
    flops = (8 if backward else 4) * L * D * H
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _moe_cases(step_rows):
    """(E, cap, D, H, dtype, activation, layer): the main call first, at
    each MoE layer's live rows in ``step_rows`` (``layer`` indexes it), and
    then with every row live (``layer`` None)."""
    full = (8, 4096, 1024, 4096)  # the GPT-MoE step's call: E, cap, D, H
    cases = [(*full, dt, "gelu", layer) for layer in (*range(len(step_rows)), None)
             for dt in (torch.float32, torch.bfloat16)]
    # H <= 512 (the reference's single-hidden-tile kernels) and a capacity
    # that is no multiple of the 128-row tile
    cases += [(8, 4096, 1024, 512, dt, "gelu", None) for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 1000, 1024, 4096, dt, "gelu", None) for dt in (torch.float32, torch.bfloat16)]
    # ragged in every dimension, and the other activations
    cases += [(3, 77, 200, 328, torch.float32, "relu", None),
              (3, 77, 200, 328, torch.bfloat16, "silu", None)]
    return cases


def phase_moe_kernels(step_rows):
    """K4 and K4b against their plain versions; returns the rows of the main
    path's call ([8 x 4096, 1024] rows, H 4096, f32 gelu) at the first MoE
    layer's live rows in ``step_rows`` (each MoE layer's rows per expert at
    ``moe_train``'s traced step). Every row of xg and dy holds random
    values: past ``rows[e]`` they are junk that the kernels and the plain
    versions must ignore."""
    from paddle_tpu_torch.ops import moe_pallas as mp

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    main, failures = {}, []
    for E, cap, D, H, dt, act, layer in _moe_cases(step_rows):
        def rand(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dt)

        args = (rand(E * cap, D), rand(E, D, H, scale=D ** -0.5), rand(E, 1, H, scale=0.1),
                rand(E, H, D, scale=H ** -0.5), rand(E, 1, D, scale=0.1))
        dy = rand(E * cap, D)
        rows = None if layer is None else torch.tensor(step_rows[layer], dtype=torch.int32,
                                                       device="cuda")
        n_live = E * cap if rows is None else int(rows.sum())
        before = read_launches()
        y, s = mp.moe_grouped_ffn_fwd(*args, act, rows)
        grads = mp.moe_grouped_ffn_bwd(*args, s, dy, act, rows)
        torch.cuda.synchronize()
        after = read_launches()
        ref = [t.float() for t in args]
        want_y, want_s = mp._reference_ffn_fwd(*ref, act, rows)
        want = (want_y, want_s) + mp._reference_ffn_bwd(*ref, want_s, dy.float(), act, rows)
        got = (y, s) + tuple(grads)
        names = ("y", "s", "dx", "dw1", "db1", "dw2", "db2")
        abs_err = {n: (g.float() - w).abs().max().item() for n, g, w in zip(names, got, want)}
        rel_err = {n: abs_err[n] / w.abs().max().item() for n, w in zip(names, want)}
        del want, want_y, want_s, ref
        fwd_ok = all(bool(torch.isfinite(g).all()) for g in got) and all(
            rel_err[n] <= MOE_TOL[dt] for n in names[:2])
        bwd_ok = all(rel_err[n] <= MOE_TOL[dt] for n in names[2:])
        launched = {K4["name"]: after[K4["name"]] - before[K4["name"]],
                    K4B["name"]: after[K4B["name"]] - before[K4B["name"]]}
        big = E * cap * D * H > 1e9
        timing = {
            K4["name"]: (cuda_ms(lambda: mp.moe_grouped_ffn_fwd(*args, act, rows),
                                 iters=5 if big else 20),
                         cuda_ms(lambda: mp._reference_ffn_fwd(*args, act, rows), iters=3,
                                 warmup=1),
                         moe_ffn_bound(E, cap, D, H, dt), moe_ffn_bound(E, cap, D, H, dt,
                                                                        live=n_live)),
            K4B["name"]: (cuda_ms(lambda: mp.moe_grouped_ffn_bwd(*args, s, dy, act, rows),
                                  iters=5 if big else 20),
                          cuda_ms(lambda: mp._reference_ffn_bwd(*args, s, dy, act, rows), iters=3,
                                  warmup=1),
                          moe_ffn_bound(E, cap, D, H, dt, backward=True),
                          moe_ffn_bound(E, cap, D, H, dt, backward=True, live=n_live)),
        }
        del y, s, grads, got, dy, args
        for K, ok, outs in ((K4, fwd_ok, names[:2]), (K4B, bwd_ok, names[2:])):
            ms, plain_ms, (bound_ms, bound_by), (bound_live_ms, bound_live_by) = timing[K["name"]]
            flops = (4 if K is K4 else 8) * n_live * D * H
            row = dict(shape=[E * cap, D, H], experts=E, capacity=cap, dtype=str(dt).split(".")[-1],
                       activation=act, layer=layer, rows=None if rows is None else rows.tolist(),
                       fill=n_live / (E * cap), max_abs_err=max(abs_err[n] for n in outs),
                       rel_err={n: rel_err[n] for n in outs}, rel_tol=MOE_TOL[dt],
                       ok=ok and launched[K["name"]] == 1, launches=launched[K["name"]], ms=ms,
                       plain_ms=plain_ms, library_ms=None, library=NO_LIBRARY, bound_ms=bound_ms,
                       bound_by=bound_by, bound_live_ms=bound_live_ms, bound_live_by=bound_live_by,
                       bound_share=bound_ms / ms, bound_live_share=bound_live_ms / ms,
                       tflops_live_rows=flops / ms / 1e9)
            emit(phase="moe_kernels", kernel=K["name"], **row)
            if not row["ok"]:
                failures.append((K["name"], row["shape"], row["dtype"], row["fill"]))
            if (E, cap, D, H, dt, act, layer) == (8, 4096, 1024, 4096, torch.float32, "gelu", 0):
                main[K["name"]] = row
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K4/K4b disagree with their plain versions in {failures}")
    return main


def _moe_flops_per_step(cfg, batch, seq, fills=None):
    """Flops of one GPT-MoE training step: the dense trunk and LM head as in
    :func:`_model_flops_per_step`, but the FFN weights of the dense blocks
    only, plus each MoE block's expert FFN (2 products forward, 4 backward)
    over its padded ``E * capacity`` rows, or over its live rows where
    ``fills`` gives each MoE layer's share of them, and its gate."""
    D, F, L, E = cfg.hidden_size, cfg.ffn_hidden_size, cfg.num_layers, cfg.moe_num_experts
    n_moe = L // cfg.moe_every
    tokens = batch * seq
    cap = max(1, math.ceil(tokens * cfg.moe_top_k * cfg.moe_capacity_factor / E))
    n_matmul = L * 4 * D * D + (L - n_moe) * 2 * D * F + n_moe * D * E + cfg.vocab_size * D
    pairs = seq * (seq + 1) // 2
    attention = 12 * batch * cfg.num_heads * (D // cfg.num_heads) * pairs * L
    rows = n_moe * E * cap if fills is None else sum(f * E * cap for f in fills)
    experts = 12 * rows * D * F
    return 6 * n_matmul * tokens + attention + experts


def expert_fill(model, ids):
    """Per MoE layer, the live rows of each expert (the dispatch's ``rows``,
    which K4/K4b compute) and their share of the ``E * capacity`` rows, in
    one training-mode forward of ``ids``: each layer's routing is
    recomputed from its input and its generator's state before the forward,
    so the jitter draws are the ones the forward made. Returns
    ``(fills, rows)``."""
    from paddle_tpu_torch.distributed.moe import MoELayer, jitter_drop_mask

    seen = []

    def hook(layer, args):
        seen.append((layer, args[0].detach(), layer.generator.get_state()))

    layers = [m for m in model.modules() if isinstance(m, MoELayer)]
    handles = [m.register_forward_pre_hook(hook) for m in layers]
    try:
        with torch.no_grad():
            model(ids)
    finally:
        for h in handles:
            h.remove()
    fills, rows = [], []
    with torch.no_grad():
        for layer, x, state in seen:
            tokens = x.reshape(-1, x.shape[-1])
            gate_vals, gate_idx = torch.topk(torch.softmax(layer.gate.score(tokens), -1),
                                             layer.top_k, dim=-1)
            dispatched = gate_idx.reshape(-1)
            if layer.training and layer.gate.random_routing and layer.top_k >= 2:
                gen = torch.Generator(device=tokens.device)
                gen.set_state(state)
                dispatched = gate_idx[~jitter_drop_mask(gate_vals, gen)]
            cap = layer.capacity(tokens.shape[0])
            counts = torch.bincount(dispatched, minlength=layer.num_experts).clamp(max=cap)
            fills.append(float(counts.sum()) / (layer.num_experts * cap))
            rows.append(counts.tolist())
    return fills, rows


def phase_moe_train():
    """bench.py's GPT-MoE step at full width: f32 TrainStep over AdamW, 2
    warm-up and 5 timed steps (synchronised) on one ids batch with labels =
    ids, GShard jitter on, through ``pallas_sorted`` and then ``moe=dense``
    (a fresh model from the same seed each); one more step of each traced.
    Returns the kernel launches of the ``pallas_sorted`` run's 7 steps and
    its traced step's live rows per expert in each MoE layer."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(**MOE_CFG)
    b, s = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    n_moe = cfg.num_layers // cfg.moe_every
    n_steps = MOE_TRAIN["warmup"] + MOE_TRAIN["steps"]
    ids = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 6))
    flops = _moe_flops_per_step(cfg, b, s)
    bound_ms = 1e3 * flops / PEAK_FLOPS[torch.float32]
    runs, main_launches, step_rows = {}, None, None
    for path, overrides in (("pallas_sorted", ""), ("dense", "moe=dense")):
        set_flags({"FLAGS_kernel_overrides": overrides})
        try:
            registry.clear_cache()
            metrics.reset_counters("kernels.")
            model = GPTForPretraining(cfg, seed=SEED)
            step = TrainStep(model, AdamW(learning_rate=MOE_TRAIN["lr"],
                                          parameters=model.parameters()),
                             GPTPretrainingCriterion())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            losses = [float(step(ids, ids)["loss"]) for _ in range(MOE_TRAIN["warmup"])]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timed = [step(ids, ids)["loss"] for _ in range(MOE_TRAIN["steps"])]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_launches()
            losses += [float(x) for x in timed]
            peak = torch.cuda.max_memory_allocated()
            picked = metrics.counters("kernels.moe.")
            breakdown = profile_step(step, ids, ids)
            fill, layer_rows = expert_fill(model, ids)
        finally:
            set_flags({"FLAGS_kernel_overrides": ""})
        ms_per_step = 1e3 * seconds / MOE_TRAIN["steps"]
        per_step = {k: v / n_steps for k, v in launches.items()}
        want = {K1["name"]: cfg.num_layers, K2["name"]: cfg.num_layers,
                K3["name"]: 0, K3B["name"]: 0,
                K4["name"]: n_moe if path == "pallas_sorted" else 0,
                K4B["name"]: n_moe if path == "pallas_sorted" else 0}
        ok = (all(np.isfinite(losses)) and losses[-1] < losses[0] and per_step == want
              and picked == {"kernels.moe.picked": int(path == "pallas_sorted"),
                             "kernels.moe.fallback": int(path == "dense")})
        runs[path] = dict(ok=ok, losses=losses, moe_kernel=picked, launches=launches,
                          launches_per_step=per_step, seconds=seconds, ms_per_step=ms_per_step,
                          tokens_per_s=b * s * MOE_TRAIN["steps"] / seconds,
                          max_memory_allocated=peak, bound_share=bound_ms / ms_per_step,
                          bound_live_share=1e3 * _moe_flops_per_step(cfg, b, s, fill)
                          / PEAK_FLOPS[torch.float32] / ms_per_step,
                          expert_row_fill=fill, expert_rows=layer_rows, profile=breakdown)
        if path == "pallas_sorted":
            main_launches, step_rows = launches, layer_rows
        del model, step
        torch.cuda.empty_cache()
    ok = all(r["ok"] for r in runs.values())
    emit(phase="moe_train", ok=ok, ids=[b, s], config=MOE_CFG, dtype="float32",
         flops_per_step=flops, flops_bound_ms=bound_ms, **runs)
    if not ok:
        raise AssertionError("moe_train phase failed")
    return main_launches, step_rows


def phase_moe_check():
    """One f32 step of the full-width GPT-MoE at batch 2 through
    ``pallas_sorted`` (K4 + K4b) and through ``dense``, from the same
    weights and routing seeds: the losses, every gradient and the eval
    logits (taken before the step) agree."""
    from paddle_tpu_torch.distributed.moe import MoELayer
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(**MOE_CFG)
    model = GPTForPretraining(cfg, seed=SEED + 7)
    start = {n: t.clone() for n, t in model.state_dict().items()}
    ids = torch.randint(0, cfg.vocab_size, (MOE_TRAIN["check_batch"], MOE_TRAIN["seq"]),
                        device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 8))

    def run(overrides):
        model.load_state_dict(start)
        registry.clear_cache()
        set_flags({"FLAGS_kernel_overrides": overrides})
        try:
            before = read_launches()
            model.eval()
            with torch.no_grad():
                logits = model(ids)[0]
            model.train()
            for m in model.modules():
                if isinstance(m, MoELayer):
                    m.generator.manual_seed(m.seed)
            step = TrainStep(model, AdamW(learning_rate=MOE_TRAIN["lr"],
                                          parameters=model.parameters()),
                             GPTPretrainingCriterion())
            loss = float(step(ids, ids)["loss"])
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            after = read_launches()
            return loss, grads, logits, {k: after[k] - before[k] for k in (K4["name"], K4B["name"])}
        finally:
            set_flags({"FLAGS_kernel_overrides": ""})

    loss_k, g_k, logits_k, n_k = run("")
    loss_d, g_d, logits_d, n_d = run("moe=dense")
    rel = _grad_rel_l2(g_k, g_d)
    worst = max(rel, key=rel.get)
    diff = (logits_k - logits_d).abs()
    tol = MOE_CHECK_TOL
    n_moe = cfg.num_layers // cfg.moe_every
    ok = (n_k == {K4["name"]: 2 * n_moe, K4B["name"]: n_moe}  # eval forward + step
          and n_d == {K4["name"]: 0, K4B["name"]: 0}
          and abs(loss_k - loss_d) <= tol["loss_rtol"] * abs(loss_d)
          and rel[worst] <= tol["grad_rel_l2_max"]
          and bool((diff <= tol["logits_atol"] + tol["logits_rtol"] * logits_d.abs()).all()))
    emit(phase="moe_check", ok=ok, ids=list(ids.shape), loss_pallas_sorted=loss_k,
         loss_dense=loss_d, grad_rel_l2_worst=rel[worst], worst=worst,
         grad_rel_l2_moe={n: r for n, r in rel.items() if ".moe." in n},
         logits_max_abs_err=diff.max().item(), launches_pallas_sorted=n_k, **tol)
    if not ok:
        raise AssertionError("moe_check phase failed: pallas_sorted and dense steps disagree")


def flat_bound(b, s, h, d, dtype, bias, causal, backward=False):
    """The least time (ms) the card needs for one K3 or K3b call: the larger
    of the bytes it must move (as :func:`attention_bound`, plus the bias
    read once) over the memory rate, and the matmul flops of the query-key
    pairs this call's data leaves live (4 d per pair forward, 10 d
    backward; a pair under a -1e30 bias entry or above the causal diagonal
    adds exactly nothing) over the peak rate for the dtype."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = (8 if backward else 4) * b * s * h * d * elem + 2 * b * h * s * 4
    live = torch.ones((1, 1, s, s), dtype=torch.bool, device="cuda")
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
        live = live & (bias > -1e29)
    if causal:
        live = live & torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
    pairs = int(live.sum()) * (b // live.shape[0]) * h
    flops = (10 if backward else 4) * d * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def padding_lengths(b, s):
    """Per-row lengths of the padded BERT batch: uniform in [64, s] from
    seed 0, the last row s long."""
    lengths = np.random.default_rng(SEED).integers(64, s + 1, b)
    lengths[-1] = s
    return lengths


def padding_mask(lengths, s, dtype=torch.float32):
    """The additive mask ``[b, 1, s, s]``: 0 where key j < len_b, -1e30
    elsewhere."""
    lens = torch.as_tensor(lengths, device="cuda")
    keep = torch.arange(s, device="cuda")[None, None, None, :] < lens[:, None, None, None]
    return torch.where(keep, 0.0, -1e30).expand(len(lengths), 1, s, s).contiguous().to(dtype)


def _flat_cases():
    """(name, b, s, h, h_kv, d, causal, dtype, bias kind)."""
    cases = [("bert", 16, 512, 12, 12, 64, False, dt, "padding")
             for dt in (torch.bfloat16, torch.float32)]
    cases += [("broadcast", 16, 512, 12, 12, 64, False, torch.float32, "broadcast"),
              ("causal_banded", 8, 1024, 16, 16, 64, True, torch.float32, "banded")]
    cases += [("gpt_packed", 8, 1024, 16, 16, 64, True, dt, None)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [("gqa", 16, 512, 12, 3, 64, False, torch.float32, "padding"),
              ("ragged", 16, 200, 12, 12, 64, False, torch.float32, "padding"),
              ("masked_row", 4, 512, 12, 12, 64, False, torch.float32, "masked_row")]
    cases += [("d128", 8, 512, 8, 8, 128, False, dt, "padding")
              for dt in (torch.bfloat16, torch.float32)]
    return cases


def _flat_bias(kind, b, s, dtype, gen):
    if kind is None:
        return None
    if kind == "padding":
        return padding_mask(padding_lengths(b, s), s, dtype)
    if kind == "broadcast":
        return torch.randn((1, 1, s, s), generator=gen, device="cuda").to(dtype)
    if kind == "banded":  # key >= query - 128
        band = torch.ones((s, s), dtype=torch.bool, device="cuda").triu(-128)
        return torch.where(band, 0.0, -1e30)[None, None].to(dtype)
    mask = padding_mask(padding_lengths(b, s), s, dtype)  # masked_row: query 7 sees no key
    mask[:, :, 7] = -1e30
    return mask


def phase_flat_kernels():
    """K3 and K3b against their plain versions; returns the rows of the
    main path's call (BERT-base's padded bf16 call, as the O2 step makes
    it)."""
    from paddle_tpu_torch.ops import flash_attention_flat as ff

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    main, failures = {}, []
    for name, b, s, h, h_kv, d, causal, dt, kind in _flat_cases():
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(dt)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # strided views, as the models pass them
        if h_kv < h:  # GQA: K/V heads repeated to h before the kernels, as flash_flat_gqa does
            kv = torch.randn((b, s, 2, h_kv, d), generator=gen, device="cuda").to(dt)
            k, v = (kv[:, :, i].repeat_interleave(h // h_kv, dim=2) for i in range(2))
        dout = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
        bias = _flat_bias(kind, b, s, dt, gen)
        before = read_launches()
        out, stats = ff.flash_flat_fwd(q, k, v, bias, causal)
        grads = ff.flash_flat_bwd(q, k, v, bias, out, stats, dout, causal)
        torch.cuda.synchronize()
        after = read_launches()
        ref = (q.float(), k.float(), v.float())
        want_out, want_stats = ff._reference_flat_fwd(*ref, bias, causal)
        want = ff._reference_flat_bwd(*ref, bias, out.float(), stats, dout.float(), causal)
        abs_err = {n: (g.float() - w).abs().max().item()
                   for n, g, w in zip(("out", "dq", "dk", "dv"), (out, *grads), (want_out, *want))}
        rel = {n: abs_err[n] / w.abs().max().item()
               for n, w in zip(("out", "dq", "dk", "dv"), (want_out, *want))}
        abs_err["log_l"] = (stats[1] - want_stats[1]).abs().max().item()
        abs_err["m"] = (stats[0] - want_stats[0]).abs().max().item()
        abs_err["m_rel"] = ((stats[0] - want_stats[0]).abs()
                            / want_stats[0].abs().clamp_min(1.0)).max().item()
        finite = bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(g).all()) for g in grads)
        del want_out, want_stats, want, ref
        # the library yardstick: scaled_dot_product_attention with the same
        # mask (causal folded into it where there is a bias), forward and
        # the backward alone
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        lib_mask = bias
        if causal and bias is not None:
            upper = torch.ones((s, s), dtype=torch.bool, device="cuda").triu(1)
            lib_mask = bias.masked_fill(upper, float("-inf"))
        lib_causal = causal and bias is None

        def lib_fwd():
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=lib_mask, is_causal=lib_causal)

        lib_out = lib_fwd()
        gh = dout.transpose(1, 2)
        big = b * h * s * s > 1e8
        timing = {
            K3["name"]: (cuda_ms(lambda: ff.flash_flat_fwd(q, k, v, bias, causal), iters=5 if big else 10),
                         cuda_ms(lambda: ff._reference_flat_fwd(q, k, v, bias, causal), iters=3, warmup=1),
                         cuda_ms(lib_fwd, iters=10),
                         flat_bound(b, s, h, d, dt, bias, causal)),
            K3B["name"]: (cuda_ms(lambda: ff.flash_flat_bwd(q, k, v, bias, out, stats, dout, causal),
                                  iters=5 if big else 10),
                          cuda_ms(lambda: ff._reference_flat_bwd(q, k, v, bias, out, stats, dout, causal),
                                  iters=3, warmup=1),
                          cuda_ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh,
                                                              retain_graph=True), iters=10),
                          flat_bound(b, s, h, d, dt, bias, causal, backward=True)),
        }
        del lib_out, qh, kh, vh
        for K, outs in ((K3, ("out",)), (K3B, ("dq", "dk", "dv"))):
            ms, plain_ms, library_ms, (bound_ms, bound_by) = timing[K["name"]]
            launched = after[K["name"]] - before[K["name"]]
            row = dict(case=name, shape=[b, s, h, d], h_kv=h_kv, causal=causal,
                       dtype=str(dt).split(".")[-1], bias=None if bias is None else list(bias.shape),
                       bias_kind=kind, max_abs_err=max(abs_err[n] for n in outs),
                       rel_err={n: rel[n] for n in outs}, rel_tol=FLAT_TOL[dt],
                       stats_err=({n: abs_err[n] for n in ("m", "m_rel", "log_l")}
                                  if K is K3 else None),
                       stats_tol=STATS_TOL if K is K3 else None,
                       ok=finite and launched == 1 and all(rel[n] <= FLAT_TOL[dt] for n in outs)
                       and (K is K3B or all(abs_err[n] <= t for n, t in STATS_TOL.items())),
                       launches=launched, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       library="torch.nn.functional.scaled_dot_product_attention"
                               + (" backward" if K is K3B else ""),
                       bound_ms=bound_ms, bound_by=bound_by)
            emit(phase="flat_kernels", kernel=K["name"], **row)
            if not row["ok"]:
                failures.append((K["name"], name, row["dtype"]))
            if name == "bert" and dt == torch.bfloat16:
                main[K["name"]] = row
        del out, stats, grads, dout, bias, qkv, q, k, v
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K3/K3b disagree with their plain versions in {failures}")
    return main


def bert_batch(b, s, vocab):
    """The padded BERT batch, as ``bench_suite.py:bench_bert`` makes its
    ids and labels (numpy generators seeded 0, 1 and 2; MLM labels on the
    first 64 tokens, the rest -100), plus explicit token types (zeros),
    positions (``arange(s)``) and the additive padding mask. Returns
    ``(inputs, labels, lengths)`` on the card."""
    ids = np.random.default_rng(0).integers(0, vocab, (b, s)).astype(np.int32)
    mlm = np.full((b, s), -100, np.int64)
    n = BERT_TRAIN["mlm_tokens"]
    mlm[:, :n] = np.random.default_rng(1).integers(0, vocab, (b, n))
    nsp = np.random.default_rng(2).integers(0, 2, (b,)).astype(np.int64)
    lengths = padding_lengths(b, s)
    cuda = lambda a: torch.from_numpy(a).to("cuda")  # noqa: E731
    inputs = (cuda(ids), torch.zeros((b, s), dtype=torch.int32, device="cuda"),
              torch.arange(s, dtype=torch.int32, device="cuda"), padding_mask(lengths, s))
    return inputs, (cuda(mlm), cuda(nsp)), lengths


def bert_loss(outs, mlm, nsp):
    """The criterion over the model's ``(mlm, nsp)`` logits, as
    ``bench_suite.py:bench_bert`` wraps it."""
    from paddle_tpu_torch.models.bert import BertPretrainingCriterion

    return BertPretrainingCriterion()(outs[0], outs[1], mlm, nsp)


def phase_bert_forward(model, inputs):
    """BERT-base's eval forward through ``sdpa``/``flash_flat_gqa`` (K3)
    against the same model forced onto ``sdpa=xla``."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry

    registry.clear_cache()
    metrics.reset_counters("kernels.")
    set_flags({"FLAGS_flash_flat": True})
    try:
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            mlm, nsp = model(*inputs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in read_launches().items()}
        picked = metrics.counters("kernels.sdpa.")
        peak = torch.cuda.max_memory_allocated()
        set_flags({"FLAGS_kernel_overrides": "sdpa=xla"})
        with torch.no_grad():
            ref_mlm, ref_nsp = model(*inputs)
    finally:
        set_flags({"FLAGS_kernel_overrides": "", "FLAGS_flash_flat": False})
        registry.clear_cache()
    torch.cuda.synchronize()
    L = len(model.bert.layers)
    atol, rtol = LOGITS_TOL
    diffs = {n: (got - want).abs() for n, got, want in (("mlm", mlm, ref_mlm), ("nsp", nsp, ref_nsp))}
    ok = (picked == {"kernels.sdpa.picked": 1, "kernels.sdpa.fallback": 0}
          and launched[K3["name"]] == L and launched[K1["name"]] == 0
          and launched[K3["name"]] == read_launches()[K3["name"]] - before[K3["name"]]  # xla: none
          and tuple(mlm.shape) == (*inputs[0].shape, model.bert.cfg.vocab_size)
          and bool(torch.isfinite(mlm).all()) and bool(torch.isfinite(nsp).all())
          and all(bool((diffs[n] <= atol + rtol * w.abs()).all())
                  for n, w in (("mlm", ref_mlm), ("nsp", ref_nsp))))
    emit(phase="bert_forward", ok=ok, ids=list(inputs[0].shape), sdpa=picked,
         launches=launched, mlm_max_abs_err_vs_xla=diffs["mlm"].max().item(),
         nsp_max_abs_err_vs_xla=diffs["nsp"].max().item(), atol=atol, rtol=rtol,
         seconds=seconds, tokens_per_s=inputs[0].numel() / seconds, max_memory_allocated=peak)
    if not ok:
        raise AssertionError("bert_forward phase failed")


def _bert_flops_per_step(cfg, lengths, seq):
    """Model flops of one BERT training step: 6 per matmul weight and token
    (each layer's qkv, out, ffn1 and ffn2 weights, the MLM transform and the
    tied MLM decoder), plus the non-causal attention matmuls over the pairs
    the padding mask leaves live (every query row, the keys before its
    row's length), forward (4 d flops per pair and head) and backward
    (twice that). The pooler and NSP head act once per sequence and are
    left out."""
    D, L, F = cfg.hidden_size, cfg.num_layers, cfg.ffn_hidden_size
    tokens = len(lengths) * seq
    n_matmul = L * (4 * D * D + 2 * D * F) + D * D + cfg.vocab_size * D
    attention = 12 * D * seq * int(np.sum(lengths)) * L
    return 6 * n_matmul * tokens + attention


def phase_bert_train():
    """BERT-base MLM + NSP pre-training at full width: AMP O2 TrainStep
    over AdamW on the padded batch, 3 warm-up and 10 timed steps
    (synchronised), then one step traced. Returns the kernel launches and
    the losses of the 13 counted steps."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW

    cfg = BertConfig()
    b, s = BERT_TRAIN["batch"], BERT_TRAIN["seq"]
    model = BertForPretraining(cfg, seed=SEED)
    step = TrainStep(model, AdamW(learning_rate=BERT_TRAIN["lr"], parameters=model.parameters()),
                     bert_loss, amp_level="O2")
    inputs, labels, lengths = bert_batch(b, s, cfg.vocab_size)
    registry.clear_cache()
    metrics.reset_counters("kernels.")
    set_flags({"FLAGS_flash_flat": True})
    try:
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(inputs, labels)["loss"]) for _ in range(BERT_TRAIN["warmup"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = [step(inputs, labels)["loss"] for _ in range(BERT_TRAIN["steps"])]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        losses += [float(x) for x in timed]
        launches = {k: v - before[k] for k, v in read_launches().items()}
        peak = torch.cuda.max_memory_allocated()
        picked = metrics.counters("kernels.sdpa.")
        breakdown = profile_step(step, inputs, labels)  # outside the counted steps
    finally:
        set_flags({"FLAGS_flash_flat": False})
        registry.clear_cache()
    n_steps = BERT_TRAIN["warmup"] + BERT_TRAIN["steps"]
    per_step = {k: v / n_steps for k, v in launches.items()}
    ms_per_step = 1e3 * seconds / BERT_TRAIN["steps"]
    flops = _bert_flops_per_step(cfg, lengths, s)
    bound_ms = 1e3 * flops / PEAK_FLOPS[torch.bfloat16]
    L = cfg.num_layers
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0]
          and picked == {"kernels.sdpa.picked": 1, "kernels.sdpa.fallback": 0}
          and per_step == {K1["name"]: 0, K2["name"]: 0, K3["name"]: L, K3B["name"]: L,
                           K4["name"]: 0, K4B["name"]: 0}
          and all(p.dtype == torch.float32 for p in model.parameters()))
    emit(phase="bert_train", ok=ok, ids=[b, s], amp_level="O2", lengths=lengths.tolist(),
         losses=losses, sdpa=picked, launches=launches, launches_per_step=per_step,
         seconds=seconds, ms_per_step=ms_per_step,
         tokens_per_s=b * s * BERT_TRAIN["steps"] / seconds,
         nonpad_tokens_per_s=int(np.sum(lengths)) * BERT_TRAIN["steps"] / seconds,
         max_memory_allocated=peak, model_flops_per_step=flops, model_flops_bound_ms=bound_ms,
         bound_share=bound_ms / ms_per_step, profile=breakdown)
    if not ok:
        raise AssertionError("bert_train phase failed")
    return launches, losses


def phase_bert_curves(kernel_losses):
    """The loss curve of ``bert_train`` (O2 through K3/K3b) against the same
    13 steps from the same weights and batch (1) in O2 through ``sdpa=xla``,
    which must agree within ``BERT_CURVE_RTOL`` at every step, and (2) in
    f32 through K3/K3b, shown beside them: the first says whether K3b's
    gradients shape the curve, the second whether the bf16 compute of O2
    does."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW

    cfg = BertConfig()
    inputs, labels, _ = bert_batch(BERT_TRAIN["batch"], BERT_TRAIN["seq"], cfg.vocab_size)
    n_steps = BERT_TRAIN["warmup"] + BERT_TRAIN["steps"]

    def curve(amp_level, overrides):
        model = BertForPretraining(cfg, seed=SEED)
        opt = AdamW(learning_rate=BERT_TRAIN["lr"], parameters=model.parameters())
        step = TrainStep(model, opt, bert_loss, amp_level=amp_level)
        registry.clear_cache()
        set_flags({"FLAGS_flash_flat": True, "FLAGS_kernel_overrides": overrides})
        try:
            return [float(step(inputs, labels)["loss"]) for _ in range(n_steps)]
        finally:
            set_flags({"FLAGS_flash_flat": False, "FLAGS_kernel_overrides": ""})
            registry.clear_cache()

    xla_o2 = curve("O2", "sdpa=xla")
    torch.cuda.empty_cache()
    kernels_f32 = curve(None, "")
    rel = [abs(a - b) / abs(b) for a, b in zip(kernel_losses, xla_o2)]
    ok = (len(kernel_losses) == n_steps and all(np.isfinite(xla_o2 + kernels_f32))
          and max(rel) <= BERT_CURVE_RTOL)
    emit(phase="bert_curves", ok=ok, losses_kernels_o2=kernel_losses, losses_xla_o2=xla_o2,
         losses_kernels_f32=kernels_f32, rel_diff_o2=rel, rtol=BERT_CURVE_RTOL)
    if not ok:
        raise AssertionError("bert_curves phase failed: the O2 curves of K3/K3b and xla differ")


def phase_bert_check():
    """One f32 step of BERT-base at batch 2 through ``flash_flat_gqa``
    (K3 + K3b) and through ``sdpa=xla``, from the same weights."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining

    cfg = BertConfig()
    model = BertForPretraining(cfg, seed=SEED + 10)
    inputs, labels, _ = bert_batch(BERT_TRAIN["check_batch"], BERT_TRAIN["seq"], cfg.vocab_size)
    check_step_against_xla("bert_check", model, inputs, labels, bert_loss, "sdpa=xla", K3B,
                           cfg.num_layers, flat=True)


def phase_gpt3_train():
    """The GPT-3 1.3B step of ``bench_1p3b.py:_tpu_run(False)`` at full
    width and depth: selective recompute, 2 accumulated micro-batches, AMP
    O2 over AdamW, 2 warm-up and 6 timed steps (synchronised) on one ids
    batch with labels = ids, then one step traced. K1 runs twice per layer
    and micro-batch (the forward and its recompute: no policy saves a
    kernel's output), K2 once. Then the same step with ``"full"`` recompute
    and with none, timed beside it. Returns the kernel launches of the 8
    counted steps."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig.gpt3_1p3b(recompute=True, recompute_granularity="selective")
    b, s, k = GPT3_TRAIN["batch"], GPT3_TRAIN["seq"], GPT3_TRAIN["accumulate"]
    model = GPTForPretraining(cfg, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    step = TrainStep(model, AdamW(learning_rate=GPT3_TRAIN["lr"], parameters=model.parameters()),
                     GPTPretrainingCriterion(), amp_level="O2", accumulate_steps=k)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s))
                           .astype(np.int32)).to("cuda")
    registry.clear_cache()
    metrics.reset_counters("kernels.")
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(ids, ids)["loss"]) for _ in range(GPT3_TRAIN["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(ids, ids)["loss"] for _ in range(GPT3_TRAIN["steps"])]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses += [float(x) for x in timed]
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    picked = metrics.counters("kernels.attention_core.")
    breakdown = profile_step(step, ids, ids)  # outside the counted steps
    n_steps = GPT3_TRAIN["warmup"] + GPT3_TRAIN["steps"]
    per_step = {name: v / n_steps for name, v in launches.items()}
    L = cfg.num_layers
    want = {K1["name"]: 2 * L * k, K2["name"]: L * k, K3["name"]: 0, K3B["name"]: 0,
            K4["name"]: 0, K4B["name"]: 0}
    ms_per_step = 1e3 * seconds / GPT3_TRAIN["steps"]
    # what the recompute costs: the same step (the model as trained so far)
    # with "full" recompute and without any, 1 warm-up and 3 timed steps each
    variants = {}
    for granularity in ("full", None):
        cfg.recompute, cfg.recompute_granularity = granularity is not None, granularity or "full"
        torch.cuda.reset_peak_memory_stats()
        step(ids, ids)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(3):
            step(ids, ids)
        torch.cuda.synchronize()
        variants[str(granularity)] = dict(ms_per_step=1e3 * (time.perf_counter() - t1) / 3,
                                          max_memory_allocated=torch.cuda.max_memory_allocated())
    cfg.recompute, cfg.recompute_granularity = True, "selective"
    flops = _model_flops_per_step(cfg, b, s)
    bound_ms = 1e3 * flops / PEAK_FLOPS[torch.bfloat16]
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0]
          and picked == {"kernels.attention_core.picked": 1, "kernels.attention_core.fallback": 0}
          and per_step == want and all(p.dtype == torch.float32 for p in model.parameters()))
    emit(phase="gpt3_1p3b_train", ok=ok, ids=[b, s], params=n_params, amp_level="O2",
         recompute="selective", accumulate_steps=k, losses=losses, attention_core=picked,
         launches=launches, launches_per_step=per_step, expected_per_step=want, seconds=seconds,
         ms_per_step=ms_per_step, tokens_per_s=b * s * GPT3_TRAIN["steps"] / seconds,
         max_memory_allocated=peak, model_flops_per_step=flops, model_flops_bound_ms=bound_ms,
         bound_share=bound_ms / ms_per_step, profile=breakdown,
         device_busy_share_of_timed_step=breakdown and breakdown["device_busy_ms"] / ms_per_step,
         recompute_variants=variants)
    if not ok:
        raise AssertionError("gpt3_1p3b_train phase failed")
    return launches


def _f32_step(model, inputs, labels, loss_fn, accumulate_steps=1):
    """One f32 AdamW step: ``(loss, gradients, launches by kernel)``."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    step = TrainStep(model, AdamW(learning_rate=TRAIN["lr"], parameters=model.parameters()),
                     loss_fn, accumulate_steps=accumulate_steps)
    before = read_launches()
    loss = float(step(inputs, labels)["loss"])
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss, grads, {n: v - before[n] for n, v in read_launches().items()}


def _agree(loss, grads, ref_loss, ref_grads):
    """``TRAIN_CHECK_TOL`` on one step against a reference step: ``(ok,
    worst gradient's name, its relative L2)``."""
    rel = _grad_rel_l2(grads, ref_grads)
    worst = max(rel, key=rel.get)
    ok = (set(grads) == set(ref_grads)
          and abs(loss - ref_loss) <= TRAIN_CHECK_TOL["loss_rtol"] * abs(ref_loss)
          and rel[worst] <= TRAIN_CHECK_TOL["grad_rel_l2_max"])
    return ok, worst, rel[worst]


def phase_recompute_check():
    """One f32 step from the same weights with recompute off, ``"full"``
    and ``"selective"``: the 1.3B at full width (h 2048, 16 heads, d 128,
    s 2048) cut to 2 layers at batch 2, and the GPT-MoE of ``moe_train``
    cut to 2 layers with GShard jitter on, its routing generators seeded
    alike in each run (the recompute must replay the jitter the forward
    drew). The losses and every gradient agree with the run without
    recompute (``TRAIN_CHECK_TOL``); under recompute K1 (and K4) run twice
    per layer, the forward and its recompute, and K2 (and K4b) once."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    cases = {"gpt3_1p3b": (GPTConfig.gpt3_1p3b(num_layers=CHECK_LAYERS).to_dict(),
                           GPT3_TRAIN["seq"]),
             "gpt_moe": (GPTConfig(**dict(MOE_CFG, num_layers=CHECK_LAYERS)).to_dict(),
                         MOE_TRAIN["seq"])}
    results, ok = {}, True
    for case, (cfg_kw, s) in cases.items():
        ids = torch.randint(0, cfg_kw["vocab_size"], (TRAIN["check_batch"], s), device="cuda",
                            generator=gen)
        runs = {}
        for granularity in (None, "full", "selective"):
            cfg = GPTConfig(**dict(cfg_kw, recompute=granularity is not None,
                                   recompute_granularity=granularity or "full"))
            model = GPTForPretraining(cfg, seed=SEED + 12)
            runs[granularity] = _f32_step(model, (ids,), (ids,), GPTPretrainingCriterion())
            del model
            torch.cuda.empty_cache()
        L = CHECK_LAYERS
        n_moe = L // cfg_kw["moe_every"] if cfg_kw["moe_num_experts"] else 0
        ref_loss, ref_grads, _ = runs[None]
        row = {}
        for granularity, (loss, grads, launched) in runs.items():
            times = 1 if granularity is None else 2
            want = {K1["name"]: times * L, K2["name"]: L, K3["name"]: 0, K3B["name"]: 0,
                    K4["name"]: times * n_moe, K4B["name"]: n_moe}
            agree, worst, worst_rel = _agree(loss, grads, ref_loss, ref_grads)
            row[str(granularity)] = dict(loss=loss, grad_rel_l2_worst=worst_rel, worst=worst,
                                         launches=launched, expected_launches=want,
                                         ok=agree and launched == want)
            ok = ok and row[str(granularity)]["ok"]
        results[case] = dict(ids=[TRAIN["check_batch"], s], layers=L, runs=row)
    emit(phase="recompute_check", ok=ok, **results, **TRAIN_CHECK_TOL)
    if not ok:
        raise AssertionError("recompute_check phase failed: recompute changes the step")


def phase_accum_check():
    """One f32 step of the 1.3B at full width cut to 2 layers on ids
    ``[4, 2048]`` with ``accumulate_steps=2`` against the same batch in one
    piece, from the same weights: a token mean over equal token counts, so
    the losses and every gradient agree (``TRAIN_CHECK_TOL``)."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion

    cfg = GPTConfig.gpt3_1p3b(num_layers=CHECK_LAYERS)
    b, s = GPT3_TRAIN["batch"], GPT3_TRAIN["seq"]
    ids = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 13))
    runs = {}
    for k in (1, GPT3_TRAIN["accumulate"]):
        model = GPTForPretraining(cfg, seed=SEED + 14)
        runs[k] = _f32_step(model, (ids,), (ids,), GPTPretrainingCriterion(), accumulate_steps=k)
        del model
        torch.cuda.empty_cache()
    k = GPT3_TRAIN["accumulate"]
    (loss_1, grads_1, n_1), (loss_k, grads_k, n_k) = runs[1], runs[k]
    agree, worst, worst_rel = _agree(loss_k, grads_k, loss_1, grads_1)
    L = cfg.num_layers
    ok = (agree and n_1[K1["name"]] == n_1[K2["name"]] == L
          and n_k[K1["name"]] == n_k[K2["name"]] == k * L)
    emit(phase="accum_check", ok=ok, ids=[b, s], layers=L, accumulate_steps=k,
         loss_one_piece=loss_1, loss_accumulated=loss_k, grad_rel_l2_worst=worst_rel, worst=worst,
         launches_one_piece=n_1, launches_accumulated=n_k, **TRAIN_CHECK_TOL)
    if not ok:
        raise AssertionError("accum_check phase failed: accumulated and one-piece steps disagree")


def ernie_batch(b, s, vocab):
    """ERNIE's batch as ``bench_1p3b.py:_tpu_run(True)`` makes it (one numpy
    generator seeded 0): ids, the MLM labels (the ids, with every second
    position -100) and random SOP labels. Returns ``(inputs, labels)`` on
    the card."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mlm = ids.astype(np.int64)
    mlm[:, ::2] = -100
    sop = rng.integers(0, 2, (b,)).astype(np.int64)
    cuda = lambda a: torch.from_numpy(a).to("cuda")  # noqa: E731
    return (cuda(ids),), (cuda(mlm), cuda(sop))


def ernie_loss(outs, mlm, sop):
    """The criterion over the model's ``(mlm, sop)`` logits, as
    ``bench_1p3b.py`` wraps it."""
    from paddle_tpu_torch.models.ernie import ErniePretrainingCriterion

    return ErniePretrainingCriterion()(outs[0], outs[1], mlm, sop)


def phase_ernie_train():
    """The ERNIE 3.0 xbase step of ``bench_1p3b.py:_tpu_run(True)`` at full
    width and depth: MLM + SOP, no attention mask (``sdpa`` picks ``flash``:
    K1 and K2 once per layer, no K3), AMP O2 over AdamW, 2 warm-up and 8
    timed steps (synchronised), then one step traced; the losses finite.
    Returns the kernel launches of the 10 counted steps."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW

    cfg = ErnieConfig.ernie3_xbase(vocab_size=ERNIE_TRAIN["vocab"])
    b, s = ERNIE_TRAIN["batch"], ERNIE_TRAIN["seq"]
    model = ErnieForPretraining(cfg, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    step = TrainStep(model, AdamW(learning_rate=ERNIE_TRAIN["lr"], parameters=model.parameters()),
                     ernie_loss, amp_level="O2")
    inputs, labels = ernie_batch(b, s, cfg.vocab_size)
    registry.clear_cache()
    metrics.reset_counters("kernels.")
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(inputs, labels)["loss"]) for _ in range(ERNIE_TRAIN["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(inputs, labels)["loss"] for _ in range(ERNIE_TRAIN["steps"])]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses += [float(x) for x in timed]
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    picked = metrics.counters("kernels.sdpa.")
    breakdown = profile_step(step, inputs, labels)  # outside the counted steps
    n_steps = ERNIE_TRAIN["warmup"] + ERNIE_TRAIN["steps"]
    per_step = {name: v / n_steps for name, v in launches.items()}
    L = cfg.num_layers
    want = {K1["name"]: L, K2["name"]: L, K3["name"]: 0, K3B["name"]: 0, K4["name"]: 0,
            K4B["name"]: 0}
    ms_per_step = 1e3 * seconds / ERNIE_TRAIN["steps"]
    flops = _bert_flops_per_step(cfg, np.full(b, s), s)  # no mask: every pair is live
    bound_ms = 1e3 * flops / PEAK_FLOPS[torch.bfloat16]
    # the losses must be finite, not falling: at lr 1e-4 with no warm-up this
    # wide post-LN encoder's first steps spike (PERF.md, section 7); ernie_check
    # holds the step against the plain path
    ok = (all(np.isfinite(losses))
          and picked == {"kernels.sdpa.picked": 1, "kernels.sdpa.fallback": 0}
          and per_step == want and all(p.dtype == torch.float32 for p in model.parameters()))
    emit(phase="ernie_train", ok=ok, ids=[b, s], params=n_params, amp_level="O2", losses=losses,
         sdpa=picked, launches=launches, launches_per_step=per_step, expected_per_step=want,
         seconds=seconds, ms_per_step=ms_per_step,
         tokens_per_s=b * s * ERNIE_TRAIN["steps"] / seconds, max_memory_allocated=peak,
         model_flops_per_step=flops, model_flops_bound_ms=bound_ms,
         bound_share=bound_ms / ms_per_step, profile=breakdown,
         device_busy_share_of_timed_step=breakdown and breakdown["device_busy_ms"] / ms_per_step)
    if not ok:
        raise AssertionError("ernie_train phase failed")
    return launches


def phase_ernie_check():
    """One f32 step of ERNIE 3.0 xbase at full width cut to 2 layers, batch
    2, through ``sdpa``/``flash`` (K1 + K2, non-causal at d = 128) and
    through ``sdpa=xla``, from the same weights."""
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining

    cfg = ErnieConfig.ernie3_xbase(vocab_size=ERNIE_TRAIN["vocab"], num_layers=CHECK_LAYERS)
    model = ErnieForPretraining(cfg, seed=SEED + 15)
    inputs, labels = ernie_batch(ERNIE_TRAIN["check_batch"], ERNIE_TRAIN["seq"], cfg.vocab_size)
    check_step_against_xla("ernie_check", model, inputs, labels, ernie_loss, "sdpa=xla", K2,
                           cfg.num_layers)


def _resnet_macs(model, size):
    """Multiply-adds of one image's forward through ``model``'s convolutions
    and ``Linear`` head, from their shapes (one eval forward at batch 1 with
    hooks): ``(all, the stem's)``. A convolution's are its output's elements
    times ``in / groups * kh * kw``."""
    from paddle_tpu_torch.nn.layer import Conv2D, Linear

    macs = {}

    def count(module, args, out):
        if isinstance(module, Conv2D):
            macs[module] = out[0].numel() * math.prod(module.weight.shape[1:])
        else:
            macs[module] = module.in_features * module.out_features

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv2D, Linear))]
    was_training = model.training
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(1, 3, size, size, device="cuda"))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return sum(macs.values()), macs[model.conv1]


def _resnet_flops_per_step(model, batch, size):
    """Model flops of one training step: 2 per multiply-add forward and 4
    backward (input and weight gradients), without the stem's input
    gradient, which nothing needs."""
    macs, stem = _resnet_macs(model, size)
    return (6 * macs - 2 * stem) * batch


def _batch_norm_buffers(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("_mean", "_variance"))}


def phase_resnet50_train():
    """``bench_suite.py:bench_resnet50`` through the port, uncut: AMP O2
    ``TrainStep`` over Momentum, 3 warm-up and 20 timed steps (synchronised)
    on one batch, then one step traced and the step with
    ``torch.backends.cudnn.benchmark`` on, 2 warm-up and 5 timed. The
    losses must be finite and the batch norms' running buffers finite and
    moved; whether the losses fall is reported. Returns the K1-K4b launches
    of the 23 counted steps (none)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.layer import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    b, size = RESNET_TRAIN["batch"], RESNET_TRAIN["size"]
    model = resnet50(num_classes=RESNET_TRAIN["classes"], seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    step = TrainStep(model, Momentum(learning_rate=RESNET_TRAIN["lr"], parameters=model.parameters()),
                     CrossEntropyLoss(), amp_level="O2")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(b, 3, size, size))
                         .astype(np.float32)).to("cuda")
    y = torch.from_numpy(np.random.default_rng(1).integers(0, RESNET_TRAIN["classes"], (b,))
                         .astype(np.int64)).to("cuda")
    flops = _resnet_flops_per_step(model, b, size)
    start = _batch_norm_buffers(model)
    cudnn_benchmark = torch.backends.cudnn.benchmark
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(x, y)["loss"]) for _ in range(RESNET_TRAIN["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(x, y)["loss"] for _ in range(RESNET_TRAIN["steps"])]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses += [float(v) for v in timed]
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    after = _batch_norm_buffers(model)
    breakdown = profile_step(step, x, y)  # outside the counted steps
    ms_per_step = 1e3 * seconds / RESNET_TRAIN["steps"]
    # the same step with cuDNN's autotuner on (off above, as by default)
    torch.backends.cudnn.benchmark = True
    try:
        for _ in range(2):
            step(x, y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            step(x, y)
        torch.cuda.synchronize()
        benchmark_ms = 1e3 * (time.perf_counter() - t1) / 5
    finally:
        torch.backends.cudnn.benchmark = cudnn_benchmark
    bound_ms = 1e3 * flops / PEAK_FLOPS[torch.bfloat16]
    buffers_ok = all(torch.isfinite(v).all() and not torch.equal(v, start[n])
                     for n, v in after.items())
    ok = (all(np.isfinite(losses)) and buffers_ok and len(after) == 106
          and all(v == 0 for v in launches.values())
          and all(p.dtype == torch.float32 for p in model.parameters())
          and all(v.dtype == torch.float32 for v in after.values()))
    emit(phase="resnet50_train", ok=ok, images=[b, 3, size, size], params=n_params, amp_level="O2",
         layout="NCHW", cudnn_benchmark=cudnn_benchmark, losses=losses,
         losses_fell=losses[-1] < losses[0], batch_norm_buffers=len(after),
         buffers_finite_and_moved=bool(buffers_ok), launches=launches, seconds=seconds,
         ms_per_step=ms_per_step, images_per_s=b * RESNET_TRAIN["steps"] / seconds,
         max_memory_allocated=peak, model_flops_per_step=flops, model_flops_bound_ms=bound_ms,
         bound_share=bound_ms / ms_per_step, profile=breakdown,
         device_busy_share_of_timed_step=breakdown and breakdown["device_busy_ms"] / ms_per_step,
         cudnn_benchmark_on_ms_per_step=benchmark_ms)
    if not ok:
        raise AssertionError("resnet50_train phase failed")
    return launches


def _resnet_step_on(device, dtype, state, x, y):
    """One Momentum step of ResNet50 from ``state`` on ``device`` in
    ``dtype``: ``(loss, gradients, running buffers after, eval logits)``,
    the eval forward on the step's running buffers with the weights from
    before the step (after the step, a gradient's f32 noise would move
    every later weight). float64 takes a float64 cross entropy: the port's
    fused one computes in f32."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.layer import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(num_classes=RESNET_TRAIN["classes"], device=device)
    model.load_state_dict(state)
    model.to(dtype)
    loss_fn = CrossEntropyLoss() if dtype == torch.float32 else torch.nn.functional.cross_entropy
    step = TrainStep(model, Momentum(learning_rate=RESNET_CHECK["lr"], parameters=model.parameters()),
                     loss_fn)
    xs, ys = x.to(device, dtype), y.to(device)
    loss = float(step(xs, ys)["loss"])
    grads = {n: p.grad.detach().to("cpu", torch.float64) for n, p in model.named_parameters()}
    buffers = {n: v.to("cpu", torch.float64) for n, v in _batch_norm_buffers(model).items()}
    model.load_state_dict({**{n: v for n, v in state.items() if n not in buffers}, **buffers})
    with torch.no_grad():
        logits = model.eval()(xs).to("cpu", torch.float64)
    return loss, grads, buffers, logits


def phase_resnet_check():
    """ResNet50's step on the card against the same step on the CPU, from
    the same weights (seed 20) and inputs (``[8, 3, 64, 64]``, seed 21), in
    f32 with TF32 off and in float64: the loss, each gradient's relative
    L2 distance, the running buffers after the step and the eval logits on
    them (``RESNET_CHECK_TOL``)."""
    from paddle_tpu_torch.vision.models import resnet50

    b, size = RESNET_CHECK["batch"], RESNET_CHECK["size"]
    state = {n: v.cpu() for n, v in resnet50(num_classes=RESNET_TRAIN["classes"], device="cpu",
                                               seed=SEED + 20).state_dict().items()}
    rng = np.random.default_rng(SEED + 21)
    x = torch.from_numpy(rng.normal(size=(b, 3, size, size)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, RESNET_TRAIN["classes"], (b,)).astype(np.int64))
    results, ok = {}, True
    for dtype in (torch.float32, torch.float64):
        tol = RESNET_CHECK_TOL[dtype]
        loss_c, grads_c, buf_c, logits_c = _resnet_step_on("cuda", dtype, state, x, y)
        loss_h, grads_h, buf_h, logits_h = _resnet_step_on("cpu", dtype, state, x, y)
        rel = _grad_rel_l2(grads_c, grads_h)
        worst = max(rel, key=rel.get)
        buf_err = max(float((buf_c[n] - buf_h[n]).abs().max()) for n in buf_h)
        eval_rel = float((logits_c - logits_h).norm() / logits_h.norm())
        loss_rel = abs(loss_c - loss_h) / abs(loss_h)
        agree = (loss_rel <= tol["loss_rtol"] and rel[worst] <= tol["grad_rel_l2_max"]
                 and buf_err <= tol["buffers_atol"] and eval_rel <= tol["eval_rel_l2_max"]
                 and math.isfinite(loss_c))
        ok = ok and agree
        results[str(dtype).replace("torch.", "")] = dict(
            ok=agree, loss_card=loss_c, loss_cpu=loss_h, loss_rel=loss_rel,
            grad_rel_l2_worst=rel[worst], worst=worst,
            grad_rel_l2_median=float(np.median(list(rel.values()))),
            grad_rel_l2_fc_weight=rel["fc.weight"], buffers_max_abs_err=buf_err,
            eval_logits_rel_l2=eval_rel, **tol)
    emit(phase="resnet_check", ok=ok, images=[b, 3, size, size],
         tf32=torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32, **results)
    if not ok:
        raise AssertionError("resnet_check phase failed: the card's step and the CPU's disagree")


def phase_lenet_train():
    """``bench_suite.py:bench_mnist`` through the port: LeNet, Momentum
    (lr 0.01), ``CrossEntropyLoss``, one ``[64, 1, 28, 28]`` batch; the
    eager loop (``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``),
    3 warm-up and 20 timed steps, then ``TrainStep``, 3 warm-up and 200
    timed; steps/s of each, the losses finite and falling. Returns the
    K1-K4b launches (none)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.lenet import LeNet
    from paddle_tpu_torch.nn.layer import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum

    b = LENET_TRAIN["batch"]
    model = LeNet(seed=SEED)
    opt = Momentum(learning_rate=LENET_TRAIN["lr"], parameters=model.parameters())
    loss_fn = CrossEntropyLoss()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(b, 1, 28, 28))
                         .astype(np.float32)).to("cuda")
    y = torch.from_numpy(np.random.default_rng(1).integers(0, 10, (b,)).astype(np.int64)).to("cuda")

    def eager_step():
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    def timed(fn, warmup, steps):
        losses = [float(fn()) for _ in range(warmup)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [fn() for _ in range(steps)]
        torch.cuda.synchronize()
        return steps / (time.perf_counter() - t0), losses + [float(v) for v in out]

    reset_launches()
    eager_sps, eager_losses = timed(eager_step, LENET_TRAIN["warmup"], LENET_TRAIN["eager_steps"])
    step = TrainStep(model, opt, loss_fn)
    step_sps, step_losses = timed(lambda: step(x, y)["loss"], LENET_TRAIN["warmup"],
                                  LENET_TRAIN["steps"])
    launches = read_launches()
    ok = (all(np.isfinite(eager_losses + step_losses)) and eager_losses[-1] < eager_losses[0]
          and step_losses[-1] < step_losses[0] and all(v == 0 for v in launches.values()))
    emit(phase="lenet_train", ok=ok, images=[b, 1, 28, 28], eager_steps_per_s=eager_sps,
         train_step_steps_per_s=step_sps, eager_losses=eager_losses,
         train_step_losses=step_losses[::20] + step_losses[-1:], launches=launches)
    if not ok:
        raise AssertionError("lenet_train phase failed")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    k1_row, k1_bf16_row, k1_d128 = phase_k1()
    k2_row, k2_d128 = phase_k2()
    rows = {K1["name"]: k1_row, K2["name"]: k2_row, **phase_flat_kernels()}
    # the bf16 calls of the O2 steps, beside K1's f32 main row (the forward's
    # call); K3's main row is already BERT's O2 call
    bf16_rows = {K1["name"]: k1_bf16_row, K3["name"]: rows[K3["name"]]}
    # K1's and K2's d = 128 calls of the 1.3B and ERNIE steps
    d128_rows = {K1["name"]: k1_d128, K2["name"]: k2_d128}

    model = GPTForPretraining(GPTConfig(**SERVE_CFG), seed=SEED).eval()
    ids = torch.randint(0, SERVE_CFG["vocab_size"], (8, 1024), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
    with torch.no_grad():  # warm-up: cuBLAS handles and the kernel's library
        model(ids)
    # the main path: each of its runs counts launches from 0
    by_path = {}
    for path, run in (("forward", lambda: phase_forward(model, ids)),
                      ("serve", lambda: phase_serve(model))):
        reset_launches()
        run()
        by_path[path] = read_launches()
    del model
    torch.cuda.empty_cache()
    by_path["train"] = phase_train()
    torch.cuda.empty_cache()
    phase_train_check()
    torch.cuda.empty_cache()
    by_path["moe_train"], step_rows = phase_moe_train()
    torch.cuda.empty_cache()
    rows.update(phase_moe_kernels(step_rows))
    torch.cuda.empty_cache()
    phase_moe_check()
    torch.cuda.empty_cache()

    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining

    bert = BertForPretraining(BertConfig(), seed=SEED).eval()
    bert_inputs, _, _ = bert_batch(BERT_TRAIN["batch"], BERT_TRAIN["seq"], bert.bert.cfg.vocab_size)
    reset_launches()
    phase_bert_forward(bert, bert_inputs)
    by_path["bert_forward"] = read_launches()
    del bert, bert_inputs
    torch.cuda.empty_cache()
    reset_launches()
    by_path["bert_train"], bert_losses = phase_bert_train()
    torch.cuda.empty_cache()
    phase_bert_curves(bert_losses)
    torch.cuda.empty_cache()
    phase_bert_check()
    torch.cuda.empty_cache()
    reset_launches()
    phase_flat_check()
    by_path["flat_check"] = read_launches()
    torch.cuda.empty_cache()
    by_path["gpt3_1p3b_train"] = phase_gpt3_train()
    torch.cuda.empty_cache()
    phase_recompute_check()
    torch.cuda.empty_cache()
    phase_accum_check()
    torch.cuda.empty_cache()
    by_path["ernie_train"] = phase_ernie_train()
    torch.cuda.empty_cache()
    phase_ernie_check()
    torch.cuda.empty_cache()
    by_path["resnet50_train"] = phase_resnet50_train()
    torch.cuda.empty_cache()
    phase_resnet_check()
    torch.cuda.empty_cache()
    by_path["lenet_train"] = phase_lenet_train()

    keys = ("shape", "causal", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # K4/K4b's main call computes the live rows only: its bound counts them
    for K in (K4, K4B):
        row = rows[K["name"]]
        rows[K["name"]] = dict(row, bound_ms=row["bound_live_ms"], bound_by=row["bound_live_by"])
    kernels = [dict(K, launches=sum(p[K["name"]] for p in by_path.values()),
                    launches_by_path={path: p[K["name"]] for path, p in by_path.items()},
                    **{k: rows[K["name"]][k] for k in keys if k in rows[K["name"]]},
                    **({"bf16_row": {k: bf16_rows[K["name"]][k] for k in keys + ("packed_qkv",)
                                     if k in bf16_rows[K["name"]]}}
                       if K["name"] in bf16_rows else {}),
                    **({"d128_rows": {path: {k: row[k] for k in keys + ("packed_qkv",) if k in row}
                                      for path, row in d128_rows[K["name"]].items()}}
                       if K["name"] in d128_rows else {}))
               for K in KERNELS]
    emit(kernels=kernels, wall_s=time.perf_counter() - t_start)
    # K1 runs in the forward and in training, K2 in training, K4 and K4b in
    # the GPT-MoE step (with K1 and K2), K3 in BERT's forward, K3 and K3b in
    # BERT's step and in GPT's step with FLAGS_flash_flat on, K1 and K2 in
    # the 1.3B and ERNIE steps; the vision steps none (their phases check
    # that every count stays 0)
    expected = {"forward": [K1["name"]], "train": [K1["name"], K2["name"]],
                "moe_train": [K["name"] for K in (K1, K2, K4, K4B)],
                "bert_forward": [K3["name"]], "bert_train": [K3["name"], K3B["name"]],
                "flat_check": [K3["name"], K3B["name"]],
                "gpt3_1p3b_train": [K1["name"], K2["name"]],
                "ernie_train": [K1["name"], K2["name"]],
                "resnet50_train": [], "lenet_train": []}
    missing = [(path, n) for path, names in expected.items() for n in names if by_path[path][n] == 0]
    if missing:
        raise AssertionError(f"the main path launched these kernels no time: {missing}")
    emit(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # a failed phase: report it, exit non-zero, print no result
        print(json.dumps({"failed": type(exc).__name__, "error": str(exc)[:2000]}), flush=True)
        raise

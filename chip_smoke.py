"""Smoke run of the PyTorch + CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; it builds the kernels from the sources in this
checkout into ``build/paddle_tpu_torch/``. Without a CUDA device it exits
non-zero and prints no result. Phases, one JSON line each:

1. ``device``: the card's name, the device count, and ``nvidia-smi``'s name
   and power limit.
2. ``build``: every kernel of the path built from source, all ``nvcc``
   processes started together.
3. ``kernels``: kernels K1 (flash-attention forward) and K2 (its backward)
   against their plain PyTorch versions at the main path's shapes, f32 and
   bf16, causal and not, d = 64 and 128, a ragged s, and (K2) packed-qkv
   strides; with times of the kernel, the plain version and the one PyTorch
   call that computes the same function
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

Phases 4, 5 and 6 are the main path: the kernel counts are set to 0 just
before each of them and read just after it. Then one JSON line lists every
kernel with its launches in those runs, and the last line is the
``{"ok": true, ...}`` result.
"""
from __future__ import annotations

import json
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


def phase_build():
    from paddle_tpu_torch.ops import _cuda

    names = [K1["name"], K2["name"]]
    seconds = _cuda.build(names)
    ptxas = {n: [ln.strip() for ln in _cuda.library_path(n).with_name(
        _cuda.library_path(n).name + ".log").read_text().splitlines()
        if "registers" in ln or ("spill" in ln and not ln.strip().startswith("0 bytes stack"))]
        for n in names}
    emit(phase="build", seconds=seconds, ptxas=ptxas)


def phase_k1():
    """K1 against its plain version; returns the row of the main path's
    shape ([8, 1024, 16, 64] causal f32, as the forward calls it)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    cases = [(8, 1024, 16, 64, causal, dt) for causal in (True, False)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 1024, 16, 128, True, dt) for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 1000, 16, 64, True, dt) for dt in (torch.float32, torch.bfloat16)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main_row, failures = None, []
    for b, s, h, d, causal, dt in cases:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt) for _ in range(3))
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
                   max_abs_err=err, lse_max_abs_err=lse_err, atol=atol, rtol=rtol, ok=ok,
                   launches=launched, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        emit(phase="kernels", kernel=K1["name"], **row)
        if not ok:
            failures.append(row)
        if (b, s, h, d, causal, dt) == (8, 1024, 16, 64, True, torch.float32):
            main_row = row
    if failures:
        raise AssertionError(f"K1 disagrees with its plain version in {len(failures)} case(s)")
    return main_row


def _k2_cases():
    cases = [(8, 1024, 16, 64, causal, dt, False) for causal in (True, False)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 1024, 16, 128, True, dt, False) for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 1000, 16, 64, True, dt, False) for dt in (torch.float32, torch.bfloat16)]
    # views of one packed [b, s, 3, h, d] projection and gradient, as the
    # training step's attention_core/flash calls K2
    cases += [(8, 1024, 16, 64, True, dt, True) for dt in (torch.float32, torch.bfloat16)]
    return cases


def phase_k2():
    """K2 against its plain version; returns the row of the main path's
    call ([8, 1024, 16, 64] causal bf16 through packed-qkv strides, as the
    O2 training step makes it)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    main_row, failures = None, []
    for b, s, h, d, causal, dt, packed in _k2_cases():
        if packed:
            qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(dt)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
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
              and (not packed or all(g.data_ptr() == t.data_ptr() for g, t in zip(got, grads))))
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
                   packed_qkv=packed, max_abs_err=max(errs), dq_dk_dv_max_abs_err=errs, atol=atol,
                   rtol=rtol, ok=ok, launches=launched, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit(phase="kernels", kernel=K2["name"], **row)
        if not ok:
            failures.append(row)
        if (b, s, h, d, causal, dt, packed) == (8, 1024, 16, 64, True, torch.bfloat16, True):
            main_row = row
    if failures:
        raise AssertionError(f"K2 disagrees with its plain version in {len(failures)} case(s)")
    return main_row


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
    if "flash_fwd_kernel" in name:
        return "K1 flash_attention_fwd"
    if "bwd_dq_kernel" in name or "bwd_dkv_kernel" in name or "bwd_di_kernel" in name:
        return "K2 flash_attention_bwd"
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
    from paddle_tpu_torch.ops import flash_attention as fa
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
    fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(ids, ids)["loss"]) for _ in range(TRAIN["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(ids, ids)["loss"] for _ in range(TRAIN["steps"])]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses += [float(x) for x in timed]
    launches = {K1["name"]: fa.flash_attention_fwd.launches,
                K2["name"]: fa.flash_attention_bwd.launches}
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
          and per_step == {K1["name"]: cfg.num_layers, K2["name"]: cfg.num_layers}
          and all(p.dtype == torch.float32 for p in model.parameters()))
    emit(phase="train", ok=ok, ids=[b, s], amp_level="O2", losses=losses, attention_core=picked,
         launches=launches, launches_per_step=per_step, seconds=seconds, ms_per_step=ms_per_step,
         tokens_per_s=b * s * TRAIN["steps"] / seconds,
         max_memory_allocated=peak, model_flops_per_step=_model_flops_per_step(cfg, b, s),
         model_flops_bound_ms=bound_ms, bound_share=bound_ms / ms_per_step, profile=breakdown)
    if not ok:
        raise AssertionError("train phase failed")
    return launches


def phase_train_check():
    """One f32 step (no AMP) of the full-width model at batch 2, through
    ``attention_core``/``flash`` (K1 + K2) and through the plain ``xla``
    impl, from the same weights: the losses and every gradient agree."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(**SERVE_CFG)
    model = GPTForPretraining(cfg, seed=SEED + 3)
    start = {n: t.clone() for n, t in model.state_dict().items()}
    ids = torch.randint(0, cfg.vocab_size, (TRAIN["check_batch"], TRAIN["seq"]), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 4))

    def one_step(overrides):
        model.load_state_dict(start)
        registry.clear_cache()
        set_flags({"FLAGS_kernel_overrides": overrides})
        try:
            before = fa.flash_attention_bwd.launches
            step = TrainStep(model, AdamW(learning_rate=TRAIN["lr"], parameters=model.parameters()),
                             GPTPretrainingCriterion())
            loss = float(step(ids, ids)["loss"])
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            return loss, grads, fa.flash_attention_bwd.launches - before
        finally:
            set_flags({"FLAGS_kernel_overrides": ""})

    loss_flash, g_flash, k2_flash = one_step("")
    loss_xla, g_xla, k2_xla = one_step("attention_core=xla")
    rel = {n: (float((g_flash[n] - g_xla[n]).norm() / g_xla[n].norm()) if g_xla[n].norm() > 0
               else float(g_flash[n].norm())) for n in g_xla}
    worst = max(rel, key=rel.get)
    ok = (k2_flash == cfg.num_layers and k2_xla == 0
          and abs(loss_flash - loss_xla) <= TRAIN_CHECK_TOL["loss_rtol"] * abs(loss_xla)
          and rel[worst] <= TRAIN_CHECK_TOL["grad_rel_l2_max"])
    emit(phase="train_check", ok=ok, ids=list(ids.shape), loss_flash=loss_flash, loss_xla=loss_xla,
         grad_rel_l2=rel, worst=worst, **TRAIN_CHECK_TOL, k2_launches=k2_flash)
    if not ok:
        raise AssertionError("train_check phase failed: flash and xla steps disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    phase_build()
    rows = {K1["name"]: phase_k1(), K2["name"]: phase_k2()}

    model = GPTForPretraining(GPTConfig(**SERVE_CFG), seed=SEED).eval()
    ids = torch.randint(0, SERVE_CFG["vocab_size"], (8, 1024), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
    with torch.no_grad():  # warm-up: cuBLAS handles and the kernel's library
        model(ids)
    # the main path: each of its runs counts launches from 0
    by_path = {}
    for path, run in (("forward", lambda: phase_forward(model, ids)),
                      ("serve", lambda: phase_serve(model))):
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        run()
        by_path[path] = {K1["name"]: fa.flash_attention_fwd.launches,
                         K2["name"]: fa.flash_attention_bwd.launches}
    del model
    torch.cuda.empty_cache()
    by_path["train"] = phase_train()
    torch.cuda.empty_cache()
    phase_train_check()

    keys = ("shape", "causal", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [dict(K, launches=sum(p[K["name"]] for p in by_path.values()),
                    launches_by_path={path: p[K["name"]] for path, p in by_path.items()},
                    **{k: rows[K["name"]][k] for k in keys}) for K in (K1, K2)]
    emit(kernels=kernels)
    # K1 runs in the forward and in training, K2 in training
    expected = {"forward": [K1["name"]], "train": [K1["name"], K2["name"]]}
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

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
3. ``kernels``: kernel K1 (flash-attention forward) against its plain
   PyTorch version at the serving shapes, f32 and bf16, causal and not,
   d = 64 and 128, a ragged s; with times of the kernel, the plain version
   and ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick the
   port never calls) beside the bound of the card.
4. ``forward``: the main path's full-sequence eval forward of the serving
   GPT at full width, through the ``attention_core`` kernel, against the
   same model with ``FLAGS_kernel_overrides="attention_core=xla"``.
5. ``serve``: ``DecodeEngine`` behind ``ContinuousBatchingScheduler``
   answering 16 greedy requests, each checked against ``generate()``.

The kernel counts are set to 0 just before the main path (phases 4 and 5)
and read just after it. Then one JSON line lists every kernel with its
launches in that run, and the last line is the ``{"ok": true, ...}`` result.
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

# the serving configuration of bench_serve.py (GPT, h=1024, L=16, 16 heads)
SERVE_CFG = dict(vocab_size=50304, hidden_size=1024, num_layers=16, num_heads=16, max_seq_len=1024)
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
# logits of the whole forward, flash vs plain attention in f32: the
# attention outputs differ by f32 rounding (~1e-6), which 16 layers carry
# into logits of order 1
LOGITS_TOL = (1e-4, 1e-4)

K1 = dict(name="flash_attention_fwd", route="cuda",
          source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
          replaces="paddle_tpu/ops/flash_attention.py:126")


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


def attention_bound(b, s, h, d, causal, dtype):
    """The least time (ms) the card needs for one attention forward: the
    larger of the bytes it must move (q, k, v read once, out and lse written
    once) over the memory rate, and its matmul flops (4 d per visible
    query-key pair) over the peak rate for the dtype."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * s * h * d * elem + b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
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

    names = ["flash_attention_fwd"]
    seconds = _cuda.build(names)
    ptxas = {n: [ln.strip() for ln in _cuda.library_path(n).with_name(
        _cuda.library_path(n).name + ".log").read_text().splitlines() if "registers" in ln]
        for n in names}
    emit(phase="build", seconds=seconds, ptxas=ptxas)


def phase_kernels():
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
    k1_row = phase_kernels()

    model = GPTForPretraining(GPTConfig(**SERVE_CFG), seed=SEED).eval()
    ids = torch.randint(0, SERVE_CFG["vocab_size"], (8, 1024), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
    with torch.no_grad():  # warm-up: cuBLAS handles and the kernel's library
        model(ids)
    # the main path: counts from 0, read after the forward and the server
    fa.flash_attention_fwd.launches = 0
    phase_forward(model, ids)
    phase_serve(model)
    launches = fa.flash_attention_fwd.launches

    emit(kernels=[dict(K1, launches=launches, shape=k1_row["shape"], causal=k1_row["causal"],
                       dtype=k1_row["dtype"], max_abs_err=k1_row["max_abs_err"], ms=k1_row["ms"],
                       plain_ms=k1_row["plain_ms"], bound_ms=k1_row["bound_ms"],
                       bound_by=k1_row["bound_by"], library_ms=k1_row["library_ms"])])
    if launches == 0:
        raise AssertionError("the main path launched K1 no time")
    emit(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # a failed phase: report it, exit non-zero, print no result
        print(json.dumps({"failed": type(exc).__name__, "error": str(exc)[:2000]}), flush=True)
        raise

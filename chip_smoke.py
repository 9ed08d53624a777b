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
25. ``serve_round2`` (run after phase 5): ``bench_serve.py:_measure``'s
    full-width branch: 32 requests of 64 new tokens (a shared 256-token
    prefix and tails of 32-127 tokens from ``default_rng(0)``, each tail
    twice) through ``DecodeEngine`` (8 slots, cache 1024) behind
    ``ContinuousBatchingScheduler``, once through the bucketed path
    (buckets 64-512) and once through the round-2 path (``prefill_chunk``
    128, ``prefix_cache_mb`` 512, ``fuse`` 8), best of 2 trials each:
    requests/s, latency p50/p99, TTFT p50, prefill stall p99 and the
    seconds of the engine's steps; the prefix hit rate and tokens reused;
    then ``generate()`` on ``[8, 64]`` for 128 tokens at fuse 8 and at fuse
    1 (tokens/s, decode calls per token, one fused window and one step
    traced). Every round-2 request's tokens equal the bucketed round's,
    fused tokens equal unfused ones, the prefix cache hits, and fuse 8 takes
    at most 1/8 + 1/128 decode calls per token of a slot.
26. ``serve_spec`` (run after phase 25): ``bench_serve.py:_measure_spec``'s
    full-width branch: ``[8, 62]`` prompts, 128 decode tokens, through the
    plain engine, speculative decoding (``spec_k`` 4) with the target as
    its own draft and with a small random draft (h 256, 2 layers, 4 heads,
    ``draft_seed`` 1), the int8 KV cache and int8 weights: tokens/s of each,
    both acceptance rates, decode calls per token, ``kv_bytes_per_slot`` at
    f32 and int8 and the share of the int8 arms' tokens equal to the f32
    engine's. Both spec arms give the plain engine's tokens, the int8
    cache is at least 3x smaller per slot, and its stored rows are within
    half a quantization step of the f32 engine's.
27. ``fleet`` (run after phase 26): ``bench_serve.py:_measure_fleet``'s
    full-width branch: ``ServingFleet`` of 2 in-process replicas (8 slots,
    cache 1024, chunk 128, fuse 8, 256 MB prefix cache each), 16 requests of
    32 new tokens on a shared 256-token prefix (tails of 32-127 tokens from
    ``default_rng(0)``; request i with seed i): a warm run, a timed run
    (requests/s, latency, TTFT), one fleet step traced with every slot
    decoding, a run with replica 1 killed after its second tick (p99,
    requeues, deaths), scale-out TTFT (a cold build) and the tracing
    plane's cost (``FLAGS_trace`` on against off, the run log written in
    both, interleaved, min of 2). The timed and the kill runs' tokens equal
    the warm run's, every request finishing once.
28. ``procfleet``: ``_measure_procfleet``'s full-width branch: 16 requests
    of 32 new tokens (prompts of 32-127 tokens), chunk 128, fuse 8, through
    2 in-process replicas and then through ``ProcServingFleet``, 2 replica
    processes on the card (``heartbeat_timeout`` 120): boot seconds,
    requests/s, ``transport_overhead_pct``, streaming TTFT, and p99 with
    replica 1 SIGKILLed after its second tick message. Both cross-process
    arms give the in-process tokens, request 0's streamed chunks join into
    its tokens, and each child reports 0 launches of K1-K4b in its beats.
29. ``ingress``: ``_measure_ingress``'s full-width branch: the same fleet
    at 16 requests of 16 new tokens behind ``ServingIngress``: requests/s
    over HTTP against the fleet driven directly, the store transport
    against the socket one (``socket_vs_store_overhead_pct``), streaming
    TTFT over HTTP, ``disconnect_cancel_ms``, ``drain_under_load_ms`` (rc
    0, the 3 in-flight requests finished), and 4 HTTP streams with replica
    1 SIGKILLed mid-decode, each bitwise equal to the direct run.
30. ``alerts``: ``_measure_alerts``'s full-width branch: 2 in-process
    replicas, 12 requests of 16 new tokens, one TTFT-p50 SLO sized off the
    healthy TTFT with burn windows of a few chaos ticks, a metered healthy
    run (``slo_eval_overhead_pct`` against the 2% budget), then a run under
    ``FLAGS_chaos_replica_slow_ms`` and a recovery run:
    ``alert_detection_ms``, ``alert_firing_ms``, ``/healthz`` 503 and the
    page in ``/alerts`` while it fires, a ``/metrics`` scrape that parses;
    a page under the chaos, none on healthy traffic, the alert cleared.
31. ``dlrm_train`` (run after phase 24): ``bench_recsys.py:_measure``'s
    one-chip branch uncut: ``DLRM`` (13 dense features, 8 tables of
    100,000 x 64 fused into one 800,000-row ``ShardedEmbedding``, bottom
    MLP 256-128-64, top MLP 256-128-1), ``RowSparseAdam(1e-3)``, f32 with
    TF32 off, ``TrainStep.run_steps`` over stacks of 8 batches of 4096 from
    the bench's generator (power-law ids, ``default_rng(0)``): one warm-up
    call, then 4 timed calls; the bench's keys (examples/s,
    ``touched_row_fraction``, ``dispatches_per_run_steps``, ...), ms per
    step, peak memory, one traced step (device ms by group: the optimizer,
    the embedding backward, the zero-fill, the GEMMs, the rest) and the
    bounds of the masked-table update and of a touched-rows-only one. The
    losses are finite, one dispatch per call, and after a further call
    every table row outside its ids keeps its value and both moments
    bitwise.
32. ``dlrm_check``: DLRM at full width with 8 x 10,000 rows and batch 512,
    3 ``run_steps`` steps on the card against the CPU from the same weights
    and batches, in f32 (two card runs bitwise equal) and in float64; and
    2 eager ``Adam(lazy_mode=True)`` steps over ``Embedding(sparse=True)``.
33. ``optim_check``: one step of every optimizer (SGD, Momentum, Adam,
    AdamW, RowSparseAdam, Lamb, Adagrad, RMSProp, Adadelta, Adamax; with L2
    and L1 decay and each clip) on the card against the CPU, through
    ``step()`` and through the ``TrainStep`` update, on a ``[4096, 1024]``
    weight and a ``[1024]`` bias.
34. ``zero_gpt3_train`` (run after phase 17): phase 17's step through
    ``fleet.init(sharding=True, sharding_stage=2)``, ``distributed_step``
    and ``shard_batch`` in a world of one over NCCL, 8 steps from the same
    seed: losses bitwise equal to phase 17's, 96 K1 and 48 K2 a step; the
    sharding layer's device ms (the stream held by a sleep kernel) and
    host ms, its collective calls a step, peak memory, and a plain
    ``TrainStep`` over the same model timed in turns with it.
35. ``hybrid_gpt3``: BASELINE #4 as ``bench_1p3b.py:25-60`` sets it:
    ``GPTConfig.gpt3_1p3b(max_seq_len=256)`` at full width and depth, f32
    AdamW lr 1e-4, sdp 2 x mp 2 x pp 2, ZeRO stage 2, 2 micro-batches
    through ``1f1b``, ids ``[4, 256]`` from ``default_rng(0)``; the port's
    plain one-process f32 step on the same weights and batch first, then
    2 steps as 8 gloo processes on ``cuda:0``, each loading its slice of
    the parent's weights: every rank's losses within rtol 1e-4 of the plain
    step's, K1 and K2 24 times a step on every rank, stage s holding at
    most ``pp - s`` micro-batches' inputs; each rank's peak memory, seconds
    and host-staged bytes.
36. ``dist_two_rank_de`` (run after ``dist_two_rank``): (d) a narrow GPT
    at sdp 2 with ZeRO stage 3 and (e) a narrow ERNIE at mp 2, each as two
    gloo processes on ``cuda:0`` against one process's steps, K1 and K2
    counted on each rank.
37. ``ep_moe_train`` (run after phase 9, before phase 8): phase 9's GPT-MoE
    at full width at dp 2 = ep 2 as two gloo processes on ``cuda:0``, each
    holding 4 of the 8 experts of every MoE layer and ``[4, 1024]`` of
    phase 9's ids, GShard jitter on, 3 f32 AdamW steps: every rank's losses
    within ``EP_LOSS_RTOL`` of phase 9's first 3 (the routing is the global
    batch's, the jitter the one-process draws) and the global gradient norm
    after step 1 within ``EP_GRAD_RTOL`` of phase 9's, K4 and K4b 4 times a
    step on each rank and K1 and K2 8; ms per step (steps 2-3), bytes
    staged through the host, collective calls, peak memory per rank and the
    owner's live rows per expert of each MoE layer (read in step 1, which
    the ms per step leaves out). Phase 8 then holds K4/K4b against their
    plain versions at the owner's call (4 experts, rank 0's rows).
38. ``sep_gpt_train`` (run after phase 8): phase 6's O2 GPT at full width
    at sep 2 through Ulysses, two gloo processes on ``cuda:0`` each holding
    ``[8, 512]`` of phase 6's ids, 3 steps: every rank's losses within
    ``SEP_LOSS_RTOL`` of phase 6's first 3 and the global gradient norm
    after step 1 within ``SEP_GRAD_RTOL`` of phase 6's, K1 and K2 16 times a step on
    each rank at ``[8, 1024, 8, 64]`` (half the heads over the whole
    sequence; phase 3 holds K1/K2 against their plain versions there); ms
    per step and bytes staged.
39. ``mp_decode`` (run after phase 30): GPT decoding at mp 2: the serving
    GPT's greedy ``generate`` of 32 tokens on ``[4, 64]`` prompts by this
    process and by two gloo processes on ``cuda:0`` at ``mp_degree`` 2
    (half the heads, the KV cache and the vocabulary each): the tokens
    bitwise equal on both ranks and to this process's; per step the
    largest logit difference and the smallest top-2 margin; ms per token.
    No kernel of this repository runs (decoding attends in plain PyTorch).
40. ``resilient_gpt_train`` (run after phase 38): phase 6's O2 GPT with
    ``guard=True`` through ``run_resilient`` and a ``CheckpointManager``
    under ``build/`` (a checkpoint every 2 steps, 2 kept), 6 steps, a crash
    at step 3 whose HOLD checkpoint is corrupted on disk (the restore walks
    back to step 2) and NaN gradients at dispatch 4 (skipped): every loss
    equal in bits to an uninterrupted guarded run's, the restored state
    bitwise the saved one leaf by leaf, the skipped step leaving the state
    bitwise, 16 K1 and 16 K2 per dispatch; checkpoint bytes and the seconds
    of each save and restore.
41. ``elastic_gpt_rescale``: ``python -m paddle_tpu_torch.distributed.launch
    --nnodes 2 --nproc_per_node 1 --elastic_np 1:2`` twice (node ranks 0
    and 1) over ``examples/elastic_gpt_torch.py``: phase 6's O2 GPT at sdp 2
    with ZeRO-2, two gloo workers on ``cuda:0``, a checkpoint every step;
    the second node leaves after 1 step, the first relaunches at world 1
    (NCCL), restores through the converter and trains 1 more step: the
    restored state bitwise the sdp-2 checkpoint, the world-1 losses equal in
    bits to this process's from the same checkpoint, every step's loss (the
    world-1 step's follows the sdp-2 update) within ``ELASTIC_LOSS_RTOL``
    of phase 6's at that step; then ``--serve`` boots 2
    replicas of the serving GPT that ``ProcServingFleet.attach`` adopts: 8
    requests with an in-process fleet's tokens, the launcher's exit 0.
42. ``amp_o1_gpt_train`` (run after phase 7): bench.py's train GPT with the
    per-layer trunk under ``TrainStep(amp_level="O1", amp_dtype="bfloat16")``,
    3 AdamW steps at ``[8, 1024]`` through K1/K2 and through ``sdpa=xla``
    from the same weights: the bf16 instances of K1 and K2 16 times a step
    each, the losses within ``AMP_LOSS_RTOL`` of the plain run's.
43. ``fp16_gpt_train``: the same GPT trained eagerly under
    ``auto_cast(dtype="float16")`` with a ``GradScaler`` and the eager AdamW,
    5 steps, an inf planted in step 1's gradients: the float16 instances of
    K1 and K2 16 times a step each, step 1 skipped with the parameters
    bitwise and the scale halved, the scale doubled after 2 clean steps,
    the losses within ``AMP_LOSS_RTOL`` of the plain run's. Phase 3 holds
    the float16 instances against their plain versions at
    :data:`F16_CALLS` and times them against their bound and SDPA.
44. ``zero_offload_gpt3_train`` (after phase 18): phase 18's step with
    ``sharding_configs.offload``: the AdamW moments in pinned host memory,
    streamed through the card chunk by chunk; the losses equal in bits to
    phase 17's, 96 K1 and 48 K2 a step, the peak device memory below phase
    18's; the pinned bytes and the last update's copy times. Then
    ``offload_guard_check``: a 1-layer GPT whose AdamW state is one offload
    chunk, ZeRO-2 with and without offload under the training guard, NaN
    gradients at dispatch 1: the bad step leaves every master and moment
    bitwise, and each dispatch's state and loss are equal in bits with and
    without offload.
45. ``dlrm_sharded_train`` (last): phase 31's config at 4 shards as 4 gloo
    processes on ``cuda:0`` (200,000 table rows and a quarter of each
    global batch of 4096 each) against one process's run: lookup and
    table gradient of one batch bitwise; batch 0's table gradient from the
    whole model bitwise equal to one process's with its MLPs on the same
    quarter blocks (``_dlrm_grad_witness``); 8 steps' losses and moments
    within the reference's dp4-against-dp1 gate, the touched rows of the
    table by ``DLRM_SHARDED_TOL``, ``exchange_stats``'s bytes equal to the
    exchange's counters and to the bytes the collectives moved; then the
    rotation dp 4 -> dp 2 -> dp 4 through ``EmbeddingCheckpointRotation``,
    bitwise.
46. ``flat_kernels`` holds K3/K3b's float16 instances too: BERT's call with
    the f32 padding bias an ``auto_cast(float16)`` step gives them, a
    float16 ``[1, 1, s, s]`` bias, and GPT's packed causal call, with the
    times of the kernel, the plain version and float16
    ``scaled_dot_product_attention`` with the same mask.
47. ``dropout_gpt_train`` (after ``bert_check``): bench.py's train GPT with
    dropout 0.1 (``attn_dropout`` 0.0) through ``TrainStep`` O2 at
    ``[8, 1024]``, 5 steps: 16 K1 and 16 K2 a step; each site's keep share
    within 5 binomial standard deviations of 0.9, masks differing between
    steps, layers and sites; a selective-recompute twin's first step with
    the loss and every gradient bitwise the plain model's; a resume by
    ``state``/``load_state`` after 5 steps giving the next 2 losses
    bitwise; a step with ``attn_dropout`` 0.1 launching no K1/K2 (the
    composite, as the reference's predicates route dropout); then ms a
    step guarded and unguarded, with dropout and without, whose difference
    prices the guard's host read at a step's first draw.
48. ``dropout_bert_train``: BERT-base with dropout 0.1 through ``TrainStep``
    O2 on the padded ``[16, 512]`` batch: 12 K3 and 12 K3b a step, the
    losses against ``sdpa=xla`` from the same weights and masks within
    ``DROPOUT_BERT_RTOL``. Then ``transformer_encoder_train``: BERT-base's
    encoder built from the layer library (``nn.TransformerEncoder``) on the
    same batch and padding bias, O2 bf16 through ``TrainStep`` and O1
    float16 eagerly with a ``GradScaler``: 12 K3 and 12 K3b a step, the bf16
    instances then the float16 ones, each arm's losses against
    ``sdpa=xla``.
49. ``transformer_base_decode``: ``nn.Transformer()`` at its defaults
    (Transformer-base) under a 37000-token shared vocabulary, 3 f32 steps
    at src/tgt ``[32, 128]`` (the composite: attention dropout, 2-D
    masks), then greedy decoding of 32 tokens for 8 sources by full
    recompute, through ``FixedCache`` (bitwise the same tokens) and through
    ``QuantizedFixedCache`` (the share of equal tokens printed); the eval
    encoder's attention takes K1.
50. ``parallel_dropout_gpt_train`` (after ``dropout_gpt_train``): the same
    dropout GPT as worlds of 4 gloo processes on ``cuda:0``, 2 O2 steps
    each, one spawn running them in turn: mp 2 x sep 2 (every rank's
    losses within ``SEP_LOSS_RTOL`` of ``dropout_gpt_train``'s first 2,
    its gradient norm after step 1 within ``PDROP_GRAD_RTOL`` of that run's)
    and mp 2 x pp 2 through 1F1B with 2 micro-batches (held so to one
    process's ``TrainStep(accumulate_steps=2)`` from the same seed), then
    mp 2 x sep 2 with dropout 0 (held so to phase 6's run) and a control
    world at mp 2 x sep 2 whose sep ranks all keep block 0 of each sharded
    mask, which must fall outside those limits; 16 K1 and 16 K2 a
    step on every rank (at ``PDROP_CALLS``, whose kernel rows phases 2-3
    time); the parameters replicated over mp bitwise equal on both mp
    ranks of each coordinate; every rank's draws and keep shares; the ms
    a step of a sep rank's sliced draws against local ones.
51. ``rnn_lm_train``: Zaremba et al.'s large LSTM language model
    (``RNN_LM``) from the port's layers, 3 SGD steps with dropout 0.65
    (ms a step); its dropout-0 step against the same model on the CPU;
    beam search over an ``LSTMCell`` with its first layer's weights
    against the CPU's; ``ctc_loss`` at ``RNN_CTC`` and its gradient
    against the CPU's; no kernel of the repository.
52. ``tensor_api`` (after phase 7): every case of
    ``paddle_tpu_torch/testing/tensor_cases.py`` (the reference's 281 public
    tensor functions, the CPU parity sweep's table) on card tensors against
    the same function on the CPU copy of its inputs: bitwise for the
    manipulation, logic, search, integer and creation functions, the
    table's tolerance for the elementwise, reduction and linear-algebra
    ones, invariants (singular values, reconstructions, moduli) for the
    factorisations that are not unique, every output on the card, and the
    gradients of ``sum(out * w)`` within 1e-5 where the table compares
    them; the
    random functions for shape, dtype, device, determinism under
    ``paddle.seed`` and moments; the functions that synchronise with the
    host (``torch.cuda.set_sync_debug_mode``) and the slowest, by ms a
    call; a ``PyLayer`` with a hand-written tanh-GELU backward on a
    ``[8, 1024, 4096]`` bf16 tensor against autograd of the plain formula
    (both against f32 autograd), and ``jacobian``/``hessian`` on the card
    against the CPU. No kernel of the repository.
53. ``paddle_api_gpt_train`` (after phase 52): phase 6's O2 GPT written as
    a user writes it against the port's ``paddle.*`` API
    (``import paddle_tpu_torch as paddle``, ``set_device("gpu")``,
    ``seed``, four id batches drawn by ``paddle.randint``): 2 O2 steps, the
    model's and the optimizer's ``state_dict()`` through ``paddle.save``
    into a directory under ``build/``, everything deleted, a fresh model,
    ``AdamW`` and ``TrainStep`` from ``paddle.load``, steps 3-4. Their losses
    are bitwise an uninterrupted 4-step run's from the same seed, with 16
    K1 and 16 K2 a step; ``paddle.device.cuda.max_memory_allocated()``
    equals torch's; the file bytes, the save and load seconds and ms a
    step.
54. ``vision_zoo_train`` (after phase 24): AlexNet, VGG-16, SqueezeNet 1.1,
    MobileNet V1, V2 and V3 large, ShuffleNet V2 x1.0, DenseNet-121 and
    GoogLeNet at 224 x 224 and Inception v3 at 299 x 299, 1000 classes,
    each at its published widths, trained as phase 22 trains ResNet50
    (``ZOO_TRAIN``: AMP O2, Momentum, batch 64, 2 warm-up and 5 timed
    steps, one traced): ms a step, images/s, peak memory, the top device
    kernels and the model-flops bound share; the losses finite, the
    running buffers finite and moved, the parameters f32.
55. ``vision_zoo_check``: each of those models on the card against the
    CPU from one state at batch 4, f32 with TF32 off (``ZOO_CHECK``): the
    eval logits, the step's loss, train-mode logits and gradients, and the
    running buffers after it; and a control (one running variance scaled
    on the card) that must fail the eval gate.
56. ``nn_layers_api``: the norms, pools and transposed and channel-last
    convolutions of the nn library's second half, functions and layers, on
    card tensors against the CPU, values and gradients, bf16 under
    ``auto_cast`` where the reference's lists cast; ``ceil_mode``, masks
    through ``max_unpool*``, transposed convolutions at dilation 2 and
    ``groups=2``; the calls that synchronise with the host.

The serving phases (5, 25-30, 39), the vision phases (22-24, 54-56), DLRM's (31,
45), the RNN phase (51) and the tensor API's (52) launch none of K1-K4b: the reference runs no Pallas kernel on those paths
(serving attends in jnp, the port in plain PyTorch; convolutions are
cuDNN's, batch norms and pools ATen's; the embedding lookup is
``jnp.take``, the optimizers jnp); the script checks that their counts
stay 0, in the replica processes too.

Phases 4, 5, 25, 26, 27, 28, 29, 30, 39, 6, 9 (its ``pallas_sorted`` run),
37 and 38 (the ranks' counts, summed), 40, 41 (this process's steps from
the checkpoint), 42, 43, 12, 13, ``dp_bert_train``, 16, 17, 34, 44, 35
(summed), 20, 22, 24, 31, 45 (the ranks' counts, summed), 47, 48 (both
arms of each), 49, 50 (the ranks' counts, summed), 51, 52, 53 (its
resumed run), 54 and 56 are the main path: the kernel counts are set
to 0 just before each of them and read just after it. Then one JSON line lists every kernel
with its launches in those runs (K1 and K3 with a ``bf16_row`` too: their
O2 steps' bf16 call; K2 with an ``f32_row``: the f32 steps' call; K4 and
K4b at the first MoE layer's rows of the traced step, whose ``bound_ms``
counts the live rows, the rows the kernels compute, with an ``ep_row``: the
ep 2 owner's call, its ``bound_ms`` over its live rows too and its
``bound_padded_ms`` over all its rows; K1 and K2 with ``d128_rows``: the d = 128 calls of phases
17, 20 and 35, the sep 2 call of phase 38 and the per-rank calls of
phase 50; and with ``f16_rows``: their
float16 instances at the O2 and the 1.3B calls) and the script's wall time,
and the last line is the ``{"ok": true, ...}`` result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside the
# tensor cores (the K1 kernel's f32 FMA path), and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# the serving configuration of bench_serve.py (GPT, h=1024, L=16, 16 heads),
# which is also the flagship training configuration of bench.py
SERVE_CFG = dict(vocab_size=50304, hidden_size=1024, num_layers=16, num_heads=16, max_seq_len=1024)
# bench.py's step: batch [8, 1024], AdamW(lr 1e-4), TrainStep(amp_level="O2")
TRAIN = dict(batch=8, seq=1024, lr=1e-4, warmup=3, steps=10, check_batch=2)
# the server: bench_serve.py's slots, cache length and prefill buckets
SERVE = dict(slots=8, max_seq_len=1024, buckets=(64, 128, 256, 512), requests=16, new_tokens=32,
             prompt_lens=(16, 480))
# bench_serve.py:_measure's full-width branch (:112-117): the bucketed path
# and the round-2 path (chunk 128, 512 MB of prefix cache, fuse 8) serve 32
# requests of 64 new tokens, best of 2 trials each (the bench's 3, cut to
# keep the script's slowest run under about 1000 s of its 1200); generate()
# on [8, 64] for 128 tokens times fused decode
SERVE_ROUND2 = dict(slots=8, max_seq_len=1024, buckets=(64, 128, 256, 512), requests=32,
                    new_tokens=64, chunk=128, prefix_mb=512.0, fuse=8, decode_tokens=128, trials=2)
# bench_serve.py:_measure_spec's full-width branch (:598-603): the draft model,
# prompts [8, 62], 128 decode tokens, spec_k 4
SERVE_SPEC = dict(draft=dict(vocab_size=50304, hidden_size=256, num_layers=2, num_heads=4,
                             max_seq_len=1024),
                  slots=8, max_seq_len=1024, buckets=(64,), decode_tokens=128, spec_k=4)
# the int8 cache's dequantized rows against the f32 engine's: half a
# quantization step (abs_max / 127) of the row, plus 1e-6 of its abs_max for
# the K/V projections' f32 rounding (the same matmul on the same inputs)
INT8_ROUND_TRIP_SLACK = 1e-6
# bench_serve.py's serving-tier phases at full width: _measure_fleet
# (:313-332: 2 in-process replicas, 8 slots, cache 1024, chunk 128, fuse 8,
# 256 MB prefix cache, 24 requests of 32 new tokens on a shared 256-token
# prefix; the tracing cost interleaved, min of 3; here 16 requests and min
# of 2, cut as SERVE_ROUND2's trials are), _measure_procfleet
# (:466-474: 2 replica processes, no prefix cache, prompts of 32-127 tokens,
# heartbeat_timeout 120 as at :511; here 16 requests, not 24) and
# _measure_ingress (:867-875: the same at 16 requests of 16 new tokens)
SERVE_FLEET = dict(replicas=2, slots=8, max_seq_len=1024, chunk=128, fuse=8, prefix_mb=256.0,
                   requests=16, new_tokens=32, trace_repeats=2)
SERVE_PROCFLEET = dict(replicas=2, slots=8, max_seq_len=1024, chunk=128, fuse=8, requests=16,
                       new_tokens=32, heartbeat_timeout=120.0)
SERVE_INGRESS = dict(SERVE_PROCFLEET, requests=16, new_tokens=16)
# bench_serve.py:_measure_alerts's full-width branch (:697-701): 2 in-process
# replicas, 8 slots, cache 1024, chunk 128, fuse 8, 12 requests of 16 new
# tokens, the SLO monitor evaluated every 50 ms (:747)
SERVE_ALERTS = dict(replicas=2, slots=8, max_seq_len=1024, chunk=128, fuse=8, requests=12,
                    new_tokens=16, eval_every_s=0.05)
SEED = 0

# f32: atol 1e-5 / rtol 1e-4 (true f32 on both sides, sums in another order).
# bf16: the kernel's bf16 output against the plain version in f32 on the same
# bf16 inputs, atol 2e-2 (one bf16 rounding of values of order 1). lse is
# f32 on both sides in both cases.
# float16: atol 5e-3, one float16 rounding (2**-11) of values of a few units
# (read 2.0e-3 on the card).
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 0.0), torch.float16: (5e-3, 0.0)}
LSE_TOL = (1e-5, 1e-4)
# K2's dq, dk, dv. f32: atol 2e-5 / rtol 1e-4, the reference's gradient
# tolerance for its own kernel pair (tests/test_flash_interpret.py). bf16:
# the kernel's bf16 gradients against the plain version in f32 on the same
# bf16 inputs, atol 2e-2 / rtol 1e-2 (one bf16 rounding is 2**-8 relative;
# gradients reach a few units).
# float16: atol 5e-3 / rtol 2e-3 (one float16 rounding; read 3.9e-3 on
# gradients up to 6).
GRAD_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 1e-2),
            torch.float16: (5e-3, 2e-3)}
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

# dist_two_rank: BERT at full width cut to 2 layers, f32 (TF32 off), the
# global [16, 512] batch of bert_train, 3 AdamW steps at lr 1e-4, at dp 2 and
# at mp 2 in two gloo processes on one card against one process's
# full-batch step; and one SyncBatchNorm layer at dp 2 on [8, 64, 16, 16]
# dp_bert_train holds the stream with a sleep kernel of this many cycles (about
# 50 ms) while the host enqueues the reducer's passes, so CUDA events around
# them time the device's work alone
DP_HOLD_CYCLES = 100_000_000
DIST_CHECK = dict(layers=2, batch=16, seq=512, lr=1e-4, steps=3, bn_shape=(8, 64, 16, 16),
                  timeout=600.0)
# the losses within rtol 1e-5 of the one-process step's and the first step's
# (averaged, gathered) gradients within a relative L2 error of 1e-4, as
# TRAIN_CHECK_TOL; each parameter after the steps within a relative L2 error
# of 2e-5, the tolerance the CPU parity tests hold whole AdamW steps to
# (Adam divides each gradient by its own RMS, so f32 sums in another order
# carry into the update undamped). The parameters that start at 0 (the
# biases) are held by their gradient above and, after the steps, within
# the steps' reach of 2 lr each: AdamW moves an entry whose gradient is
# within rounding noise of 0 (the key block of a qkv bias is exactly 0 in
# exact arithmetic) by about lr times the sign of that noise, which is of
# the order of such a parameter's whole norm after a few steps (measured on
# the card: qkv biases 1.2e-2 to 2.9e-2 relative L2, ffn1.bias 1.9e-5, the
# weights below 2e-5). The batch norm's
# outputs and gradients within atol 1e-5 plus rtol 1e-5 of the largest
# entry (sums over the batch split in two)
DIST_CHECK_TOL = dict(loss_rtol=1e-5, grad_rel_l2=1e-4, param_rel_l2=2e-5, bn_atol=1e-5,
                      bn_rtol=1e-5)

# dist_two_rank (d): a narrow GPT (h 1024, 4 layers, 16 heads, d 64, vocab
# 50304), f32, ids [4, 512], 3 AdamW steps at lr 1e-4, at sdp 2 with ZeRO
# stage 3; (e): a narrow ERNIE (h 768, 2 layers, 12 heads, vocab 40000),
# f32, ids [8, 256], 3 steps at lr 1e-4, at mp 2; each against one
# process's step on the card, to DIST_CHECK_TOL
DIST_ZERO3 = dict(cfg=dict(vocab_size=50304, hidden_size=1024, num_layers=4, num_heads=16,
                           max_seq_len=512), batch=4, seq=512, lr=1e-4, steps=3)
DIST_ERNIE = dict(cfg=dict(vocab_size=40000, hidden_size=768, num_layers=2, num_heads=12,
                           max_seq_len=256), batch=8, seq=256, lr=1e-4, steps=3)
# hybrid_gpt3: BASELINE #4 as bench_1p3b.py:25-60 (_cpu_mesh_step) sets it:
# GPTConfig.gpt3_1p3b(max_seq_len=256) at full width and depth, f32, AdamW
# lr 1e-4, sdp 2 x mp 2 x pp 2 (dp 1), ZeRO stage 2, accumulate_steps 2
# through "1f1b", ids [4, 256] from default_rng(0) with labels = ids; 2
# steps as 8 gloo processes on one card
HYBRID = dict(sdp=2, mp=2, pp=2, stage=2, accumulate=2, schedule="1f1b", batch=4, seq=256,
              lr=1e-4, steps=2, timeout=900.0)
# the ranks' losses against the plain one-process step's: the reference's
# own hybrid step is held to its serial one at rtol 1e-4
# (tests/test_pipeline_pp.py:89-93); sums over 24 layers split over mp
# and micro-batches in another order
HYBRID_LOSS_RTOL = 1e-4
# K1/K2's per-rank call in the hybrid step: one micro-batch of [1, 256], 8
# heads a rank (16 / mp 2), d 128, causal, f32, views of the packed projection
HYBRID_CALL = (1, 256, 8, 128, True)

# ep_moe_train: moe_train's GPT-MoE (MOE_CFG, f32 AdamW lr 1e-4, GShard
# jitter on) at dp 2 = ep 2 as two gloo processes on cuda:0, each holding 4
# of the 8 experts of every MoE layer and [4, 1024] of moe_train's ids; 3
# steps. Each rank's losses within rtol 1e-6 of moe_train's first 3 from the
# same weights, and the global gradient norm after step 1 within rtol 1e-7
# of moe_train's: the routing is the global batch's and the jitter draws are
# the one-process draws, so only f32 sums in another order part them (the
# gate and attention products over half the rows, the gradients averaged
# over the ranks). Measured on the H100: losses 9.1e-8 (one f32 ulp at
# 10.8), gradient norm 1.2e-8
EP_MOE = dict(dp=2, steps=3, timeout=600.0)
EP_LOSS_RTOL = 1e-6
EP_GRAD_RTOL = 1e-7
# sep_gpt_train: train's O2 GPT (SERVE_CFG) at sep 2 through Ulysses as two
# gloo processes on cuda:0, each holding [8, 512] of train's ids; 3 steps.
# Each rank's losses within rtol 1e-4 of train's first 3 from the same
# weights, and the global gradient norm after step 1 within rtol 2e-5 of
# train's: bf16 products over half the sequence may round in another order
# (2**-8 relative each, averaged over 8192 tokens), the f32 master gradients
# summed over the ranks. Measured on the H100: losses 9.7e-6, gradient norm
# 1.7e-6
SEP_GPT = dict(sep=2, steps=3, timeout=600.0)
SEP_LOSS_RTOL = 1e-4
SEP_GRAD_RTOL = 2e-5
# the attention call after Ulysses' exchange: 8 of the 16 heads over the
# whole sequence, views of the packed projection, bf16 (AMP O2)
SEP_CALL = (8, 1024, 8, 64, True)
# GPT decoding at mp 2 (mp_decode): the serving GPT's greedy decode of 32
# tokens on [4, 64] prompts, as 2 gloo processes on cuda:0, tokens bitwise
MP_DECODE = dict(mp=2, batch=4, prompt=64, new_tokens=32, timeout=600.0)
# resumed O2 training (resilient_gpt_train): 6 steps of train's GPT through
# run_resilient, a checkpoint every 2 steps, the last 2 kept; a crash at step
# 3 (its HOLD checkpoint corrupted), NaN gradients at dispatch 4
RESILIENT = dict(steps=6, every=2, keep_last_k=2, crash_at=3, nan_at=4)
# the elastic rescale (elastic_gpt_rescale): 1 step at sdp 2, then 1 at
# world 1 after the restore (each step writes a 3 GB checkpoint: 1 and 1,
# not the example's 2 and 2, to keep the script's slowest run under about
# 1000 s of its 1200); 3 checkpoints kept (the restored one stays for
# this process's comparison); then --serve with 2 replicas, 8 requests
ELASTIC = dict(world_steps=1, total_steps=2, keep=3, timeout=900.0, serve_replicas=2,
               serve_requests=8, serve_new_tokens=16)
# every step's loss against train's at that step: the world-2 (sdp 2, ZeRO-2)
# step's before any update, the world-1 step's after the sdp-2 update (read
# 8.8e-8 and 1.7e-5 on the card at 2 world-2 steps: bf16 compute on half
# batches, their gradients averaged)
ELASTIC_LOSS_RTOL = 2e-4

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
# float16: the relative max error of one float16 rounding (2**-11) of P
# before P V and of dS before dQ, a few times over
FLAT_TOL = {**MOE_TOL, torch.float16: 4e-3}
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
# vision_zoo_train: every family of paddle_tpu/vision/models at its
# published widths (the constructors' defaults, 1000 classes) and ImageNet's
# 224 x 224 (Inception v3 at its 299 x 299), trained as resnet50_train is:
# AMP O2 TrainStep over Momentum, CrossEntropyLoss, normal inputs
# (default_rng(0)) and int64 labels (default_rng(1)), batch 64, 2 warm-up
# and 5 timed steps on one batch, then one step traced; lr 0.01, AlexNet's
# and VGG's published rate (at 0.1 VGG-16, with no batch norm, diverges
# within two steps from random weights)
ZOO = (("alexnet", 224), ("vgg16", 224), ("squeezenet1_1", 224), ("mobilenet_v1", 224),
       ("mobilenet_v2", 224), ("mobilenet_v3_large", 224), ("shufflenet_v2_x1_0", 224),
       ("densenet121", 224), ("googlenet", 224), ("inception_v3", 299))
ZOO_TRAIN = dict(batch=64, classes=1000, lr=0.01, warmup=2, steps=5)
# vision_zoo_check: each of those models from one state (the port's draws
# on the CPU, seed 40; running means Normal(0, 0.1), variances U(0.5, 1.5)),
# batch 4 at its training size, f32 with TF32 off and dropout at p 0: the
# card's eval logits and one Momentum step (loss, train-mode logits, the
# gradients as (before - after) / lr, the running statistics after) against
# the same on the CPU. The gates stand about 10x above the largest readings
# of the first card run (PERF.md, PR 21: eval 1.1e-5 relative L2, train
# logits 4.6e-5, loss 1.7e-6, buffers 7.0e-6 apart, gradients 2.9e-2).
# Training mode at batch 4 is ill-conditioned in f32, as ResNet50's is
# (resnet_check): batch norms over few values carry each rounding into the
# gradients, so their gate catches only a gross fault. The control scales
# one batch norm's running variance by 1.5 on the card (without batch
# norms, the first weight by 1.001), which the eval gate must catch.
ZOO_CHECK = dict(batch=4, lr=0.1, seed=40, control_scale=1.5, control_weight_scale=1.001)
ZOO_CHECK_TOL = dict(eval_rel_l2=1e-4, train_rel_l2=5e-4, loss_rtol=2e-5, grad_rel_l2=0.3,
                     buffers_atol=1e-4)
# nn_layers_api: the functions and layers of the nn library's second half on
# card tensors against the CPU, values and the gradients of sum(y * w), the
# largest error over the largest value of each: f32 (TF32 off) 1e-5, bf16
# under auto_cast O1 (the reference's lists: convolutions white, norms
# black) 2e-2
NN_API_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# dlrm_train: bench_recsys.py:_measure's one-chip branch (:49-54, 64-96)
# uncut: 8 tables of 100,000 x 64 fused into one 800,000-row table, batch
# 4096, one warm-up run_steps call of k = 8 steps, then 4 timed calls,
# RowSparseAdam(1e-3), f32 with TF32 off
DLRM_TRAIN = dict(num_dense=13, vocab_sizes=(100_000,) * 8, embedding_dim=64,
                  bottom_mlp=(256, 128), top_mlp=(256, 128), batch=4096, k=8, rounds=4, lr=1e-3)
# dlrm_check: the same widths at a cut vocabulary and batch, 3 run_steps
# steps on the card against the CPU from the same weights and batches, in
# f32 (TF32 off) and in float64 (with the BCE in float64; the optimizer's
# state stays f32, as the port keeps it). An f32 DLRM step is
# ill-conditioned in its MLPs: a bias gradient that cancels to near Adam's
# eps (one of bottom.2's is 3.6e-8, summed from 512 terms of 1e-5, 1.8%
# off in f32) moves its update by a share of lr, and the next steps carry
# that on. Measured on the CPU at this shape: the port's f32 step against
# its float64 step after 3 steps, bottom.0.bias 4.4e-3 relative L2, the
# table, its moments and the loss below 5e-7. So f32 holds the loss to rtol
# 1e-5, the table and its moments to a relative L2 of 1e-5 and the MLP
# parameters to 2e-2, which catches only a gross fault; float64 holds
# everything to 1e-9. Two f32 card runs from the same start are bitwise
# equal: the embedding backward is a sorted segment reduction.
DLRM_CHECK = dict(vocab_sizes=(10_000,) * 8, batch=512, steps=3, eager_steps=2)
DLRM_CHECK_TOL = {
    torch.float32: dict(loss_rtol=1e-5, table_rel_l2_max=1e-5, mlp_rel_l2_max=2e-2),
    torch.float64: dict(loss_rtol=1e-12, table_rel_l2_max=1e-9, mlp_rel_l2_max=1e-9)}
# optim_check: one step of each core (and each decay and clip) on the card
# against the CPU, a [4096, 1024] weight and a [1024] bias; each parameter
# and state tensor within a max error of 1e-6 of its largest entry (the
# same elementwise f32 formula on both, the norms of Lamb and the clips
# summed in another order)
OPTIM_CHECK = dict(shape=(4096, 1024), lr=1e-2)
OPTIM_CHECK_TOL = 1e-6
# recompute_check, accum_check and ernie_check run the configs at full width
# cut to this depth
CHECK_LAYERS = 2
# the d = 128 attention calls of those steps, (b, s, h, d, causal), both bf16
# (AMP O2) through views of the packed [b, s, 3, h, d] projection: the 1.3B
# step's per micro-batch (attention_core, whose backward writes one packed
# gradient) and ERNIE's (sdpa/flash, whose backward makes three buffers)
D128_CALLS = {"gpt3_1p3b_train": (2, 2048, 16, 128, True), "ernie_train": (16, 512, 24, 128, False)}
# the float16 instances of K1 and K2 are held and timed at the O2 step's
# call and at the 1.3B step's, (b, s, h, d, causal), views of the packed
# projection; fp16_gpt_train runs the first
F16_CALLS = {"o2_call": (8, 1024, 16, 64, True), "gpt3_1p3b_call": (2, 2048, 16, 128, True)}


def launch_counters():
    """Each kernel's wrapper, whose ``launches`` counts its kernel's
    launches, by the wrapper's name (each ``K*["name"]``)."""
    from paddle_tpu_torch.ops import kernel_wrappers

    return {w.__name__: w for w in kernel_wrappers()}


def reset_launches():
    """Every kernel's launch count set to 0, and K1's and K2's counts by
    dtype cleared."""
    for wrapper in launch_counters().values():
        wrapper.launches = 0
        getattr(wrapper, "launches_by_dtype", {}).clear()


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
    cases += [(*HYBRID_CALL, torch.float32, True), (*SEP_CALL, torch.bfloat16, True)]
    cases += [(*call, torch.bfloat16, True) for call in PDROP_CALLS.values()]
    # the float16 instance at the O2 call and at the 1.3B call (F16_CALLS)
    cases += [(*call, torch.float16, True) for call in F16_CALLS.values()]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main_row, bf16_row, d128_rows, f16_rows, failures = None, None, {}, {}, []
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
        if (b, s, h, d, causal, dt, packed) == (*HYBRID_CALL, torch.float32, True):
            d128_rows["hybrid_gpt3"] = row
        if (b, s, h, d, causal, dt, packed) == (*SEP_CALL, torch.bfloat16, True):
            d128_rows["sep_gpt_train"] = row
        d128_rows.update({path: row for path, call in PDROP_CALLS.items()
                          if (b, s, h, d, causal, dt, packed) == (*call, torch.bfloat16, True)})
        f16_rows.update({name: row for name, call in F16_CALLS.items()
                         if (b, s, h, d, causal, dt, packed) == (*call, torch.float16, True)})
        del q, k, v
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K1 disagrees with its plain version in {len(failures)} case(s)")
    return main_row, bf16_row, d128_rows, f16_rows


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
    # the hybrid step's per-rank call, f32, packed gradient (attention_core);
    # the sep 2 step's call after Ulysses' exchange, bf16, packed gradient
    cases += [(*HYBRID_CALL, torch.float32, True), (*SEP_CALL, torch.bfloat16, True)]
    # the per-rank calls of parallel_dropout_gpt_train's two worlds
    cases += [(*call, torch.bfloat16, True) for call in PDROP_CALLS.values()]
    # the float16 instance, packed gradient, at the O2 and the 1.3B calls
    cases += [(*call, torch.float16, True) for call in F16_CALLS.values()]
    return cases


def phase_k2():
    """K2 against its plain version; returns the row of the main path's
    call ([8, 1024, 16, 64] causal bf16 through packed-qkv strides, as the
    O2 training step makes it), the row of the same call in f32 (the f32
    steps' call), and the rows of the d = 128 calls of the 1.3B and ERNIE
    steps, by path. ``packed``: True for views of a packed
    projection whose gradient K2 writes into one packed buffer, ``"views"``
    for the same views with new gradient buffers."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    main_row, f32_row, d128_rows, f16_rows, failures = None, None, {}, {}, []
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
        if (b, s, h, d, causal, dt, packed) == (8, 1024, 16, 64, True, torch.float32, True):
            f32_row = row
        d128_rows.update({path: row for path, call in D128_CALLS.items()
                          if (b, s, h, d, causal, dt) == (*call, torch.bfloat16) and packed})
        if (b, s, h, d, causal, dt, packed) == (*HYBRID_CALL, torch.float32, True):
            d128_rows["hybrid_gpt3"] = row
        if (b, s, h, d, causal, dt, packed) == (*SEP_CALL, torch.bfloat16, True):
            d128_rows["sep_gpt_train"] = row
        d128_rows.update({path: row for path, call in PDROP_CALLS.items()
                          if (b, s, h, d, causal, dt, packed) == (*call, torch.bfloat16, True)})
        f16_rows.update({name: row for name, call in F16_CALLS.items()
                         if (b, s, h, d, causal, dt, packed) == (*call, torch.float16, True)})
        del q, k, v, dout, out, lse, got, grads
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K2 disagrees with its plain version in {len(failures)} case(s)")
    return main_row, f32_row, d128_rows, f16_rows


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


def _serve_round(model, prompts, warm, trials, **engine_kwargs):
    """``bench_serve.py:serve_round``: one engine, its programs warmed on
    ``warm`` (outside every clock), then ``trials`` runs of every prompt
    through a fresh scheduler; the best run by requests/s (with the calls
    and seconds of the engine's admission, prefill and decode steps in it),
    and every run's tokens by request."""
    from paddle_tpu_torch.inference import ContinuousBatchingScheduler, DecodeEngine

    R2 = SERVE_ROUND2
    eng = DecodeEngine(model, max_batch_slots=R2["slots"], max_seq_len=R2["max_seq_len"],
                       **engine_kwargs)
    for w in warm:
        eng.generate(w, max_new_tokens=2)
    spent = {}

    def timed(name):
        step = getattr(eng, name)

        def run(*a, **kw):  # each ends in host values: synchronised
            t = time.perf_counter()
            out = step(*a, **kw)
            calls, seconds = spent.get(name, (0, 0.0))
            spent[name] = (calls + 1, seconds + time.perf_counter() - t)
            return out

        setattr(eng, name, run)

    for name in ("begin_prefill", "prefill_step", "decode_step"):
        timed(name)
    best, tokens = None, []
    for _ in range(trials):
        spent.clear()
        sched = ContinuousBatchingScheduler(eng)
        rids = [sched.submit(p, max_new_tokens=R2["new_tokens"]) for p in prompts]
        t0 = time.perf_counter()
        done = sched.run()
        dt = time.perf_counter() - t0
        tokens.append([done[r].tokens for r in rids])
        reqs = [done[r] for r in rids]
        trial = dict(requests_per_s=len(done) / dt, seconds=dt,
                     latency_p50_ms=1e3 * float(np.percentile([r.total_seconds for r in reqs], 50)),
                     latency_p99_ms=1e3 * float(np.percentile([r.total_seconds for r in reqs], 99)),
                     ttft_p50_ms=1e3 * float(np.percentile([r.ttft_seconds for r in reqs], 50)),
                     prefill_stall_p99_ms=1e3 * float(np.percentile(
                         [r.stall_seconds for r in reqs], 99)),
                     prefix_tokens=sum(r.prefix_tokens for r in reqs),
                     engine_calls={k: c for k, (c, _) in spent.items()},
                     engine_seconds={k: t for k, (_, t) in spent.items()})
        if best is None or trial["requests_per_s"] > best["requests_per_s"]:
            best = trial
    return eng, best, tokens


def _trace_decode(eng, prompts, new_tokens, **kw):
    """One ``decode_step`` traced (``profile_step``) with every row of
    ``prompts`` prefilled into its slot."""
    eng.reset()
    for i, p in enumerate(prompts):
        eng.prefill(p, slot=i, max_new_tokens=new_tokens)
    trace = profile_step(lambda *_: eng.decode_step(**kw), None, None)
    eng.reset()
    return trace


def phase_serve_round2(model):
    """``bench_serve.py:_measure``'s full-width branch: 32 requests (a shared
    256-token prefix and tails of 32-127 tokens, each tail twice) through the
    bucketed path and through the round-2 path (chunked prefill, prefix
    cache, fused decode), best of 2 each; then ``generate()`` on ``[8, 64]``
    for 128 tokens at fuse 8 and at fuse 1. Gates: every round-2 request's
    tokens equal the bucketed round's, fused tokens equal unfused ones, the
    prefix cache hits, and fused decode takes at most 1/8 + 1/128 decode
    calls per token of a slot."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.observability import metrics

    R2 = SERVE_ROUND2
    V, C = model.gpt.cfg.vocab_size, R2["chunk"]
    t_phase = time.perf_counter()
    # bench_serve.py:127-185 draws from one default_rng(0), in this order
    rng = np.random.default_rng(SEED)
    decode_prompt = rng.integers(0, V, (R2["slots"], C // 2))
    lens = rng.integers(max(1, C // 4), C, max(1, R2["requests"] // 2))
    shared = rng.integers(0, V, (2 * C,))
    tails = [rng.integers(0, V, (int(n),)) for n in lens]
    prompts = [np.concatenate([shared, tails[i % len(tails)]]) for i in range(R2["requests"])]
    warm_prev = [rng.integers(0, V, (1, b)) for b in R2["buckets"]]
    warm_cur = [rng.integers(0, V, (1, C + 1))]

    _, prev, prev_tokens = _serve_round(model, prompts, warm_prev, R2["trials"],
                                        prefill_buckets=R2["buckets"])
    torch.cuda.empty_cache()
    metrics.reset_counters("serving.")
    eng, cur, cur_tokens = _serve_round(model, prompts, warm_cur, R2["trials"], prefill_chunk=C,
                                        prefix_cache_mb=R2["prefix_mb"], fuse=R2["fuse"])
    pstats = eng.prefix_cache.stats()
    reused = int(metrics.counters("serving.").get("serving.prefix_tokens_reused", 0))
    entry_mb = eng.prefix_cache.entry_bytes / 1e6
    del eng
    torch.cuda.empty_cache()

    # decode throughput: bench_serve.py:128-152
    eng = DecodeEngine(model, max_batch_slots=R2["slots"], max_seq_len=R2["max_seq_len"],
                       prefill_chunk=C, fuse=R2["fuse"])
    eng.generate(decode_prompt, max_new_tokens=2)
    eng.generate(decode_prompt, max_new_tokens=2, fuse=1)
    n_tok = R2["decode_tokens"]
    metrics.reset_counters("infer.")
    t0 = time.perf_counter()
    fused = eng.generate(decode_prompt, max_new_tokens=n_tok)
    fused_s = time.perf_counter() - t0
    dispatches = int(metrics.counters("infer.")["infer.decode_dispatches"])
    t0 = time.perf_counter()
    unfused = eng.generate(decode_prompt, max_new_tokens=n_tok, fuse=1)
    unfused_s = time.perf_counter() - t0
    kv_gb = eng.cache_bytes() / 1e9
    step_bytes = sum(p.numel() * p.element_size() for p in model.parameters()) + eng.cache_bytes()
    traces = {"fused_window": _trace_decode(eng, decode_prompt, n_tok),
              "decode_step": _trace_decode(eng, decode_prompt, n_tok, fuse=1)}
    del eng
    torch.cuda.empty_cache()

    mismatched = sorted({i for trial in cur_tokens + prev_tokens[1:] for i, t in enumerate(trial)
                         if t != prev_tokens[0][i]})
    per_slot_token = dispatches / n_tok  # decode calls per token of one slot
    ok = (not mismatched and all(len(t) == R2["new_tokens"] for t in prev_tokens[0])
          and np.array_equal(fused, unfused) and pstats["hits"] >= 1
          and per_slot_token <= 1 / R2["fuse"] + 1 / n_tok)
    emit(phase="serve_round2", ok=ok, requests=R2["requests"], new_tokens=R2["new_tokens"],
         prompt_lens=[len(p) for p in prompts], trials=R2["trials"],
         prev=dict(prev, knobs=dict(prefill_buckets=list(R2["buckets"]))),
         round2=dict(cur, knobs=dict(prefill_chunk=C, prefix_cache_mb=R2["prefix_mb"],
                                     fuse=R2["fuse"])),
         requests_mismatched_vs_bucketed=mismatched,
         prefix_hit_rate=pstats["hits"] / max(1, pstats["hits"] + pstats["misses"]),
         prefix_cache=pstats, prefix_tokens_reused=reused, prefix_entry_mb=entry_mb,
         decode_tokens_per_s=R2["slots"] * n_tok / fused_s,
         decode_tokens_per_s_unfused=R2["slots"] * n_tok / unfused_s,
         fused_equals_unfused=bool(np.array_equal(fused, unfused)),
         decode_dispatches=dispatches, decode_dispatches_per_token=dispatches / (R2["slots"] * n_tok),
         decode_dispatches_per_slot_token=per_slot_token, kv_cache_gb=kv_gb,
         decode_step_bound_ms=1e3 * step_bytes / PEAK_BYTES, traces=traces,
         seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError("serve_round2 failed its gates")


def phase_serve_spec(model):
    """``bench_serve.py:_measure_spec``'s full-width branch: ``[8, 62]``
    prompts, 128 decode tokens, through the plain engine, speculative
    decoding with the target as its own draft (oracle) and with a small
    random draft (``draft_seed=1``), the int8 KV cache and int8 weights.
    Gates: both spec arms give the plain engine's tokens, the int8 cache
    is at least 3x smaller per slot, and its stored rows are within half a
    quantization step of the f32 engine's."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.models.gpt import GPTConfig, _kv_dequant
    from paddle_tpu_torch.observability import metrics

    SP = SERVE_SPEC
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(0, model.gpt.cfg.vocab_size, (SP["slots"], SP["buckets"][0] - 2))
    kw = dict(max_batch_slots=SP["slots"], max_seq_len=SP["max_seq_len"],
              prefill_buckets=SP["buckets"])
    n_tok = SP["decode_tokens"]

    def timed(eng):
        eng.generate(prompt, max_new_tokens=2)  # warm
        t0 = time.perf_counter()
        out = eng.generate(prompt, max_new_tokens=n_tok)
        return SP["slots"] * n_tok / (time.perf_counter() - t0), out

    plain = DecodeEngine(model, **kw)
    plain_tps, want = timed(plain)
    f32_slot = plain.kv_bytes_per_slot()
    s0 = prompt.shape[1]
    # layer 0's prompt rows, for the int8 arm's round trip
    f32_rows = [plain._ck[0, :, :, :s0].clone(), plain._cv[0, :, :, :s0].clone()]
    del plain
    metrics.reset_counters("infer.")
    oracle = DecodeEngine(model, draft=model, spec_k=SP["spec_k"], **kw)
    oracle_tps, got_oracle = timed(oracle)
    c = metrics.counters("infer.")
    # bench_serve.py:636: less the warm-up's one dispatch and its first tokens
    disp_per_tok = (c["infer.decode_dispatches"] - 1) / max(1, c["infer.tokens"] - SP["slots"])
    oracle_acc = oracle.spec_stats()["acceptance_rate"]
    traces = {"spec_step_oracle": _trace_decode(oracle, prompt, n_tok)}
    del oracle
    small = DecodeEngine(model, draft=GPTConfig(**SP["draft"]), spec_k=SP["spec_k"], draft_seed=1, **kw)
    small_tps, got_small = timed(small)
    small_acc = small.spec_stats()["acceptance_rate"]
    draft_gb = small.draft_cache_bytes() / 1e9
    del small
    torch.cuda.empty_cache()
    i8 = DecodeEngine(model, kv_dtype="int8", **kw)
    i8_tps, got_i8 = timed(i8)
    i8_slot = i8.kv_bytes_per_slot()
    # the round trip on the int8 arm's own rows: layer 0's prompt rows are
    # computed from the tokens alone, so the f32 engine's are their inputs
    rt_err, rt_ok = [], True
    for pack, ref in zip((i8._ck, i8._cv), f32_rows):
        rows = {"q": pack["q"][0, :, :, :s0], "s": pack["s"][0, :, :, :s0]}
        err = (_kv_dequant(rows, torch.float32) - ref).abs()
        amax = ref.abs().amax(dim=-1, keepdim=True)
        rt_ok = rt_ok and bool((err <= 0.5 * amax / 127.0 + INT8_ROUND_TRIP_SLACK * amax).all())
        rt_err.append(float((err / (amax / 127.0).clamp_min(1e-30)).max()))
    traces["decode_step_int8_kv"] = _trace_decode(i8, prompt, n_tok)
    del i8
    torch.cuda.empty_cache()
    w8 = DecodeEngine(model, int8=True, **kw)
    w8_tps, got_w8 = timed(w8)
    del w8
    torch.cuda.empty_cache()
    shrink = f32_slot / i8_slot
    ok = (np.array_equal(got_oracle, want) and np.array_equal(got_small, want)
          and shrink >= 3.0 and rt_ok)
    gen = slice(s0, None)
    emit(phase="serve_spec", ok=ok, prompt=list(prompt.shape), decode_tokens=n_tok,
         spec_k=SP["spec_k"], draft=SP["draft"],
         decode_tokens_per_s_plain=plain_tps, spec_decode_tokens_per_s=oracle_tps,
         spec_decode_tokens_per_s_small_draft=small_tps,
         decode_tokens_per_s_int8_kv=i8_tps, decode_tokens_per_s_int8_weights=w8_tps,
         spec_acceptance_rate=oracle_acc, spec_acceptance_rate_small_draft=small_acc,
         decode_dispatches_per_token=disp_per_tok,
         oracle_equals_plain=bool(np.array_equal(got_oracle, want)),
         small_draft_equals_plain=bool(np.array_equal(got_small, want)),
         kv_bytes_per_slot=i8_slot, kv_bytes_per_slot_f32=f32_slot, kv_shrink=shrink,
         draft_cache_gb=draft_gb,
         int8_kv_round_trip_max_err_in_steps=max(rt_err), int8_kv_round_trip_ok=rt_ok,
         int8_kv_token_share=float((got_i8[:, gen] == want[:, gen]).mean()),
         int8_weights_token_share=float((got_w8[:, gen] == want[:, gen]).mean()),
         traces=traces, seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError("serve_spec failed its gates")


def _percentile_ms(seconds, q):
    return 1e3 * float(np.percentile(seconds, q))


def _fleet_prompts(vocab, chunk, n, shared):
    """``bench_serve.py``'s fleet prompts from one ``default_rng(0)``: with
    ``shared``, a 2 * chunk shared prefix and tails of chunk/4 to chunk - 1
    tokens (``_measure_fleet``, :326-332); without, prompts of those lengths
    (``_measure_procfleet`` :471-472, ``_measure_ingress`` :877-878)."""
    rng = np.random.default_rng(SEED)
    head = rng.integers(0, vocab, (2 * chunk,)) if shared else np.zeros(0, np.int64)
    return [np.concatenate([head, rng.integers(0, vocab, (int(n),))])
            for n in rng.integers(max(1, chunk // 4), chunk, n)]


def _fleet_run(fleet, prompts, new_tokens, **run_kw):
    """Submit every prompt (request i with seed i) and run the fleet to the
    end: the fleet ids, the completions and the seconds of the run."""
    fids = [fleet.submit(p, max_new_tokens=new_tokens, seed=i) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    done = fleet.run(**run_kw)
    return fids, done, time.perf_counter() - t0


def _child_kernel_launches(fleet):
    """Each replica process's kernel launches, as its last beat reported."""
    return {rid: {k: n for k, n in c.items() if k.startswith("kernels.")}
            for rid, c in fleet.child_counters().items()}


def phase_fleet(model):
    """``bench_serve.py:_measure_fleet``'s full-width branch: 2 in-process
    replicas (8 slots, cache 1024, chunk 128, fuse 8, 256 MB prefix cache
    each), 16 requests of 32 new tokens on a shared 256-token prefix. A warm
    run pins the tokens; then a timed run (requests/s), one fleet step
    traced with both replicas decoding, a run with replica 1 killed after
    its second tick (``FLAGS_chaos_replica_kill_at="1:2"``: p99 latency,
    requeues, deaths; every request finishes once, bitwise equal to the warm
    run), scale-out TTFT (a cold build: the port has no AOT cache), and
    the tracing plane's cost: ``FLAGS_trace`` and the run log on against
    off, interleaved, min of 2."""
    import tempfile

    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.inference import ServingFleet
    from paddle_tpu_torch.testing import chaos

    F = SERVE_FLEET
    t_phase = time.perf_counter()
    prompts = _fleet_prompts(model.gpt.cfg.vocab_size, F["chunk"], F["requests"], shared=True)
    kw = dict(max_batch_slots=F["slots"], max_seq_len=F["max_seq_len"], prefill_chunk=F["chunk"],
              fuse=F["fuse"], prefix_cache_mb=F["prefix_mb"])
    fids, done, _ = _fleet_run(ServingFleet(model, replicas=F["replicas"], **kw), prompts,
                               F["new_tokens"])
    want = [list(done[f].tokens) for f in fids]
    torch.cuda.empty_cache()
    fleet = ServingFleet(model, replicas=F["replicas"], **kw)
    fids, done, dt = _fleet_run(fleet, prompts, F["new_tokens"])
    timed_ok = [list(done[f].tokens) for f in fids] == want
    # one fleet step with every slot of both replicas decoding
    for i, p in enumerate(prompts[:2 * F["slots"]]):
        fleet.submit(p, max_new_tokens=F["new_tokens"], seed=i, replica=i % F["replicas"])
    while any(rep.scheduler.queue or rep.scheduler.prefilling for rep in fleet.replicas.values()):
        fleet.step()
    trace = profile_step(lambda *_: fleet.step(), None, None)
    fleet.run()

    with chaos.inject(FLAGS_chaos_replica_kill_at=f"{F['replicas'] - 1}:2"):
        fleet_k = ServingFleet(model, replicas=F["replicas"], **kw)
        fids_k, done_k, _ = _fleet_run(fleet_k, prompts, F["new_tokens"])
    stats_k = fleet_k.stats()
    kill_ok = (sorted(done_k) == sorted(fids_k) and stats_k["dead"] == [F["replicas"] - 1]
               and [list(done_k[f].tokens) for f in fids_k] == want)
    del fleet_k
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    new = fleet.scale_out(1)
    fid = fleet.submit(prompts[0], max_new_tokens=2, seed=0, replica=new[0])
    while fleet.requests[fid].status != "finished":
        fleet.step()
    scaleout_ttft = fleet.requests[fid].first_token_ts - t0
    del fleet
    torch.cuda.empty_cache()

    # the run log's disk mirror is on in both arms; FLAGS_trace alone differs
    prev = get_flags(["FLAGS_trace", "FLAGS_run_log_dir"])
    with tempfile.TemporaryDirectory() as logs:
        def timed_run(trace_on):
            set_flags({"FLAGS_trace": trace_on, "FLAGS_run_log_dir": f"{logs}/{int(trace_on)}"})
            return _fleet_run(ServingFleet(model, replicas=F["replicas"], **kw), prompts,
                              F["new_tokens"])[2]

        try:
            timed_run(True)
            timed_run(False)
            t_off, t_on = [], []
            for _ in range(F["trace_repeats"]):
                t_off.append(timed_run(False))
                t_on.append(timed_run(True))
        finally:
            set_flags(prev)
    torch.cuda.empty_cache()
    ok = timed_ok and kill_ok
    emit(phase="fleet", ok=ok, replicas=F["replicas"], requests=len(prompts),
         new_tokens=F["new_tokens"], prompt_lens=[len(p) for p in prompts],
         knobs=dict(kw, replicas=F["replicas"]),
         requests_per_s=len(prompts) / dt, seconds=dt,
         latency_p50_ms=_percentile_ms([r.total_seconds for r in done.values()], 50),
         latency_p99_ms=_percentile_ms([r.total_seconds for r in done.values()], 99),
         ttft_p50_ms=_percentile_ms([r.ttft_seconds for r in done.values()], 50),
         timed_equals_warm=timed_ok, fleet_step_trace=trace,
         p99_under_kill_ms=_percentile_ms([r.total_seconds for r in done_k.values()], 99),
         kill_exactly_once_bitwise=kill_ok, requeues_under_kill=stats_k["requeues"],
         replica_deaths=len(stats_k["dead"]), death_reason=stats_k["per_replica"][F["replicas"] - 1]
         ["death_reason"], scaleout_ttft_ms=1e3 * scaleout_ttft,
         trace_off_s=t_off, trace_on_s=t_on,
         trace_overhead_pct=100.0 * (min(t_on) - min(t_off)) / min(t_off),
         seconds_phase=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError("fleet: the timed or the kill run differs from the warm run")


def phase_procfleet(model):
    """``bench_serve.py:_measure_procfleet``'s full-width branch: 16 requests
    of 32 new tokens (prompts of 32-127 tokens), chunk 128, fuse 8, no
    prefix cache, 2 replicas. The in-process arm (a warm run pins the
    tokens, then a timed run); then 2 replica processes on this card,
    ``heartbeat_timeout=120``: boot seconds, one untimed request on each
    (their first CUDA work; the reference's children boot warm from its AOT
    cache), requests/s with request 0 streamed (``stream_ttft_p50_ms``
    over all requests' first chunks), ``transport_overhead_pct``; then a
    fleet whose replica 1 is SIGKILLed after its second tick message
    (``FLAGS_chaos_replica_sigkill_at="1:2"``): p99 latency, requeues,
    deaths. Every token list of both cross-process arms equals the
    in-process arm's, the streamed chunks join into request 0's tokens, and
    every child launched no kernel of this repository."""
    from paddle_tpu_torch.inference import ProcServingFleet, ServingFleet
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.testing import chaos

    P = SERVE_PROCFLEET
    t_phase = time.perf_counter()
    cfg = GPTConfig(**SERVE_CFG)
    prompts = _fleet_prompts(cfg.vocab_size, P["chunk"], P["requests"], shared=False)
    kw = dict(max_batch_slots=P["slots"], max_seq_len=P["max_seq_len"], prefill_chunk=P["chunk"],
              fuse=P["fuse"])
    fids, done, _ = _fleet_run(ServingFleet(model, replicas=P["replicas"], **kw), prompts,
                               P["new_tokens"])
    want = [list(done[f].tokens) for f in fids]
    fids, done_in, dt_in = _fleet_run(ServingFleet(model, replicas=P["replicas"], **kw), prompts,
                                      P["new_tokens"])
    inproc_ok = [list(done_in[f].tokens) for f in fids] == want
    torch.cuda.empty_cache()

    def boot():
        t0 = time.perf_counter()
        pf = ProcServingFleet(cfg, model_seed=SEED, replicas=P["replicas"],
                              heartbeat_timeout=P["heartbeat_timeout"], **kw)
        boot_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for rid in pf.replicas:
            pf.submit(prompts[rid], max_new_tokens=2, seed=rid, replica=rid)
        pf.run(timeout_s=600)
        return pf, boot_s, time.perf_counter() - t0

    pf, boot_s, first_s = boot()
    try:
        stream = pf.submit(prompts[0], max_new_tokens=P["new_tokens"], seed=0, stream=True)
        fids = [stream.fid] + [pf.submit(p, max_new_tokens=P["new_tokens"], seed=i)
                               for i, p in enumerate(prompts) if i > 0]
        t0 = time.perf_counter()
        chunks = list(stream)
        pf.run(timeout_s=600)
        dt_p = time.perf_counter() - t0
        got = [list(pf.requests[f].tokens) for f in fids]
        finished_p = all(pf.requests[f].status == "finished" for f in fids)
        ttft_p = [pf.requests[f].ttft_seconds for f in fids]
        stats_p = pf.stats()
        launches_p = _child_kernel_launches(pf)
    finally:
        pf.shutdown()
    with chaos.inject(FLAGS_chaos_replica_sigkill_at=f"{P['replicas'] - 1}:2"):
        pf_k = ProcServingFleet(cfg, model_seed=SEED, replicas=P["replicas"],
                                heartbeat_timeout=P["heartbeat_timeout"], **kw)
        try:
            fids_k, done_k, _ = _fleet_run(pf_k, prompts, P["new_tokens"], timeout_s=600)
            got_k = [list(pf_k.requests[f].tokens) for f in fids_k]
            stats_k = pf_k.stats()
            launches_k = _child_kernel_launches(pf_k)
        finally:
            pf_k.shutdown()
    child_launches = sum(n for arm in (launches_p, launches_k) for c in arm.values()
                         for n in c.values())
    ok = (inproc_ok and finished_p and got == want
          and [t for c in chunks for t in c] == want[0]
          and len(done_k) == len(prompts) and got_k == want
          and stats_k["dead"] == [P["replicas"] - 1] and child_launches == 0
          and len(launches_p) == len(launches_k) == P["replicas"])
    rps_in, rps_p = len(prompts) / dt_in, len(prompts) / dt_p
    emit(phase="procfleet", ok=ok, replicas=P["replicas"], requests=len(prompts),
         new_tokens=P["new_tokens"], prompt_lens=[len(p) for p in prompts],
         knobs=dict(kw, replicas=P["replicas"], heartbeat_timeout=P["heartbeat_timeout"]),
         requests_per_s_inproc=rps_in,
         latency_p99_ms_inproc=_percentile_ms([r.total_seconds for r in done_in.values()], 99),
         ttft_p50_ms_inproc=_percentile_ms([r.ttft_seconds for r in done_in.values()], 50),
         boot_seconds=boot_s, first_request_seconds=first_s, requests_per_s=rps_p,
         transport_overhead_pct=100.0 * (rps_in / rps_p - 1.0),
         stream_ttft_p50_ms=_percentile_ms(ttft_p, 50), stream_chunks=len(chunks),
         transport=stats_p["per_replica"][0]["transport"],
         p99_under_sigkill_ms=_percentile_ms([r.total_seconds for r in done_k.values()], 99),
         requeues_under_sigkill=stats_k["requeues"], replica_deaths=len(stats_k["dead"]),
         death_reason=stats_k["per_replica"][P["replicas"] - 1]["death_reason"],
         tokens_equal_inproc=got == want, sigkill_tokens_equal_inproc=got_k == want,
         stream_equals_request0=[t for c in chunks for t in c] == want[0],
         child_kernel_launches={"fault_free": launches_p, "sigkill": launches_k},
         seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError("procfleet: a cross-process arm differs from the in-process run, "
                             "lost a request, or a child launched a kernel")


def _http_generate(port, body, stream=False, key=None):
    """POST ``body`` to ``/v1/generate``: ``(status, doc, t_first)``; a
    stream's doc is ``{"tokens": every chunk's tokens joined, "final": the
    done line}`` and ``t_first`` the arrival of its first line."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Content-Type": "application/json"}
    if key:
        headers["Idempotency-Key"] = key
    conn.request("POST", "/v1/generate", body=json.dumps(body).encode(), headers=headers)
    r = conn.getresponse()
    if not stream:
        doc = json.loads(r.read())
        conn.close()
        return r.status, doc, None
    toks, t_first, final = [], None, None
    while True:
        line = r.readline()
        if not line:
            break
        doc = json.loads(line)
        if t_first is None:
            t_first = time.perf_counter()
        if "tokens" in doc:
            toks.extend(doc["tokens"])
        else:
            final = doc
    conn.close()
    return r.status, {"tokens": toks, "final": final}, t_first


def _threads(target, args):
    import threading

    ts = [threading.Thread(target=target, args=a) for a in args]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    if any(t.is_alive() for t in ts):
        raise AssertionError("an HTTP client thread did not finish")


def phase_ingress():
    """``bench_serve.py:_measure_ingress``'s full-width branch: 16 requests
    of 16 new tokens, chunk 128, fuse 8, 2 replica processes on this card
    behind ``ServingIngress``. Warm-up run, then the same requests driven
    directly (requests/s, the reference tokens), over HTTP from 4 client
    threads (requests/s), 4 sequential HTTP streams (TTFT), a client
    dropped mid-stream (ms until the request is cancelled), a drain with 3
    requests in flight (ms, rc 0, all 3 finished); the same work on the
    store transport alone (``use_sockets=False``:
    ``socket_vs_store_overhead_pct``); and 4 HTTP streams with replica 1
    SIGKILLed after its first tick message, mid-decode, each stream bitwise
    equal to the direct run. Every child launched no kernel of this repository."""
    from paddle_tpu_torch.inference import ProcServingFleet, ServingIngress
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.testing import chaos

    G = SERVE_INGRESS
    t_phase = time.perf_counter()
    cfg = GPTConfig(**SERVE_CFG)
    n = G["requests"]
    prompts = _fleet_prompts(cfg.vocab_size, G["chunk"], n, shared=False)
    kw = dict(max_batch_slots=G["slots"], max_seq_len=G["max_seq_len"], prefill_chunk=G["chunk"],
              fuse=G["fuse"], heartbeat_timeout=G["heartbeat_timeout"])
    bodies = [{"prompt": [int(t) for t in p], "max_new_tokens": G["new_tokens"], "seed": i}
              for i, p in enumerate(prompts)]

    def warm_and_time(pf):
        for i, p in enumerate(prompts):
            pf.submit(p, max_new_tokens=G["new_tokens"], seed=500 + i)
        pf.run(timeout_s=600)
        fids, _, dt = _fleet_run(pf, prompts, G["new_tokens"], timeout_s=600)
        return [list(pf.requests[f].tokens) for f in fids], dt

    launches = {}
    pf = ProcServingFleet(cfg, model_seed=SEED, replicas=G["replicas"], **kw)
    try:
        want, dt_direct = warm_and_time(pf)
        ing = ServingIngress(pf, port=0)
        results = [None] * n

        def http_worker(idxs):
            for i in idxs:
                results[i] = _http_generate(ing.port, bodies[i])[:2]

        t0 = time.perf_counter()
        _threads(http_worker, [(range(k, n, 4),) for k in range(4)])
        dt_http = time.perf_counter() - t0
        http_ok = all(st == 200 and doc["status"] == "finished" and doc["tokens"] == want[i]
                      for i, (st, doc) in enumerate(results))
        ttfts, stream_ok = [], True
        for i in range(4):
            t0 = time.perf_counter()
            st, doc, t_first = _http_generate(ing.port, dict(bodies[i], stream=True), stream=True)
            stream_ok = stream_ok and st == 200 and doc["tokens"] == want[i]
            ttfts.append(t_first - t0)

        # a client that drops mid-stream: its request is cancelled mid-decode
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", ing.port, timeout=600)
        conn.request("POST", "/v1/generate",
                     body=json.dumps(dict(bodies[0], max_new_tokens=8 * G["new_tokens"],
                                          stream=True)).encode(),
                     headers={"Idempotency-Key": "disconnect"})
        r = conn.getresponse()
        r.readline()
        freq = ing._idem["disconnect"]
        t0 = time.perf_counter()
        conn.sock.close()
        conn.close()
        while freq.status not in ("finished", "cancelled", "deadline_exceeded"):
            if time.perf_counter() - t0 > 60:
                raise AssertionError("ingress: a dropped client's request never ended")
            time.sleep(0.002)
        disconnect_ms = 1e3 * (time.perf_counter() - t0)

        drain_docs = []

        def drain_worker(i):
            drain_docs.append(_http_generate(ing.port, dict(bodies[i], seed=100 + i))[1])

        import threading

        dts = [threading.Thread(target=drain_worker, args=(i,)) for i in range(3)]
        for t in dts:
            t.start()
        t0 = time.perf_counter()
        while len(ing._active) < 3 and time.perf_counter() - t0 < 60:
            time.sleep(0.002)
        t0 = time.perf_counter()
        drain_rc = ing.drain(grace=300)
        drain_ms = 1e3 * (time.perf_counter() - t0)
        for t in dts:
            t.join(timeout=600)
        drain_finished = sum(1 for d in drain_docs if d.get("status") == "finished")
        launches["socket"] = _child_kernel_launches(pf)
    finally:
        pf.shutdown()

    pf_s = ProcServingFleet(cfg, model_seed=SEED, replicas=G["replicas"], use_sockets=False, **kw)
    try:
        got_store, dt_store = warm_and_time(pf_s)
        launches["store"] = _child_kernel_launches(pf_s)
    finally:
        pf_s.shutdown()

    # replica 1 serves 2 of the 4 streams in 3 ticks (one prefill, two fused
    # calls of 8): killed after its first, it still holds both mid-decode
    # (after its second, it may hold nothing: bench_serve.py's "1:2")
    with chaos.inject(FLAGS_chaos_replica_sigkill_at=f"{G['replicas'] - 1}:1"):
        pf_k = ProcServingFleet(cfg, model_seed=SEED, replicas=G["replicas"], **kw)
        ing_k = ServingIngress(pf_k, port=0)
        try:
            kill = [None] * 4

            def kill_worker(i):
                kill[i] = _http_generate(ing_k.port, dict(bodies[i], stream=True), stream=True)[:2]

            _threads(kill_worker, [(i,) for i in range(4)])
            stats_k = pf_k.stats()
            launches["sigkill"] = _child_kernel_launches(pf_k)
        finally:
            ing_k.stop()
            pf_k.shutdown()
    kill_ok = all(st == 200 and doc["final"]["status"] == "finished" and doc["tokens"] == want[i]
                  for i, (st, doc) in enumerate(kill))
    child_launches = sum(c for arm in launches.values() for rep in arm.values() for c in rep.values())
    ok = (http_ok and stream_ok and freq.status == "cancelled" and drain_rc == 0
          and drain_finished == 3 and got_store == want and kill_ok
          and stats_k["dead"] == [G["replicas"] - 1] and stats_k["requeues"] >= 1
          and child_launches == 0)
    emit(phase="ingress", ok=ok, replicas=G["replicas"], requests=n, new_tokens=G["new_tokens"],
         prompt_lens=[len(p) for p in prompts], knobs=dict(kw, replicas=G["replicas"]),
         ingress_requests_per_s=n / dt_http, requests_per_s_direct=n / dt_direct,
         http_overhead_pct=100.0 * (dt_http / dt_direct - 1.0),
         socket_vs_store_overhead_pct=100.0 * (dt_direct / dt_store - 1.0),
         requests_per_s_store=n / dt_store,
         stream_ttft_p50_ms=_percentile_ms(ttfts, 50), http_equals_direct=http_ok,
         streams_equal_direct=stream_ok, store_equals_socket=got_store == want,
         disconnect_cancel_ms=disconnect_ms, disconnect_status=freq.status,
         disconnect_tokens=len(freq.tokens), drain_under_load_ms=drain_ms, drain_rc=drain_rc,
         drain_finished=drain_finished, exactly_once_under_sigkill=kill_ok,
         requeues_under_sigkill=stats_k["requeues"], replica_deaths=len(stats_k["dead"]),
         child_kernel_launches=launches, seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError("ingress failed its gates")


# one line of the Prometheus text exposition: a HELP/TYPE comment or a
# sample with optional labels
PROM_LINE = r'^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .*|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]+="([^"\\]|\\.)*"\})? \S+)$'


def _http_get(port, path):
    """``GET path`` on the local exporter: ``(status, body)``, a 503 too."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def phase_alerts(model):
    """``bench_serve.py:_measure_alerts``'s full-width branch: the SLO monitor
    watching an in-process ``ServingFleet`` (2 replicas, 8 slots, cache 1024,
    chunk 128, fuse 8), 12 requests of 16 new tokens (prompts of 32-127
    tokens from ``default_rng(0)``, request i with seed i). Warm and healthy
    runs; one TTFT-p50 SLO whose objective (``max(50, 2 x`` healthy p50) ms),
    chaos tick (``min(2500, max(150, 4 x`` healthy p50) ms) and windows
    (fast ``max(2, 6 x`` chaos s), slow 4 x fast) are sized off the healthy
    TTFT; installed with a 50 ms cadence; a metered healthy run (the
    monitor's cost against its 2% budget), a quiet fast window, a run under
    ``FLAGS_chaos_replica_slow_ms`` and a recovery run, then evaluations
    until the alert clears or 4 slow windows pass. Detection and clearing
    are read from the ``alert`` events of the run log. Gates: a page under
    the chaos and none on healthy traffic, the alert cleared, ``/healthz``
    503 and the page in ``/alerts`` from a ``MetricsExporter`` while it
    fires, a ``/metrics`` scrape that parses and carries
    ``slo_evaluations_total``, every request of every run finished once.
    Unlike the reference, ``FLAGS_compile_cache_dir`` stays unset: the port
    has no AOT cache (ROADMAP.md, Queue 1 item 4), and ``DecodeEngine``
    raises while it is set."""
    import re
    import tempfile

    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.inference import ServingFleet
    from paddle_tpu_torch.observability import exporter, metrics, runlog, slo
    from paddle_tpu_torch.testing import chaos

    A = SERVE_ALERTS
    t_phase = time.perf_counter()
    prompts = _fleet_prompts(model.gpt.cfg.vocab_size, A["chunk"], A["requests"], shared=False)
    kw = dict(max_batch_slots=A["slots"], max_seq_len=A["max_seq_len"], prefill_chunk=A["chunk"],
              fuse=A["fuse"])
    runs = {}

    def serve(tag, on_tick=None):
        """One fleet run of every prompt, ``on_tick`` after each fleet step;
        records whether each request finished exactly once."""
        fleet = ServingFleet(model, replicas=A["replicas"], **kw)
        fids = [fleet.submit(p, max_new_tokens=A["new_tokens"], seed=i)
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        done = {}
        while len(done) < len(fids) and any(
                r.scheduler.queue or r.scheduler.prefilling or r.scheduler.running
                for r in fleet.replicas.values() if r.alive):
            done.update(fleet.run(max_ticks=1))
            if on_tick is not None:
                on_tick()
        dt = time.perf_counter() - t0
        runs[tag] = dict(seconds=dt, once=sorted(done) == sorted(fids)
                         and fleet.finished_total == len(fids)
                         and all(len(done[f].tokens) == A["new_tokens"] for f in fids))
        torch.cuda.empty_cache()
        return dt, [r.ttft_seconds for r in done.values()]

    prev = get_flags(["FLAGS_run_log_dir"])
    exp = None
    with tempfile.TemporaryDirectory() as log_dir:
        set_flags({"FLAGS_run_log_dir": log_dir})
        try:
            # the healthy sample: the warm and healthy runs' TTFTs in a
            # histogram of their own (earlier phases observed into the live
            # series), read as the reference reads its live one
            sample = metrics.Histogram()
            for tag in ("warm", "healthy"):
                for v in serve(tag)[1]:
                    sample.observe(v)
            healthy_ms = (sample.percentile(50) or 0.01) * 1e3
            threshold_ms = max(50.0, 2.0 * healthy_ms)
            slow_ms = int(min(2500.0, max(150.0, 4.0 * healthy_ms)))
            fast_w = max(2.0, 6.0 * slow_ms / 1e3)
            slow_w = 4.0 * fast_w
            spec = slo.SLO("serving.ttft_p50_ms", "percentile", threshold=threshold_ms,
                           histogram="serving.ttft_seconds", q=50, scale=1e3, page_burn=1.2,
                           warn_burn=1.0, description="alerts phase: machine-relative TTFT")
            mon = slo.install([spec], with_regress=False, eval_every_s=A["eval_every_s"],
                              fast_window_s=fast_w, slow_window_s=slow_w)
            exp = exporter.MetricsExporter(port=0).start()
            mon.evaluate()  # baseline snapshot before the metered run

            eval_sum0 = metrics.histogram("slo.eval_seconds").sum
            evals0 = metrics.counter_value("slo.evaluations")
            dt_healthy = serve("metered")[0]
            overhead_pct = 100.0 * (metrics.histogram("slo.eval_seconds").sum - eval_sum0) / dt_healthy
            evaluations = int(metrics.counter_value("slo.evaluations") - evals0)
            paged_on_healthy = mon.states()[0]["severity"] is not None

            time.sleep(fast_w)  # a quiet fast window: no healthy TTFT in it
            mon.evaluate()
            seen = {}

            def scrape_while_paging():
                if "healthz" not in seen and not mon.health_probe()["ok"]:
                    seen["healthz"], _ = _http_get(exp.port, "/healthz")
                    seen["alerts"] = json.loads(_http_get(exp.port, "/alerts")[1])

            t_chaos = time.time()
            with chaos.inject(FLAGS_chaos_replica_slow_ms=str(slow_ms)):
                serve("chaos", on_tick=scrape_while_paging)
            mon.evaluate()
            scrape_while_paging()
            code, text = _http_get(exp.port, "/metrics")
            lines = text.splitlines()
            metrics_ok = (code == 200 and all(re.match(PROM_LINE, line) for line in lines)
                          and any(line.startswith("paddle_tpu_slo_evaluations_total ")
                                  and float(line.split()[1]) > 0 for line in lines))

            serve("recovery")
            deadline = time.time() + 4 * slow_w
            while time.time() < deadline:
                mon.evaluate()
                if mon.states()[0]["severity"] is None:
                    break
                time.sleep(0.1)
            final_quiet = mon.states()[0]["severity"] is None
            pages_fired = int(metrics.counter_value("alerts.page"))

            runlog.monitor().flush()
            events = []
            for name in sorted(os.listdir(log_dir)):
                if name.startswith("run-") and name.endswith(".jsonl"):
                    with open(os.path.join(log_dir, name)) as f:
                        events += [json.loads(line) for line in f if line.strip()]
        finally:
            slo.uninstall()
            if exp is not None:
                exp.stop()
            runlog.monitor().close()
            set_flags(prev)
    alerts = sorted((e for e in events if e.get("event") == "alert" and e.get("slo") == spec.name),
                    key=lambda e: e["ts"])
    healthy_pages = [e for e in alerts if e["ts"] < t_chaos and e.get("state") == "firing"]
    chaos_alerts = [e for e in alerts if e["ts"] >= t_chaos]
    pages = [e for e in chaos_alerts if e.get("state") == "firing" and e.get("severity") == "page"]
    severity = "page" if pages else (chaos_alerts[-1].get("severity") if chaos_alerts else None)
    detection_ms = (pages[0]["since"] - t_chaos) * 1e3 if pages else None
    cleared = [e for e in chaos_alerts if e.get("state") == "cleared" and pages
               and e["ts"] >= pages[0]["ts"]]
    firing_ms = (cleared[-1]["ts"] - pages[0]["since"]) * 1e3 if cleared and pages else None
    page_listed = any(a.get("slo") == spec.name and a.get("severity") == "page"
                      for a in seen.get("alerts", {}).get("alerts", []))
    ok = (bool(pages) and not paged_on_healthy and not healthy_pages and bool(cleared)
          and final_quiet and seen.get("healthz") == 503 and page_listed and metrics_ok
          and all(r["once"] for r in runs.values()))
    emit(phase="alerts", ok=ok, replicas=A["replicas"], requests=len(prompts),
         new_tokens=A["new_tokens"], prompt_lens=[len(p) for p in prompts],
         knobs=dict(kw, replicas=A["replicas"]),
         healthy_ttft_p50_ms=healthy_ms, ttft_threshold_ms=threshold_ms, chaos_slow_ms=slow_ms,
         fast_window_s=fast_w, slow_window_s=slow_w, alert_severity=severity,
         alert_detection_ms=detection_ms,
         detected_within_fast_window=detection_ms is not None and detection_ms <= fast_w * 1e3,
         alert_cleared=bool(cleared) and final_quiet, alert_firing_ms=firing_ms,
         slo_evaluations=evaluations, slo_eval_overhead_pct=overhead_pct,
         slo_eval_overhead_budget_pct=2.0, paged_on_healthy_traffic=paged_on_healthy or bool(healthy_pages),
         page_alerts_fired=pages_fired, healthz_while_paging=seen.get("healthz"),
         page_in_alerts=page_listed, metrics_scrape_ok=metrics_ok,
         alert_transitions=[(e.get("state"), e.get("severity"), e["ts"] - t_chaos)
                            for e in chaos_alerts],
         runs={tag: dict(r) for tag, r in runs.items()}, seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError("alerts failed its gates")


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
    if "nccl" in name.lower():
        return "collectives (NCCL)"
    if "CatArrayBatchedCopy" in name:
        return "concatenation"
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
    K2 launches of the 13 counted steps, their losses and the global
    gradient norm after the first."""
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
    losses = [float(step(ids, ids)["loss"])]
    grad1 = grad_norm(model)
    losses += [float(step(ids, ids)["loss"]) for _ in range(TRAIN["warmup"] - 1)]
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
    emit(phase="train", ok=ok, ids=[b, s], amp_level="O2", losses=losses,
         grad_norm_step1=grad1, attention_core=picked,
         launches=launches, launches_per_step=per_step, seconds=seconds, ms_per_step=ms_per_step,
         tokens_per_s=b * s * TRAIN["steps"] / seconds,
         max_memory_allocated=peak, model_flops_per_step=_model_flops_per_step(cfg, b, s),
         model_flops_bound_ms=bound_ms, bound_share=bound_ms / ms_per_step, profile=breakdown)
    if not ok:
        raise AssertionError("train phase failed")
    return launches, losses, grad1


def grad_norm(model):
    """The global L2 norm of ``model``'s gradients as one process holds
    them. In a world each gradient's squares are weighted by the share of
    the world that holds that piece (a piece split over the groups
    ``nn.clip.norm_groups`` names, tensor-parallel, ZeRO, expert and
    pipeline, is held by ``world / (their sizes' product)`` ranks; the last
    stage's copy of a tied table counts not at all), and one all-reduce
    over the world sums them."""
    import torch.distributed as dist

    from paddle_tpu_torch.nn.clip import norm_groups

    world = dist.get_world_size() if dist.is_initialized() else 1
    total = torch.zeros((), dtype=torch.float64)
    for p in model.parameters():
        if p.grad is None or getattr(p, "pp_tied_copy", False):
            continue
        held_by = world / math.prod(g.nranks for g in norm_groups(p))
        total += p.grad.double().pow(2).sum().cpu() / held_by
    if world > 1:
        dist.all_reduce(total)  # the whole world's (gloo), not a fleet axis
    return math.sqrt(float(total))


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


def _moe_cases(step_rows, ep_rows):
    """(E, cap, D, H, dtype, activation, layer): the main call first, at
    each MoE layer's live rows in ``step_rows`` (``layer`` indexes it), and
    then with every row live (``layer`` None); the owner's call of the ep 2
    step (4 experts) at rank 0's live rows of its first MoE layer
    (``ep_rows``, ``layer`` "ep")."""
    full = (8, 4096, 1024, 4096)  # the GPT-MoE step's call: E, cap, D, H
    cases = [(*full, dt, "gelu", layer) for layer in (*range(len(step_rows)), None)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(len(ep_rows), 4096, 1024, 4096, torch.float32, "gelu", "ep")]
    # H <= 512 (the reference's single-hidden-tile kernels) and a capacity
    # that is no multiple of the 128-row tile
    cases += [(8, 4096, 1024, 512, dt, "gelu", None) for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 1000, 1024, 4096, dt, "gelu", None) for dt in (torch.float32, torch.bfloat16)]
    # ragged in every dimension, and the other activations
    cases += [(3, 77, 200, 328, torch.float32, "relu", None),
              (3, 77, 200, 328, torch.bfloat16, "silu", None)]
    return cases


def phase_moe_kernels(step_rows, ep_rows):
    """K4 and K4b against their plain versions; returns the rows of the main
    path's call ([8 x 4096, 1024] rows, H 4096, f32 gelu) at the first MoE
    layer's live rows in ``step_rows`` (each MoE layer's rows per expert at
    ``moe_train``'s traced step), and the rows of the ep 2 owner's call ([4
    x 4096, 1024], f32) at ``ep_rows``. Every row of xg and dy holds random
    values: past ``rows[e]`` they are junk that the kernels and the plain
    versions must ignore."""
    from paddle_tpu_torch.ops import moe_pallas as mp

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    main, ep_main, failures = {}, {}, []
    for E, cap, D, H, dt, act, layer in _moe_cases(step_rows, ep_rows):
        def rand(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dt)

        args = (rand(E * cap, D), rand(E, D, H, scale=D ** -0.5), rand(E, 1, H, scale=0.1),
                rand(E, H, D, scale=H ** -0.5), rand(E, 1, D, scale=0.1))
        dy = rand(E * cap, D)
        live = ep_rows if layer == "ep" else None if layer is None else step_rows[layer]
        rows = None if live is None else torch.tensor(live, dtype=torch.int32, device="cuda")
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
            if layer == "ep":
                ep_main[K["name"]] = row
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K4/K4b disagree with their plain versions in {failures}")
    return main, ep_main


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
    Returns the kernel launches of the ``pallas_sorted`` run's 7 steps, its
    traced step's live rows per expert in each MoE layer, its losses and its
    global gradient norm after the first step."""
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
    runs, main_launches, step_rows, main_losses, main_grad1 = {}, None, None, None, None
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
            losses = [float(step(ids, ids)["loss"])]
            grad1 = grad_norm(model)
            losses += [float(step(ids, ids)["loss"]) for _ in range(MOE_TRAIN["warmup"] - 1)]
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
        runs[path] = dict(ok=ok, losses=losses, grad_norm_step1=grad1, moe_kernel=picked,
                          launches=launches,
                          launches_per_step=per_step, seconds=seconds, ms_per_step=ms_per_step,
                          tokens_per_s=b * s * MOE_TRAIN["steps"] / seconds,
                          max_memory_allocated=peak, bound_share=bound_ms / ms_per_step,
                          bound_live_share=1e3 * _moe_flops_per_step(cfg, b, s, fill)
                          / PEAK_FLOPS[torch.float32] / ms_per_step,
                          expert_row_fill=fill, expert_rows=layer_rows, profile=breakdown)
        if path == "pallas_sorted":
            main_launches, step_rows, main_losses, main_grad1 = launches, layer_rows, losses, grad1
        del model, step
        torch.cuda.empty_cache()
    ok = all(r["ok"] for r in runs.values())
    emit(phase="moe_train", ok=ok, ids=[b, s], config=MOE_CFG, dtype="float32",
         flops_per_step=flops, flops_bound_ms=bound_ms, **runs)
    if not ok:
        raise AssertionError("moe_train phase failed")
    return main_launches, step_rows, main_losses, main_grad1


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
    # the float16 instances: BERT's call with the f32 padding bias that an
    # auto_cast(float16) step gives it (sdpa casts q, k, v, not the mask),
    # a float16 bias, and GPT's packed call
    cases += [("bert", 16, 512, 12, 12, 64, False, torch.float16, "padding_f32"),
              ("broadcast", 16, 512, 12, 12, 64, False, torch.float16, "broadcast"),
              ("gpt_packed", 8, 1024, 16, 16, 64, True, torch.float16, None)]
    return cases


def _flat_bias(kind, b, s, dtype, gen):
    if kind is None:
        return None
    if kind == "padding":
        return padding_mask(padding_lengths(b, s), s, dtype)
    if kind == "padding_f32":
        return padding_mask(padding_lengths(b, s), s)
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
    it) and those of the float16 instance at BERT's call and GPT's packed
    call."""
    from paddle_tpu_torch.ops import flash_attention_flat as ff

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    main, f16, failures = {}, {}, []
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
        lib_mask = bias if bias is None or bias.dtype == dt else bias.to(dt)  # SDPA: q's dtype
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
            if dt == torch.float16 and name in ("bert", "gpt_packed"):
                f16.setdefault(K["name"], {})[f"{name}_call"] = row
        del out, stats, grads, dout, bias, qkv, q, k, v
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K3/K3b disagree with their plain versions in {failures}")
    return main, f16


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
    return launches, losses, ms_per_step


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


def phase_dp_bert_train(bert_losses, bert_ms):
    """``bert_train``'s step through the distributed layer in a world of one
    over NCCL: ``init_parallel_env()``, ``fleet.init`` (dp 1, AMP O2 bf16 by
    the strategy), ``fleet.distributed_step`` and ``fleet.shard_batch``, the
    same batch and 13 steps. A world-1 all-reduce is a copy and the division
    by 1 exact, so the losses must equal ``bert_train``'s bit for bit. Then
    the reducer's device time (one step with the stream held by a sleep
    kernel while the host enqueues the passes, so the events time the
    device's work alone), one traced step, and the plain ``TrainStep`` of a
    second model from the same seed timed against it in turns (plain, dp,
    dp, plain). Returns the kernel launches of the 13 counted steps."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import DistributedStrategy, fleet, init_parallel_env
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW

    init_parallel_env()
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1}
    strategy.amp = True
    strategy.amp_configs = {"level": "O2", "dtype": "bfloat16"}
    fleet.init(is_collective=True, strategy=strategy)
    backend, world = dist.get_backend(), dist.get_world_size()
    cfg = BertConfig()
    b, s = BERT_TRAIN["batch"], BERT_TRAIN["seq"]
    model = BertForPretraining(cfg, seed=SEED)
    step = fleet.distributed_step(
        model, AdamW(learning_rate=BERT_TRAIN["lr"], parameters=model.parameters()), bert_loss)
    (ids, types, pos, mask), labels, lengths = bert_batch(b, s, cfg.vocab_size)
    ids, types, mask, mlm, nsp = fleet.shard_batch(ids, types, mask, *labels)
    inputs, labels = (ids, types, pos, mask), (mlm, nsp)  # positions are not a batch leaf
    reducer, host_s = step._reducer, []
    reduce = reducer.reduce

    def host_timed_reduce(*args, **kwargs):
        t = time.perf_counter()
        out = reduce(*args, **kwargs)
        host_s.append(time.perf_counter() - t)
        return out

    def timed(run, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            run(inputs, labels)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / n

    reducer.reduce = host_timed_reduce
    registry.clear_cache()
    metrics.reset_counters("kernels.")
    metrics.reset_counters("collective.")
    set_flags({"FLAGS_flash_flat": True})
    try:
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(inputs, labels)["loss"]) for _ in range(BERT_TRAIN["warmup"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed_losses = [step(inputs, labels)["loss"] for _ in range(BERT_TRAIN["steps"])]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        losses += [float(x) for x in timed_losses]
        launches = {k: v - before[k] for k, v in read_launches().items()}
        peak = torch.cuda.max_memory_allocated()
        calls = metrics.counters("collective.")
        reducer.reduce = reduce
        # the reducer's device time: the stream sleeps while the host enqueues
        device_ms = []

        def held_reduce(*args, **kwargs):
            torch.cuda._sleep(DP_HOLD_CYCLES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = reduce(*args, **kwargs)
            end.record()
            device_ms.append((start, end))
            return out

        reducer.reduce = held_reduce
        for _ in range(3):
            step(inputs, labels)
        torch.cuda.synchronize()
        reducer.reduce = reduce
        device_ms = [a.elapsed_time(z) for a, z in device_ms]
        breakdown = profile_step(step, inputs, labels)
        # the plain step of a model from the same seed, timed in turns with it
        plain_model = BertForPretraining(cfg, device="cuda", seed=SEED)
        plain = TrainStep(plain_model, AdamW(learning_rate=BERT_TRAIN["lr"],
                                             parameters=plain_model.parameters()),
                          bert_loss, amp_level="O2")
        for _ in range(BERT_TRAIN["warmup"]):
            plain(inputs, labels)
        turns = {"plain": [], "dp": []}
        for name in ("plain", "dp", "dp", "plain"):
            turns[name].append(timed(plain if name == "plain" else step, BERT_TRAIN["steps"]))
    finally:
        set_flags({"FLAGS_flash_flat": False})
        registry.clear_cache()
        reducer.reduce = reduce
        dist.destroy_process_group()
        fleet._hcg = None  # the later phases run without a fleet
    n_steps = BERT_TRAIN["warmup"] + BERT_TRAIN["steps"]
    per_step = {k: v / n_steps for k, v in launches.items()}
    ms_per_step = 1e3 * seconds / BERT_TRAIN["steps"]
    buckets = len(reducer.buckets)
    bucket_bytes = [sum(p.numel() * p.element_size() for p in ps) for _, ps in reducer.buckets]
    L = cfg.num_layers
    bitwise = losses == bert_losses
    ok = (backend == "nccl" and world == 1 and bitwise and len(host_s) == n_steps
          and per_step == {K1["name"]: 0, K2["name"]: 0, K3["name"]: L, K3B["name"]: L,
                           K4["name"]: 0, K4B["name"]: 0}
          and calls.get("collective.all_reduce.calls") == buckets * n_steps
          and all(p.dtype == torch.float32 for p in model.parameters()))
    emit(phase="dp_bert_train", ok=ok, backend=backend, world_size=world, ids=[b, s],
         amp_level="O2", losses=losses, losses_bitwise_equal_bert_train=bitwise,
         launches=launches, launches_per_step=per_step, collective_calls=calls,
         seconds=seconds, ms_per_step=ms_per_step, bert_train_ms_per_step=bert_ms,
         ms_ratio_to_bert_train=ms_per_step / bert_ms,
         turns_ms_per_step=turns,
         turns_ratio=float(np.mean(turns["dp"]) / np.mean(turns["plain"])),
         tokens_per_s=b * s * BERT_TRAIN["steps"] / seconds,
         nonpad_tokens_per_s=int(np.sum(lengths)) * BERT_TRAIN["steps"] / seconds,
         reducer=dict(buckets=buckets, bytes=sum(bucket_bytes), bucket_bytes=bucket_bytes,
                      device_ms=device_ms,
                      host_ms_per_step=[1e3 * t for t in host_s[BERT_TRAIN["warmup"]:]]),
         max_memory_allocated=peak, profile=breakdown)
    if not ok:
        raise AssertionError("dp_bert_train phase failed")
    return launches


def _dist_bert(layers, device, seed):
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining

    return BertForPretraining(BertConfig(num_layers=layers), device=device, seed=seed)


def _dist_bert_steps(step, inputs, labels):
    """The losses of ``DIST_CHECK["steps"]`` steps through K3/K3b and the
    gradients the first step updated with (averaged over dp; this rank's
    shards at mp)."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import registry

    registry.clear_cache()
    set_flags({"FLAGS_flash_flat": True})
    try:
        losses = [float(step(inputs, labels)["loss"])]
        grads = {n: p.grad.cpu().numpy() for n, p in step.model.named_parameters()}
        losses += [float(step(inputs, labels)["loss"]) for _ in range(DIST_CHECK["steps"] - 1)]
        return losses, grads
    finally:
        set_flags({"FLAGS_flash_flat": False})
        registry.clear_cache()


def _dist_rank_dp():
    """Rank body of ``dist_two_rank`` (a), the SyncBatchNorm check and (b),
    in a gloo world of two processes on ``cuda:0``."""
    from paddle_tpu_torch.distributed import (DataParallel, DistributedStrategy, fleet,
                                              get_rank)
    from paddle_tpu_torch.nn.layer import Linear, SyncBatchNorm
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = get_rank()
    out = {}
    # (a) tests/test_hooks_ddp.py:89-114: ranks feed 1s and 2s, the gradient is 3
    lin = Linear(4, 1, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
    dp = DataParallel(lin)
    dp(torch.full((2, 4), r + 1.0, device="cuda")).sum().backward()
    out["a_grad"] = lin.weight.grad.cpu().numpy()
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    # SyncBatchNorm at dp 2 over this rank's block of the [8, 64, 16, 16] batch
    x, ct = _dist_bn_batch()
    xb, cb = fleet.shard_batch(x, ct)
    bn = SyncBatchNorm(x.shape[1], device="cuda")
    bn_dp = DataParallel(bn)
    xb.requires_grad_()
    y = bn_dp(xb)
    (y * cb).sum().backward()
    out["bn"] = {k: t.detach().cpu().numpy() for k, t in
                 (("out", y), ("dx", xb.grad), ("dw", bn.weight.grad), ("db", bn.bias.grad),
                  ("mean", bn._mean), ("var", bn._variance))}
    # (b) BERT at dp 2 through distributed_step and shard_batch
    model = _dist_bert(DIST_CHECK["layers"], "cuda", SEED + 20)
    step = fleet.distributed_step(
        model, AdamW(learning_rate=DIST_CHECK["lr"], parameters=model.parameters()), bert_loss)
    (ids, types, pos, mask), labels, _ = bert_batch(DIST_CHECK["batch"], DIST_CHECK["seq"],
                                                    model.bert.cfg.vocab_size)
    ids, types, mask, mlm, nsp = fleet.shard_batch(ids, types, mask, *labels)
    out["b_losses"], grads = _dist_bert_steps(step, (ids, types, pos, mask), (mlm, nsp))
    if r == 0:
        out["b_state"] = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
        out["b_grads"] = grads
    return out


def _dist_rank_mp():
    """Rank body of ``dist_two_rank`` (c): BERT at mp 2 (dp 1) in a gloo
    world of two processes on ``cuda:0``; its K3/K3b launches."""
    from paddle_tpu_torch.distributed import DistributedStrategy, fleet
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    model = _dist_bert(DIST_CHECK["layers"], "cuda", SEED + 20)  # this rank's shards
    step = fleet.distributed_step(
        model, AdamW(learning_rate=DIST_CHECK["lr"], parameters=model.parameters()), bert_loss)
    inputs, labels, _ = bert_batch(DIST_CHECK["batch"], DIST_CHECK["seq"],
                                   model.bert.cfg.vocab_size)
    reset_launches()
    losses, grads = _dist_bert_steps(step, inputs, labels)
    return dict(losses=losses, grads=grads, launches=read_launches(),
                heads=model.bert.layers[0].attn.num_heads,
                state={k: v.cpu().numpy() for k, v in model.state_dict().items()})


def _dist_gpt_model(device):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining

    return GPTForPretraining(GPTConfig(**DIST_ZERO3["cfg"]), device=device, seed=SEED + 30)


def _dist_gpt_ids():
    cfg = DIST_ZERO3["cfg"]
    return np.random.default_rng(SEED + 31).integers(
        0, cfg["vocab_size"], (DIST_ZERO3["batch"], DIST_ZERO3["seq"])).astype(np.int32)


def _dist_rank_zero3():
    """Rank body of ``dist_two_rank`` (d): a narrow GPT at sdp 2 with ZeRO
    stage 3 (``group_sharded_parallel(level="p_g_os")``) through
    ``distributed_step`` and ``shard_batch``; the losses, this rank's
    blocks and their split dims, and its K1/K2 launches."""
    from paddle_tpu_torch.distributed import (DistributedStrategy, fleet, group_sharded_parallel,
                                              state_shardings)
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "sharding_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    model = _dist_gpt_model("cuda")
    opt = AdamW(learning_rate=DIST_ZERO3["lr"], parameters=model.parameters())
    model, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    step = fleet.distributed_step(model, opt, GPTPretrainingCriterion())
    x = fleet.shard_batch(_dist_gpt_ids())
    reset_launches()
    losses = [float(step(x, x)["loss"]) for _ in range(DIST_ZERO3["steps"])]
    return dict(losses=losses, sdp_rank=hcg.get_sharding_parallel_rank(),
                state={k: v.cpu().numpy() for k, v in model.state_dict().items()},
                sdp_dims=state_shardings(model, hcg), launches=read_launches(),
                split=len(step._zero.split))


def _dist_rank_mp_ernie():
    """Rank body of ``dist_two_rank`` (e): a narrow ERNIE at mp 2 (its heads
    split, the word table's vocabulary halved) over the whole batch; the
    losses, this rank's shards and its K1/K2 launches."""
    from paddle_tpu_torch.distributed import DistributedStrategy, fleet
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    model = ErnieForPretraining(ErnieConfig(**DIST_ERNIE["cfg"]), device="cuda", seed=SEED + 32)
    step = fleet.distributed_step(
        model, AdamW(learning_rate=DIST_ERNIE["lr"], parameters=model.parameters()), ernie_loss)
    inputs, labels = ernie_batch(DIST_ERNIE["batch"], DIST_ERNIE["seq"],
                                 DIST_ERNIE["cfg"]["vocab_size"])
    reset_launches()
    losses = [float(step(inputs, labels)["loss"]) for _ in range(DIST_ERNIE["steps"])]
    return dict(losses=losses, heads=model.ernie.layers[0].attn.num_heads,
                state={k: v.cpu().numpy() for k, v in model.state_dict().items()},
                launches=read_launches())


def _one_process_steps(model, inputs, labels, loss_fn, lr, steps):
    """One process's f32 AdamW steps on the whole batch: the losses, the
    state after them and the names of the parameters that start at 0."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    zero_init = {n for n, p in model.named_parameters() if not bool(p.any())}
    step = TrainStep(model, AdamW(learning_rate=lr, parameters=model.parameters()), loss_fn)
    losses = [float(step(inputs, labels)["loss"]) for _ in range(steps)]
    return losses, {k: v.cpu().numpy() for k, v in model.state_dict().items()}, zero_init


def _held(losses_by_rank, state, ref_losses, ref_state, zero_init, lr, steps):
    """``DIST_CHECK_TOL`` on whole steps: each rank's losses, and each
    parameter after them (those that start at 0 within the steps' reach,
    2 lr a step)."""
    tol = DIST_CHECK_TOL
    loss_err = max(abs(a - b) / abs(b) for losses in losses_by_rank
                   for a, b in zip(losses, ref_losses))
    rel = _rel_l2(state, ref_state)
    held = {n: e for n, e in rel.items() if n not in zero_init}
    reach = max(float(np.abs(state[n] - ref_state[n]).max()) for n in zero_init)
    worst = max(held, key=held.get)
    ok = (set(state) == set(ref_state) and loss_err <= tol["loss_rtol"]
          and held[worst] <= tol["param_rel_l2"] and reach <= 2 * lr * steps)
    return ok, dict(losses=losses_by_rank[0], ref_losses=ref_losses, loss_rel_err=loss_err,
                    param_worst=worst, param_rel_l2_worst=held[worst], zero_init_abs_max=reach)


def phase_dist_zero3_ernie():
    """``dist_two_rank`` (d) and (e), two gloo processes on ``cuda:0`` each,
    held against one process's steps on the same card: (d) a narrow GPT
    (h 1024, 4 layers, 16 heads, vocab 50304) f32 at sdp 2 with ZeRO stage 3
    (parameters held as blocks, gathered layer by layer), ids ``[4, 512]``;
    (e) a narrow ERNIE (h 768, 2 layers, 12 heads, vocab 40000) f32 at mp 2,
    ids ``[8, 256]``; 3 AdamW steps each. K1 and K2 launched once a layer
    and step on every rank."""
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.testing.dist import run_ranks
    from paddle_tpu_torch.utils.convert import gather_state

    t0 = time.perf_counter()
    ids = torch.from_numpy(_dist_gpt_ids()).cuda()
    ref = _one_process_steps(_dist_gpt_model("cuda"), ids, ids, GPTPretrainingCriterion(),
                             DIST_ZERO3["lr"], DIST_ZERO3["steps"])
    t_ref = time.perf_counter() - t0
    d_out = run_ranks(_dist_rank_zero3, 2, device="cuda:0", backend="gloo",
                      timeout=DIST_CHECK["timeout"])
    t_d = time.perf_counter() - t0 - t_ref
    d_state = gather_state({(0, o["sdp_rank"], 0): o["state"] for o in d_out},
                           sdp_dims=d_out[0]["sdp_dims"])
    d_ok, d_report = _held([o["losses"] for o in d_out], d_state, *ref, DIST_ZERO3["lr"],
                           DIST_ZERO3["steps"])
    L, steps = DIST_ZERO3["cfg"]["num_layers"], DIST_ZERO3["steps"]
    d_launch_ok = all(o["launches"][K1["name"]] == o["launches"][K2["name"]] == L * steps
                      and o["split"] > 0 for o in d_out)
    del ids
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cfg = ErnieConfig(**DIST_ERNIE["cfg"])
    inputs, labels = ernie_batch(DIST_ERNIE["batch"], DIST_ERNIE["seq"], cfg.vocab_size)
    ref = _one_process_steps(ErnieForPretraining(cfg, device="cuda", seed=SEED + 32), inputs,
                             labels, ernie_loss, DIST_ERNIE["lr"], DIST_ERNIE["steps"])
    e_out = run_ranks(_dist_rank_mp_ernie, 2, device="cuda:0", backend="gloo",
                      timeout=DIST_CHECK["timeout"])
    t_e = time.perf_counter() - t1
    e_ok, e_report = _held([o["losses"] for o in e_out], gather_state([o["state"] for o in e_out],
                                                                      cfg),
                           *ref, DIST_ERNIE["lr"], DIST_ERNIE["steps"])
    L, steps = cfg.num_layers, DIST_ERNIE["steps"]
    e_launch_ok = all(o["launches"][K1["name"]] == o["launches"][K2["name"]] == L * steps
                      and o["heads"] == cfg.num_heads // 2 for o in e_out)
    ok = d_ok and d_launch_ok and e_ok and e_launch_ok
    emit(phase="dist_two_rank_de", ok=ok, backend="gloo", device="cuda:0", world_size=2,
         d_zero3_sdp2=dict(ok=d_ok and d_launch_ok, split_parameters=d_out[0]["split"],
                           launches=[{k: o["launches"][k] for k in (K1["name"], K2["name"])}
                                     for o in d_out], **d_report),
         e_ernie_mp2=dict(ok=e_ok and e_launch_ok, heads_per_rank=e_out[0]["heads"],
                          launches=[{k: o["launches"][k] for k in (K1["name"], K2["name"])}
                                    for o in e_out], **e_report),
         **DIST_CHECK_TOL, seconds=dict(reference_d=t_ref, d=t_d, e=t_e))
    if not ok:
        raise AssertionError("dist_two_rank (d)/(e) failed")


def _dist_bn_batch():
    gen = np.random.default_rng(SEED + 21)
    x = (2 * gen.standard_normal(DIST_CHECK["bn_shape"]) + 0.5).astype(np.float32)
    ct = gen.standard_normal(DIST_CHECK["bn_shape"]).astype(np.float32)
    return x, ct


def _rel_l2(got, want):
    return {n: float(np.linalg.norm(got[n] - w) / max(np.linalg.norm(w), 1e-30))
            for n, w in want.items()}


def phase_dist_two_rank():
    """Two gloo processes on ``cuda:0`` (NCCL refuses two ranks on one
    device): (a) the reference test's eager DataParallel check; a
    SyncBatchNorm at dp 2 against BatchNorm2D over the whole batch; (b)
    BERT at full width, 2 layers, f32 (TF32 off), ``[16, 512]`` global, at
    dp 2 through ``distributed_step`` and ``shard_batch``, and (c) at mp 2,
    each against one process's full-batch step on the same card."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.layer import BatchNorm2D
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing.dist import run_ranks
    from paddle_tpu_torch.utils.convert import gather_state

    t0 = time.perf_counter()
    # the references, in this process on the card
    x, ct = _dist_bn_batch()
    bn = BatchNorm2D(x.shape[1], device="cuda")
    xt = torch.from_numpy(x).cuda().requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(ct).cuda()).sum().backward()
    bn_ref = {k: t.detach().cpu().numpy() for k, t in
              (("out", y), ("dx", xt.grad), ("dw", bn.weight.grad), ("db", bn.bias.grad),
               ("mean", bn._mean), ("var", bn._variance))}
    model = _dist_bert(DIST_CHECK["layers"], "cuda", SEED + 20)
    zero_init = {n for n, p in model.named_parameters() if not bool(p.any())}
    step = TrainStep(model, AdamW(learning_rate=DIST_CHECK["lr"], parameters=model.parameters()),
                     bert_loss)
    inputs, labels, _ = bert_batch(DIST_CHECK["batch"], DIST_CHECK["seq"], model.bert.cfg.vocab_size)
    ref_losses, ref_grads = _dist_bert_steps(step, inputs, labels)
    ref_state = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    cfg = model.bert.cfg
    del model, step, inputs, labels
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    dp_out = run_ranks(_dist_rank_dp, 2, device="cuda:0", backend="gloo",
                       timeout=DIST_CHECK["timeout"])
    t_dp = time.perf_counter() - t0 - t_ref
    mp_out = run_ranks(_dist_rank_mp, 2, device="cuda:0", backend="gloo",
                       timeout=DIST_CHECK["timeout"])
    t_mp = time.perf_counter() - t0 - t_ref - t_dp
    tol = DIST_CHECK_TOL
    a_ok = all(np.array_equal(o["a_grad"], np.full((4, 1), 3.0, np.float32)) for o in dp_out)
    bn_err = {k: max(float(np.abs(o["bn"][k] - (want[rows] if k in ("out", "dx") else
                                                   want / 2 if k in ("dw", "db") else want)).max())
                     for o, rows in zip(dp_out, (slice(0, 4), slice(4, 8))))
              for k, want in bn_ref.items()}
    bn_ok = all(e <= tol["bn_atol"] + tol["bn_rtol"] * float(np.abs(bn_ref[k]).max())
                for k, e in bn_err.items())

    def agree(losses_by_rank, grads, state):
        loss_err = max(abs(a - b) / abs(b) for losses in losses_by_rank
                       for a, b in zip(losses, ref_losses))
        grad_rel, rel = _rel_l2(grads, ref_grads), _rel_l2(state, ref_state)
        held = {n: e for n, e in rel.items() if n not in zero_init}
        reach = max(float(np.abs(state[n] - ref_state[n]).max()) for n in zero_init)
        ok = (loss_err <= tol["loss_rtol"] and max(grad_rel.values()) <= tol["grad_rel_l2"]
              and max(held.values()) <= tol["param_rel_l2"]
              and reach <= 2 * DIST_CHECK["lr"] * DIST_CHECK["steps"])
        worst_g, worst = max(grad_rel, key=grad_rel.get), max(held, key=held.get)
        return ok, dict(losses=losses_by_rank[0], loss_rel_err=loss_err, grad_worst=worst_g,
                        grad_rel_l2_worst=grad_rel[worst_g], param_worst=worst,
                        param_rel_l2_worst=held[worst],
                        zero_init_rel_l2={n: rel[n] for n in sorted(zero_init)},
                        zero_init_abs_max=reach)

    b_ok, b_report = agree([o["b_losses"] for o in dp_out], dp_out[0]["b_grads"],
                           dp_out[0]["b_state"])
    c_ok, c_report = agree([o["losses"] for o in mp_out],
                           gather_state([o["grads"] for o in mp_out], cfg),
                           gather_state([o["state"] for o in mp_out], cfg))
    steps = DIST_CHECK["steps"]
    c_launch_ok = all(o["launches"][K3["name"]] == cfg.num_layers * steps
                      and o["launches"][K3B["name"]] == cfg.num_layers * steps and o["heads"] == 6
                      for o in mp_out)
    ok = a_ok and bn_ok and b_ok and c_ok and c_launch_ok
    emit(phase="dist_two_rank", ok=ok, backend="gloo", device="cuda:0", world_size=2,
         a_dp_grad_exact_3=a_ok, sync_bn=dict(ok=bn_ok, shape=list(x.shape), max_abs_err=bn_err),
         ref_losses=ref_losses, b_dp2=dict(ok=b_ok, **b_report),
         c_mp2=dict(ok=c_ok and c_launch_ok, heads_per_rank=mp_out[0]["heads"],
                    launches=[{k: o["launches"][k] for k in (K3["name"], K3B["name"])}
                              for o in mp_out], **c_report),
         **tol, seconds=dict(reference=t_ref, dp2=t_dp, mp2=t_mp))
    if not ok:
        raise AssertionError("dist_two_rank phase failed")


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
    return launches, losses[:GPT3_TRAIN["warmup"] + GPT3_TRAIN["steps"]], ms_per_step


def _wrap_zero_pass(zero, wrap):
    """Puts ``wrap(name, method)`` in front of ``zero.reduce`` and
    ``zero.gather`` (the sharding layer's pass around the update); returns
    a function that takes the wrappers away again (the class's methods,
    so no bound method is left in a cycle holding the plan's tensors)."""
    for name in ("reduce", "gather"):
        setattr(zero, name, wrap(name, getattr(zero, name)))

    def restore():
        for name in ("reduce", "gather"):
            zero.__dict__.pop(name, None)

    return restore


def _zero_step_timers(zero):
    """Records the host seconds of the sharding layer's pass; returns the
    records and the function that restores the pass."""
    host = {"reduce": [], "gather": []}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            host[name].append(time.perf_counter() - t)
            return out
        return run

    return host, _wrap_zero_pass(zero, timed)


def phase_zero_gpt3_train(gpt3_losses, gpt3_ms):
    """``gpt3_1p3b_train``'s step through the distributed layer with ZeRO
    stage 2, in a world of one over NCCL: ``init_parallel_env()``,
    ``fleet.init`` (sharding stage 2, AMP O2 bf16 and 2 accumulated
    micro-batches by the strategy), ``fleet.distributed_step`` and
    ``fleet.shard_batch``, the same batch and 8 steps from the same seed.
    At sdp 1 every parameter stays whole (the plan splits none) and a
    one-rank all-reduce and a division by 1 are exact, so the losses must
    equal ``gpt3_1p3b_train``'s bit for bit, with 96 K1 and 48 K2 launches
    a step. Then the sharding layer's device time (the stream held by a
    sleep kernel while the host enqueues its passes) and host time, and a
    plain ``TrainStep`` over the same model (its own AdamW) timed in turns
    with it (plain, zero, zero, plain). Returns the kernel launches of the 8
    counted steps, the peak device memory of those steps and their ms a
    step."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import DistributedStrategy, fleet, init_parallel_env
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW

    init_parallel_env()
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "sharding_degree": 1}
    strategy.sharding = True
    strategy.sharding_configs = {"sharding_stage": 2}
    strategy.amp = True
    strategy.amp_configs = {"level": "O2", "dtype": "bfloat16"}
    strategy.pipeline_configs = {"accumulate_steps": GPT3_TRAIN["accumulate"]}
    fleet.init(is_collective=True, strategy=strategy)
    backend, world = dist.get_backend(), dist.get_world_size()
    cfg = GPTConfig.gpt3_1p3b(recompute=True, recompute_granularity="selective")
    b, s = GPT3_TRAIN["batch"], GPT3_TRAIN["seq"]
    n_steps = GPT3_TRAIN["warmup"] + GPT3_TRAIN["steps"]
    model = GPTForPretraining(cfg, seed=SEED)
    step = fleet.distributed_step(
        model, AdamW(learning_rate=GPT3_TRAIN["lr"], parameters=model.parameters()),
        GPTPretrainingCriterion())
    ids = fleet.shard_batch(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s))
                            .astype(np.int32))
    zero = step._zero
    host, restore = _zero_step_timers(zero)

    def timed(run, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            run(ids, ids)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / n

    registry.clear_cache()
    metrics.reset_counters("kernels.")
    metrics.reset_counters("collective.")
    try:
        before = read_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(ids, ids)["loss"]) for _ in range(GPT3_TRAIN["warmup"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed_losses = [step(ids, ids)["loss"] for _ in range(GPT3_TRAIN["steps"])]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        losses += [float(x) for x in timed_losses]
        launches = {k: v - before[k] for k, v in read_launches().items()}
        peak = torch.cuda.max_memory_allocated()
        calls = metrics.counters("collective.")
        picked = metrics.counters("kernels.attention_core.")
        restore()
        # the sharding layer's device time: the stream sleeps while the host enqueues
        device = {"reduce": [], "gather": []}

        def held(name, fn):
            def run(*args, **kwargs):
                torch.cuda._sleep(DP_HOLD_CYCLES)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                device[name].append((start, end))
                return out
            return run

        unheld = _wrap_zero_pass(zero, held)
        for _ in range(3):
            step(ids, ids)
        torch.cuda.synchronize()
        unheld()
        device = {k: [a.elapsed_time(z) for a, z in v] for k, v in device.items()}
        # a plain TrainStep over the same model (its own AdamW), in turns
        plain = TrainStep(model, AdamW(learning_rate=GPT3_TRAIN["lr"],
                                       parameters=model.parameters()),
                          GPTPretrainingCriterion(), amp_level="O2",
                          accumulate_steps=GPT3_TRAIN["accumulate"])
        plain(ids, ids)
        turns = {"plain": [], "zero": []}
        for name in ("plain", "zero", "zero", "plain"):
            turns[name].append(timed(plain if name == "plain" else step, 3))
        peak_turns = torch.cuda.max_memory_allocated()
    finally:
        restore()
        dist.destroy_process_group()
        fleet._hcg = None  # the later phases run without a fleet
    per_step = {k: v / n_steps for k, v in launches.items()}
    L = cfg.num_layers
    k = GPT3_TRAIN["accumulate"]
    want = {K1["name"]: 2 * L * k, K2["name"]: L * k, K3["name"]: 0, K3B["name"]: 0,
            K4["name"]: 0, K4B["name"]: 0}
    bitwise = losses == gpt3_losses
    ms_per_step = 1e3 * seconds / GPT3_TRAIN["steps"]
    ok = (backend == "nccl" and world == 1 and bitwise and per_step == want
          and zero.stage == 2 and not zero.split
          and len(host["reduce"]) == len(host["gather"]) == n_steps
          and picked == {"kernels.attention_core.picked": 1,
                         "kernels.attention_core.fallback": 0}
          and all(p.dtype == torch.float32 for p in model.parameters()))
    emit(phase="zero_gpt3_train", ok=ok, backend=backend, world_size=world, stage=zero.stage,
         ids=[b, s], amp_level="O2", recompute="selective", accumulate_steps=k,
         split_parameters=len(zero.split), buckets=len(zero._reducer.buckets),
         losses=losses, losses_bitwise_equal_gpt3_train=bitwise, launches=launches,
         launches_per_step=per_step, expected_per_step=want,
         collective_calls_per_step={c: v / n_steps for c, v in calls.items()},
         seconds=seconds, ms_per_step=ms_per_step, gpt3_1p3b_train_ms_per_step=gpt3_ms,
         turns_ms_per_step=turns,
         turns_ratio=float(np.mean(turns["zero"]) / np.mean(turns["plain"])),
         sharding_device_ms=device,
         sharding_host_ms_per_step={name: [1e3 * t for t in v[GPT3_TRAIN["warmup"]:]]
                                    for name, v in host.items()},
         max_memory_allocated=peak, max_memory_allocated_with_plain_step=peak_turns)
    if not ok:
        raise AssertionError("zero_gpt3_train phase failed")
    return launches, peak, ms_per_step


def _hybrid_strategy():
    from paddle_tpu_torch.distributed import DistributedStrategy

    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "sharding_degree": HYBRID["sdp"],
                        "mp_degree": HYBRID["mp"], "pp_degree": HYBRID["pp"]}
    s.sharding = True
    s.sharding_configs = {"sharding_stage": HYBRID["stage"]}
    s.pipeline_configs = {"accumulate_steps": HYBRID["accumulate"],
                          "schedule": HYBRID["schedule"]}
    return s


def _hybrid_rank(path, ids):
    """Rank body of ``hybrid_gpt3``: this rank's part of the GPT-3 1.3B
    (built on the meta device, its slice read from the parent's weights
    file by ``mmap``), two steps of ``fleet.distributed_step`` on its
    block of ``ids``; the losses, seconds, launches, peak memory and the
    collective layer's counters."""
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils.convert import expert_split_names, shard_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    fleet.init(is_collective=True, strategy=_hybrid_strategy())
    hcg = fleet.get_hybrid_communicate_group()
    pp_rank, mp_rank = hcg.get_pipe_parallel_rank(), hcg.get_model_parallel_rank()
    cfg = GPTConfig.gpt3_1p3b(max_seq_len=HYBRID["seq"])
    model = GPTForPretraining(cfg, device="meta")
    model.to_empty(device="cuda")
    full = torch.load(path, mmap=True, weights_only=True)
    part = shard_state(full, mp_rank, HYBRID["mp"], cfg, pp_rank=pp_rank, pp_degree=HYBRID["pp"])
    model.load_state_dict(part)
    del full, part
    n_params = sum(p.numel() for p in model.parameters())
    step = fleet.distributed_step(
        model, AdamW(learning_rate=HYBRID["lr"], parameters=model.parameters()),
        GPTPretrainingCriterion())
    x = fleet.shard_batch(ids)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    registry.clear_cache()
    reset_launches()
    metrics.reset_counters("collective.")
    metrics.reset_counters("kernels.")
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(HYBRID["steps"]):
        t = time.perf_counter()
        losses.append(float(step(x, x)["loss"]))
        step_s.append(time.perf_counter() - t)
    calls = metrics.counters("collective.")
    return dict(coord=hcg.coord, losses=losses, load_seconds=load_s, step_seconds=step_s,
                launches=read_launches(), max_memory_allocated=torch.cuda.max_memory_allocated(),
                params=n_params, split_parameters=len(step._zero.split),
                host_staged_bytes=calls.pop(collective.HOST_STAGED, 0), collective_calls=calls,
                peak_held=step.last_schedule.peak_held, n_micro=step.n_micro,
                picked=metrics.counters("kernels.attention_core."))


def phase_hybrid_gpt3():
    """BASELINE #4 as ``bench_1p3b.py:25-60`` sets it: GPT-3 1.3B at full
    width and depth (``GPTConfig.gpt3_1p3b(max_seq_len=256)``), f32 AdamW
    lr 1e-4, sdp 2 x mp 2 x pp 2 with ZeRO stage 2 and 2 micro-batches
    through ``1f1b``, ids ``[4, 256]`` from ``default_rng(0)`` with labels =
    ids. First the port's plain one-process f32 ``TrainStep`` on the same
    weights and batch (2 steps; the weights are written to a file the
    ranks map), then 8 gloo processes on ``cuda:0`` (NCCL refuses two ranks
    on one device), 2 steps. Every rank's losses within
    ``HYBRID_LOSS_RTOL`` of the plain step's; K1 and K2 launched on every
    rank, 12 layers x 2 micro-batches of each a step; stage s holding at
    most ``pp - s`` micro-batches' inputs. Returns the launches summed over
    the ranks."""
    import gc
    import shutil
    import tempfile
    from pathlib import Path

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing.dist import run_ranks

    # the card is shared with 8 rank processes: what earlier phases left in
    # reference cycles is freed first
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = GPTConfig.gpt3_1p3b(max_seq_len=HYBRID["seq"])
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (HYBRID["batch"], HYBRID["seq"])).astype(np.int32)
    workdir = Path(__file__).resolve().parent / "build"
    workdir.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=workdir, prefix="hybrid_gpt3_"))
    try:
        model = GPTForPretraining(cfg, seed=SEED)
        n_params = sum(p.numel() for p in model.parameters())
        path = tmp / "weights.pt"
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
        t_save = time.perf_counter() - t0
        step = TrainStep(model, AdamW(learning_rate=HYBRID["lr"], parameters=model.parameters()),
                         GPTPretrainingCriterion())
        x = torch.from_numpy(ids).cuda()
        torch.cuda.reset_peak_memory_stats()
        plain_s, plain = [], []
        for _ in range(HYBRID["steps"]):
            t = time.perf_counter()
            plain.append(float(step(x, x)["loss"]))
            plain_s.append(time.perf_counter() - t)
        plain_peak = torch.cuda.max_memory_allocated()
        del model, step, x
        gc.collect()
        torch.cuda.empty_cache()
        parent_allocated = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        world = HYBRID["sdp"] * HYBRID["mp"] * HYBRID["pp"]
        ranks = run_ranks(_hybrid_rank, world, str(path), ids, device="cuda:0", backend="gloo",
                          timeout=HYBRID["timeout"])
        t_world = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    layers = cfg.num_layers // HYBRID["pp"]
    want = {K1["name"]: layers * HYBRID["accumulate"] * HYBRID["steps"],
            K2["name"]: layers * HYBRID["accumulate"] * HYBRID["steps"],
            K3["name"]: 0, K3B["name"]: 0, K4["name"]: 0, K4B["name"]: 0}
    errs = [max(abs(a - b) / abs(b) for a, b in zip(r["losses"], plain)) for r in ranks]
    ok = (all(np.isfinite(r["losses"]).all() for r in ranks)
          and max(errs) <= HYBRID_LOSS_RTOL
          and all(r["launches"] == want for r in ranks)
          and all(r["peak_held"] == HYBRID["pp"] - r["coord"][1] for r in ranks)
          and all(r["picked"] == {"kernels.attention_core.picked": 1,
                                  "kernels.attention_core.fallback": 0} for r in ranks))
    launches = {n: sum(r["launches"][n] for r in ranks) for n in want}
    emit(phase="hybrid_gpt3", ok=ok, backend="gloo", device="cuda:0", world_size=world,
         mesh={k: HYBRID[k] for k in ("sdp", "mp", "pp")}, zero_stage=HYBRID["stage"],
         schedule=HYBRID["schedule"], micro_batches=HYBRID["accumulate"],
         ids=[HYBRID["batch"], HYBRID["seq"]], params=n_params, plain_losses=plain,
         plain_step_seconds=plain_s, plain_max_memory_allocated=plain_peak,
         parent_memory_allocated_with_the_ranks=parent_allocated,
         loss_rel_err_by_rank=errs, loss_rtol=HYBRID_LOSS_RTOL,
         launches_per_rank=want, launches=launches,
         ranks=[{k: r[k] for k in ("coord", "losses", "load_seconds", "step_seconds",
                                   "max_memory_allocated", "params", "split_parameters",
                                   "host_staged_bytes", "collective_calls", "peak_held",
                                   "n_micro")} for r in ranks],
         seconds=dict(save_and_plain=t1 - t0, save=t_save, world=t_world,
                      total=time.perf_counter() - t0))
    if not ok:
        raise AssertionError("hybrid_gpt3 phase failed")
    return launches


def _rank_steps(fleet, model, opt, ids, steps, record=None):
    """``steps`` steps of ``fleet.distributed_step`` on this rank's block of
    ``ids`` (labels = ids), each synchronised and timed, with the launches
    and the collective counters counted over them; ``record`` (a callable
    taking ``True``/``False``) is switched on for the first step, which the
    ms per step leaves out. Returns the losses, step seconds, the global
    gradient norm after the first step, launches, host-staged bytes,
    collective calls and peak memory."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry

    step = fleet.distributed_step(model, opt, GPTPretrainingCriterion())
    x = fleet.shard_batch(ids)
    torch.cuda.synchronize()
    registry.clear_cache()
    reset_launches()
    metrics.reset_counters("collective.")
    metrics.reset_counters("kernels.")
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, grad1 = [], [], None
    for i in range(steps):
        if record is not None:
            record(i == 0)
        t = time.perf_counter()
        losses.append(float(step(x, x)["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        if i == 0:
            grad1 = grad_norm(model)
    calls = metrics.counters("collective.")
    return dict(losses=losses, step_seconds=step_s, grad_norm_step1=grad1,
                launches=read_launches(),
                host_staged_bytes=calls.pop(collective.HOST_STAGED, 0), collective_calls=calls,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                picked=metrics.counters("kernels."), block=list(x.shape))


def _ep_rank(ids):
    """Rank body of ``ep_moe_train``: moe_train's GPT-MoE from the same seed
    under ``fleet.init(dp_degree=2)`` (each rank draws every weight and keeps
    its 4 experts of each MoE layer), 3 f32 AdamW steps on its rows of
    ``ids``; the owner's live rows per expert of each MoE layer in the first
    step."""
    from paddle_tpu_torch.distributed import DistributedStrategy, fleet
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops import moe_pallas as mp
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    strat = DistributedStrategy()
    strat.hybrid_configs = {"dp_degree": EP_MOE["dp"]}
    fleet.init(is_collective=True, strategy=strat)
    hcg = fleet.get_hybrid_communicate_group()
    model = GPTForPretraining(GPTConfig(**MOE_CFG), device="cuda", seed=SEED)
    experts = [tuple(m.w1.shape) for m in model.modules() if hasattr(m, "expert_group")]
    seen, on = [], [False]
    ffn = mp.grouped_ffn

    def recording_ffn(xg, w1, b1, w2, b2, activation="gelu", rows=None):
        if on[0]:
            seen.append(rows.tolist())
        return ffn(xg, w1, b1, w2, b2, activation, rows)

    mp.grouped_ffn = recording_ffn  # the exchange looks it up at each call
    try:
        load_s = time.perf_counter() - t0
        out = _rank_steps(fleet, model, AdamW(learning_rate=MOE_TRAIN["lr"],
                                              parameters=model.parameters()),
                          ids, EP_MOE["steps"], record=lambda last: on.__setitem__(0, last))
    finally:
        mp.grouped_ffn = ffn
    return dict(out, dp_rank=hcg.get_data_parallel_rank(), load_seconds=load_s,
                expert_shapes=experts, owner_rows=seen,
                params=sum(p.numel() for p in model.parameters()))


def phase_ep_moe_train(moe_losses, moe_grad1):
    """moe_train's GPT-MoE at full width at dp 2 = ep 2: two gloo processes
    on ``cuda:0`` (NCCL refuses two ranks on one device), each holding 4 of
    the 8 experts of every MoE layer and ``[4, 1024]`` of moe_train's ids,
    GShard jitter on, 3 f32 AdamW steps. Every rank's losses within
    ``EP_LOSS_RTOL`` of moe_train's first 3 (``moe_losses``: the same
    weights and jitter draws), its global gradient norm after step 1 within
    ``EP_GRAD_RTOL`` of moe_train's (``moe_grad1``); K4 and K4b 4 times a
    step on each rank (one
    per MoE layer, each owner's 4 experts), K1 and K2 8. Returns the
    launches summed over the ranks and rank 0's live rows per expert in its
    first MoE layer."""
    import gc

    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.testing.dist import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    cfg = GPTConfig(**MOE_CFG)
    b, s = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    ids = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 6)).cpu()
    t0 = time.perf_counter()
    ranks = run_ranks(_ep_rank, EP_MOE["dp"], ids, device="cuda:0", backend="gloo",
                      timeout=EP_MOE["timeout"])
    t_world = time.perf_counter() - t0
    steps, n_moe = EP_MOE["steps"], cfg.num_layers // cfg.moe_every
    want = {K1["name"]: cfg.num_layers * steps, K2["name"]: cfg.num_layers * steps,
            K3["name"]: 0, K3B["name"]: 0, K4["name"]: n_moe * steps, K4B["name"]: n_moe * steps}
    ref = moe_losses[:steps]
    errs = [max(abs(a - r) / abs(r) for a, r in zip(o["losses"], ref)) for o in ranks]
    grad_errs = [abs(o["grad_norm_step1"] - moe_grad1) / moe_grad1 for o in ranks]
    E = cfg.moe_num_experts // EP_MOE["dp"]
    ok = (all(np.isfinite(o["losses"]).all() for o in ranks) and max(errs) <= EP_LOSS_RTOL
          and max(grad_errs) <= EP_GRAD_RTOL
          and all(o["launches"] == want for o in ranks)
          and all(o["picked"].get("kernels.moe.picked") == 1
                  and o["picked"].get("kernels.moe.fallback", 0) == 0 for o in ranks)
          and all(shape[0] == E for o in ranks for shape in o["expert_shapes"])
          and all(len(o["owner_rows"]) == n_moe and all(len(r) == E for r in o["owner_rows"])
                  for o in ranks))
    per_step = lambda o: {k: v / steps for k, v in o["launches"].items()}  # noqa: E731
    emit(phase="ep_moe_train", ok=ok, backend="gloo", device="cuda:0", world_size=EP_MOE["dp"],
         ids=[b, s], config=MOE_CFG, dtype="float32", experts_per_rank=E,
         reference_losses=ref, loss_rel_err_by_rank=errs, loss_rtol=EP_LOSS_RTOL,
         reference_grad_norm_step1=moe_grad1, grad_norm_rel_err_by_rank=grad_errs,
         grad_norm_rtol=EP_GRAD_RTOL,
         launches_per_rank_per_step=[per_step(o) for o in ranks],
         ranks=[dict(dp_rank=o["dp_rank"], losses=o["losses"],
                     grad_norm_step1=o["grad_norm_step1"], step_seconds=o["step_seconds"],
                     ms_per_step=1e3 * float(np.mean(o["step_seconds"][1:])),
                     host_staged_bytes_per_step=o["host_staged_bytes"] / steps,
                     collective_calls_per_step={k: v / steps
                                                for k, v in o["collective_calls"].items()},
                     max_memory_allocated=o["max_memory_allocated"], params=o["params"],
                     load_seconds=o["load_seconds"], block=o["block"],
                     owner_live_rows_per_expert=o["owner_rows"]) for o in ranks],
         world_seconds=t_world)
    if not ok:
        raise AssertionError("ep_moe_train phase failed")
    launches = {n: sum(o["launches"][n] for o in ranks) for n in want}
    return launches, ranks[0]["owner_rows"][0]


def _sep_rank(ids):
    """Rank body of ``sep_gpt_train``: train's GPT from the same seed under
    ``fleet.init(sep_degree=2)`` with AMP O2, 3 AdamW steps on its block of
    the sequence."""
    from paddle_tpu_torch.distributed import DistributedStrategy, fleet
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    strat = DistributedStrategy()
    strat.hybrid_configs = {"sep_degree": SEP_GPT["sep"]}
    strat.amp = True
    strat.amp_configs = {"level": "O2", "dtype": "bfloat16"}
    fleet.init(is_collective=True, strategy=strat)
    hcg = fleet.get_hybrid_communicate_group()
    model = GPTForPretraining(GPTConfig(**SERVE_CFG), device="cuda", seed=SEED)
    load_s = time.perf_counter() - t0
    out = _rank_steps(fleet, model, AdamW(learning_rate=TRAIN["lr"],
                                          parameters=model.parameters()), ids, SEP_GPT["steps"])
    return dict(out, sep_rank=hcg.get_sep_parallel_rank(), load_seconds=load_s,
                heads=model.gpt.layers.num_heads // SEP_GPT["sep"])


def phase_sep_gpt_train(train_losses, train_grad1):
    """train's O2 GPT at full width at sep 2 through Ulysses: two gloo
    processes on ``cuda:0``, each holding ``[8, 512]`` of train's ids (its
    block of the sequence), 3 AdamW steps. Every rank's losses within
    ``SEP_LOSS_RTOL`` of train's first 3 (``train_losses``: the same
    weights), its global gradient norm after step 1 within ``SEP_GRAD_RTOL``
    of train's (``train_grad1``); K1 and K2 16 times a step on each rank, at ``SEP_CALL`` (8 of
    the 16 heads over the whole sequence). Returns the launches summed over
    the ranks."""
    import gc

    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.testing.dist import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    cfg = GPTConfig(**SERVE_CFG)
    b, s = TRAIN["batch"], TRAIN["seq"]
    ids = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 2)).cpu()
    t0 = time.perf_counter()
    ranks = run_ranks(_sep_rank, SEP_GPT["sep"], ids, device="cuda:0", backend="gloo",
                      timeout=SEP_GPT["timeout"])
    t_world = time.perf_counter() - t0
    steps = SEP_GPT["steps"]
    want = {K1["name"]: cfg.num_layers * steps, K2["name"]: cfg.num_layers * steps,
            K3["name"]: 0, K3B["name"]: 0, K4["name"]: 0, K4B["name"]: 0}
    ref = train_losses[:steps]
    errs = [max(abs(a - r) / abs(r) for a, r in zip(o["losses"], ref)) for o in ranks]
    grad_errs = [abs(o["grad_norm_step1"] - train_grad1) / train_grad1 for o in ranks]
    ok = (all(np.isfinite(o["losses"]).all() for o in ranks) and max(errs) <= SEP_LOSS_RTOL
          and max(grad_errs) <= SEP_GRAD_RTOL
          and all(o["launches"] == want for o in ranks)
          and all(o["heads"] == SEP_CALL[2] and o["block"] == [b, s // SEP_GPT["sep"]]
                  for o in ranks)
          and all(o["picked"].get("kernels.attention_core.picked") == 1
                  and o["picked"].get("kernels.attention_core.fallback", 0) == 0 for o in ranks))
    emit(phase="sep_gpt_train", ok=ok, backend="gloo", device="cuda:0",
         world_size=SEP_GPT["sep"], ids=[b, s], config=SERVE_CFG, amp_level="O2",
         attention_call=list(SEP_CALL), reference_losses=ref, loss_rel_err_by_rank=errs,
         loss_rtol=SEP_LOSS_RTOL, reference_grad_norm_step1=train_grad1,
         grad_norm_rel_err_by_rank=grad_errs, grad_norm_rtol=SEP_GRAD_RTOL,
         launches_per_rank_per_step=[{k: v / steps for k, v in o["launches"].items()}
                                     for o in ranks],
         ranks=[dict(sep_rank=o["sep_rank"], losses=o["losses"],
                     grad_norm_step1=o["grad_norm_step1"], step_seconds=o["step_seconds"],
                     ms_per_step=1e3 * float(np.mean(o["step_seconds"][1:])),
                     host_staged_bytes_per_step=o["host_staged_bytes"] / steps,
                     collective_calls_per_step={k: v / steps
                                                for k, v in o["collective_calls"].items()},
                     max_memory_allocated=o["max_memory_allocated"],
                     load_seconds=o["load_seconds"], block=o["block"]) for o in ranks],
         world_seconds=t_world)
    if not ok:
        raise AssertionError("sep_gpt_train phase failed")
    return {n: sum(o["launches"][n] for o in ranks) for n in want}


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


def _vision_macs(model, size):
    """Multiply-adds of one image's forward through ``model``'s convolutions
    and ``Linear`` layers, from their shapes (one eval forward at batch 1
    with hooks): ``(all, the first convolution's)``. A convolution's are
    its output's elements times ``in / groups * kh * kw``."""
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
    first = next(v for m, v in macs.items() if isinstance(m, Conv2D))  # in call order
    return sum(macs.values()), first


def _vision_flops_per_step(model, batch, size):
    """Model flops of one training step: 2 per multiply-add forward and 4
    backward (input and weight gradients), without the first convolution's
    input gradient, which nothing needs."""
    macs, stem = _vision_macs(model, size)
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
    flops = _vision_flops_per_step(model, b, size)
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


def _zoo_model(name, device, **kwargs):
    from paddle_tpu_torch.vision import models

    return getattr(models, name)(num_classes=ZOO_TRAIN["classes"], device=device, **kwargs)


def phase_vision_zoo_train():
    """Each model of ``ZOO`` trained on the card as ``resnet50_train`` trains
    ResNet50 (``ZOO_TRAIN``): the losses finite, the batch norms' running
    buffers finite and moved, the parameters and buffers f32, no K1-K4b
    launch. Reports each model's ms a step, images/s, peak memory, the
    traced step's top device kernels and its model-flops bound share.
    Returns the K1-K4b launches of every counted step (none)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.layer import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum

    b = ZOO_TRAIN["batch"]
    rows, ok, t_phase = {}, True, time.perf_counter()
    reset_launches()
    for name, size in ZOO:
        model = _zoo_model(name, "cuda", seed=SEED)
        n_params = sum(p.numel() for p in model.parameters())
        step = TrainStep(model, Momentum(learning_rate=ZOO_TRAIN["lr"],
                                         parameters=model.parameters()),
                         CrossEntropyLoss(), amp_level="O2")
        x = torch.from_numpy(np.random.default_rng(0).normal(size=(b, 3, size, size))
                             .astype(np.float32)).to("cuda")
        y = torch.from_numpy(np.random.default_rng(1).integers(0, ZOO_TRAIN["classes"], (b,))
                             .astype(np.int64)).to("cuda")
        flops = _vision_flops_per_step(model, b, size)
        start = _batch_norm_buffers(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(x, y)["loss"]) for _ in range(ZOO_TRAIN["warmup"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = [step(x, y)["loss"] for _ in range(ZOO_TRAIN["steps"])]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        losses += [float(v) for v in timed]
        peak = torch.cuda.max_memory_allocated()
        after = _batch_norm_buffers(model)
        breakdown = profile_step(step, x, y)  # outside the counted steps
        ms = 1e3 * seconds / ZOO_TRAIN["steps"]
        bound_ms = 1e3 * flops / PEAK_FLOPS[torch.bfloat16]
        moved = all(torch.isfinite(v).all() and not torch.equal(v, start[n])
                    for n, v in after.items())
        f32 = (all(p.dtype == torch.float32 for p in model.parameters())
               and all(v.dtype == torch.float32 for v in after.values()))
        row_ok = bool(all(np.isfinite(losses)) and moved and f32)
        ok = ok and row_ok
        rows[name] = dict(ok=row_ok, images=[b, 3, size, size], params=n_params, losses=losses,
                          losses_fell=losses[-1] < losses[0], batch_norm_buffers=len(after),
                          buffers_finite_and_moved=bool(moved), ms_per_step=ms,
                          images_per_s=b * ZOO_TRAIN["steps"] / seconds,
                          max_memory_allocated=peak, model_flops_per_step=flops,
                          model_flops_bound_ms=bound_ms, bound_share=bound_ms / ms,
                          profile=breakdown and dict(
                              breakdown, top_kernels_ms=dict(list(
                                  breakdown["top_kernels_ms"].items())[:6])),
                          device_busy_share_of_timed_step=breakdown and
                          breakdown["device_busy_ms"] / ms)
        del model, step, x, y
        torch.cuda.empty_cache()
    launches = read_launches()
    ok = ok and all(v == 0 for v in launches.values())
    emit(phase="vision_zoo_train", ok=ok, amp_level="O2", layout="NCHW", models=rows,
         launches=launches, seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError("vision_zoo_train phase failed")
    return launches


def _zoo_state(name):
    """A model's state drawn on the CPU (``ZOO_CHECK``'s seed), with its
    running statistics drawn too."""
    model = _zoo_model(name, "cpu", seed=ZOO_CHECK["seed"])
    rng = np.random.default_rng(ZOO_CHECK["seed"])
    state = {}
    for n, v in model.state_dict().items():
        if n.endswith("._mean"):
            v = torch.from_numpy((0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
        elif n.endswith("._variance"):
            v = torch.from_numpy(rng.uniform(0.5, 1.5, tuple(v.shape)).astype(np.float32))
        state[n] = v.clone()
    return state


def _zoo_run_on(name, device, state, x, y, control=False):
    """The eval logits and one f32 Momentum step of ``name`` on ``device``
    from ``state`` (dropout at p 0), all on the CPU in float64: ``(eval
    logits, loss, train-mode logits, gradients, running buffers after)``.
    ``control`` scales the first batch norm's running variance first, or
    in a model without batch norms its first weight."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.layer import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum

    model = _zoo_model(name, device)
    model.load_state_dict(state)
    if control:  # the first running variance, or without one the first weight, scaled
        var = [b for n, b in model.named_buffers() if n.endswith("._variance")]
        with torch.no_grad():
            (var[0] if var else next(model.parameters())).mul_(
                ZOO_CHECK["control_scale"] if var else ZOO_CHECK["control_weight_scale"])
    for m in model.modules():
        if type(m).__name__ == "Dropout":
            m.p = 0.0
    xs, ys = x.to(device), y.to(device)
    with torch.no_grad():
        logits = model.eval()(xs).to("cpu", torch.float64)
    model.train()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = TrainStep(model, Momentum(learning_rate=ZOO_CHECK["lr"], parameters=model.parameters()),
                     CrossEntropyLoss(), return_outputs=True)
    out = step(xs, ys)
    grads = {n: ((before[n] - p.detach()) / ZOO_CHECK["lr"]).to("cpu", torch.float64)
             for n, p in model.named_parameters()}
    buffers = {n: v.to("cpu", torch.float64) for n, v in _batch_norm_buffers(model).items()}
    return (logits, float(out["loss"]), out["outputs"].detach().to("cpu", torch.float64), grads,
            buffers)


def phase_vision_zoo_check():
    """Each model of ``ZOO`` on the card against the CPU (``ZOO_CHECK``,
    ``ZOO_CHECK_TOL``), and the control that must fail the eval gate."""
    b = ZOO_CHECK["batch"]
    results, ok, t_phase = {}, True, time.perf_counter()
    tol = ZOO_CHECK_TOL
    for i, (name, size) in enumerate(ZOO):
        rng = np.random.default_rng(ZOO_CHECK["seed"] + 1 + i)
        x = torch.from_numpy(rng.normal(size=(b, 3, size, size)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, ZOO_TRAIN["classes"], (b,)).astype(np.int64))
        state = _zoo_state(name)
        card = _zoo_run_on(name, "cuda", state, x, y)
        host = _zoo_run_on(name, "cpu", state, x, y)
        control = _zoo_run_on(name, "cuda", state, x, y, control=True)

        def rel(a, b):
            return float((a - b).norm() / b.norm())

        g_card = torch.cat([g.reshape(-1) for g in card[3].values()])
        g_host = torch.cat([host[3][n].reshape(-1) for n in card[3]])
        row = dict(eval_rel_l2=rel(card[0], host[0]), loss_rel=abs(card[1] - host[1]) / abs(host[1]),
                   train_rel_l2=rel(card[2], host[2]), grad_rel_l2=rel(g_card, g_host),
                   buffers_max_abs_err=max([float((card[4][n] - host[4][n]).abs().max())
                                            for n in host[4]] or [0.0]),
                   control_eval_rel_l2=rel(control[0], host[0]), images=[b, 3, size, size])
        row["ok"] = (row["eval_rel_l2"] <= tol["eval_rel_l2"] and row["loss_rel"] <= tol["loss_rtol"]
                     and row["train_rel_l2"] <= tol["train_rel_l2"]
                     and row["grad_rel_l2"] <= tol["grad_rel_l2"]
                     and row["buffers_max_abs_err"] <= tol["buffers_atol"]
                     and math.isfinite(card[1]))
        row["control_failed_the_gate"] = row["control_eval_rel_l2"] > tol["eval_rel_l2"]
        ok = ok and row["ok"] and row["control_failed_the_gate"]
        results[name] = row
    emit(phase="vision_zoo_check", ok=ok, tol=tol, models=results,
         tf32=torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32,
         seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError("vision_zoo_check phase failed: the card's zoo and the CPU's disagree")


def _nn_api_cases():
    """``(name, fn(F, L, *inputs) -> output, input shapes, dtype)``: the
    functions and layers of the nn library's second half, with
    ``ceil_mode``, masks through ``max_unpool*``, channel-last layouts and
    the transposed convolutions at dilation 2 and ``groups=2``. A layer is
    made on the CPU from seed 0 and moved with the inputs (``_nn_api_on``)."""
    f32, bf16 = torch.float32, torch.bfloat16

    def unpool(n):
        def fn(F, L, x):
            y, mask = getattr(F, f"max_pool{n}d")(x, 3, 2, 1, return_mask=True, ceil_mode=True)
            return getattr(F, f"max_unpool{n}d")(y, mask, 3, 2, 1, output_size=list(x.shape))
        return fn

    return [
        ("layer_norm", lambda F, L, x, w, b: F.layer_norm(x, [16, 64], w, b),
         [(8, 16, 64), (16, 64), (16, 64)], f32),
        ("layer_norm_bf16", lambda F, L, x, w, b: F.layer_norm(x, 64, w, b),
         [(8, 16, 64), (64,), (64,)], bf16),
        ("instance_norm_nhwc", lambda F, L, x, w, b: F.instance_norm(x, weight=w, bias=b,
                                                                     data_format="NHWC"),
         [(4, 14, 14, 32), (32,), (32,)], f32),
        ("group_norm", lambda F, L, x, w, b: F.group_norm(x, 8, 1e-5, w, b),
         [(4, 32, 14, 14), (32,), (32,)], f32),
        ("local_response_norm_nhwc", lambda F, L, x: F.local_response_norm(
            x, 5, 1e-3, 0.75, 2.0, data_format="NHWC"), [(4, 14, 14, 32)], f32),
        ("rms_norm_bf16", lambda F, L, x, w: F.rms_norm(x, w), [(8, 16, 64), (64,)], bf16),
        ("batch_norm_nhwc_bf16", lambda F, L, x, w, b: F.batch_norm(
            x, torch.zeros(32, device=x.device), torch.ones(32, device=x.device), w, b,
            training=True, data_format="NHWC"), [(8, 14, 14, 32), (32,), (32,)], bf16),
        ("max_pool2d_ceil_nhwc", lambda F, L, x: F.max_pool2d(x, 3, 2, 1, ceil_mode=True,
                                                              data_format="NHWC"),
         [(4, 15, 15, 16)], f32),
        ("avg_pool3d_ceil_divisor", lambda F, L, x: F.avg_pool3d(x, 3, 2, 1, ceil_mode=True,
                                                                 divisor_override=7),
         [(2, 8, 9, 9, 9)], f32),
        ("avg_pool1d_inclusive", lambda F, L, x: F.avg_pool1d(x, 4, 3, 2, exclusive=False),
         [(4, 16, 33)], f32),
        ("adaptive_max_pool3d_mask", lambda F, L, x: F.adaptive_max_pool3d(x, [3, 2, 4],
                                                                           return_mask=True)[0],
         [(2, 8, 7, 9, 10)], f32),
        ("adaptive_avg_pool1d", lambda F, L, x: F.adaptive_avg_pool1d(x, 5), [(4, 16, 33)], f32),
        ("max_unpool1d", unpool(1), [(4, 16, 33)], f32),
        ("max_unpool2d", unpool(2), [(4, 16, 15, 15)], f32),
        ("max_unpool3d", unpool(3), [(2, 8, 9, 9, 9)], f32),
        ("conv2d_transpose_dilation2_groups2", lambda F, L, x, w, b: F.conv2d_transpose(
            x, w, b, stride=2, padding=1, dilation=2, groups=2, output_size=[30, 29]),
         [(4, 32, 14, 14), (32, 16, 3, 3), (32,)], f32),
        ("conv3d_transpose_bf16", lambda F, L, x, w, b: F.conv3d_transpose(x, w, b, stride=2,
                                                                           padding=1),
         [(2, 16, 6, 6, 6), (16, 8, 3, 3, 3), (8,)], bf16),
        ("conv1d_transpose_uneven", lambda F, L, x, w: F.conv1d_transpose(
            x, w, stride=3, padding=[2, 0], output_padding=1), [(4, 16, 20), (16, 8, 4)], f32),
        ("conv2d_nhwc_bf16", lambda F, L, x, w, b: F.conv2d(x, w, b, stride=2, padding=1,
                                                            groups=2, data_format="NHWC"),
         [(4, 14, 14, 32), (64, 16, 3, 3), (64,)], bf16),
        ("GroupNorm", lambda F, L, x: L["GroupNorm"](x), [(4, 32, 14, 14)], f32),
        ("InstanceNorm3D", lambda F, L, x: L["InstanceNorm3D"](x), [(2, 8, 6, 6, 6)], f32),
        ("LocalResponseNorm", lambda F, L, x: L["LocalResponseNorm"](x), [(4, 32, 7, 7)], f32),
        ("RMSNorm", lambda F, L, x: L["RMSNorm"](x), [(8, 16, 64)], f32),
        ("MaxPool3D", lambda F, L, x: L["MaxPool3D"](x), [(2, 8, 9, 9, 9)], f32),
        ("AvgPool1D", lambda F, L, x: L["AvgPool1D"](x), [(4, 16, 33)], f32),
        ("AdaptiveMaxPool2D", lambda F, L, x: L["AdaptiveMaxPool2D"](x), [(4, 16, 15, 15)], f32),
        ("Conv2DTranspose", lambda F, L, x: L["Conv2DTranspose"](x), [(4, 32, 14, 14)], f32),
        ("Conv1DTranspose", lambda F, L, x: L["Conv1DTranspose"](x, output_size=[41]),
         [(4, 16, 20)], f32),
    ]


def _nn_api_layers(device):
    """The layers of ``_nn_api_cases``, made on the CPU from seed 0 and
    moved to ``device``."""
    from paddle_tpu_torch.nn import layer as L

    made = dict(GroupNorm=L.GroupNorm(8, 32, device="cpu"), InstanceNorm3D=L.InstanceNorm3D(
        8, device="cpu"), LocalResponseNorm=L.LocalResponseNorm(5),
        RMSNorm=L.RMSNorm(64, device="cpu"),
        MaxPool3D=L.MaxPool3D(3, 2, 1, ceil_mode=True), AvgPool1D=L.AvgPool1D(4, 3, 1),
        AdaptiveMaxPool2D=L.AdaptiveMaxPool2D([4, 5]),
        Conv2DTranspose=L.Conv2DTranspose(32, 16, 3, stride=2, padding=1, dilation=2, groups=2,
                                          device="cpu", generator=torch.Generator().manual_seed(0)),
        Conv1DTranspose=L.Conv1DTranspose(16, 8, 4, stride=2, padding=1, device="cpu",
                                          generator=torch.Generator().manual_seed(1)))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in made.values():  # affine parameters away from ones and zeros
            for p in m.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return {k: m.to(device) for k, m in made.items()}


def _nn_api_inputs(device, arrays, out_shape):
    """A case's inputs on ``device``, taking gradients, and its output
    weight ``w`` (seed 1)."""
    w = np.random.default_rng(1).standard_normal(tuple(out_shape)).astype(np.float32)
    return ([torch.from_numpy(a).to(device).requires_grad_(True) for a in arrays],
            torch.from_numpy(w).to(device))


def _nn_api_run(name, fn, ins, w, dtype, layers):
    """Case ``name``: its output and the gradients of ``sum(y * w)`` for its
    inputs and its layer's parameters (a layer case is named by its
    layer), on the inputs' device. bf16 cases run under ``auto_cast`` O1
    with f32 inputs."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F

    ctx = (amp.auto_cast(level="O1", dtype="bfloat16") if dtype == torch.bfloat16
           else contextlib.nullcontext())
    with ctx:
        out = fn(F, layers, *ins)
    leaves = ins + (list(layers[name].parameters()) if name in layers else [])
    grads = torch.autograd.grad((out.float() * w).sum(), leaves, allow_unused=True)
    return [out.detach()] + [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]


def phase_nn_layers_api():
    """Every function and layer of the nn library's second half on card
    tensors against the CPU (``NN_API_TOL``: the largest error over the
    largest value of each output and gradient), values and gradients, the
    layers' parameter gradients too; the calls that synchronise with the
    host listed, as ``tensor_api`` lists them (the inputs are on the card before the call
    and copied back after it). Returns the K1-K4b launches (none)."""
    import warnings

    from paddle_tpu_torch.nn import functional as F

    cases = _nn_api_cases()
    host_layers, card_layers = _nn_api_layers("cpu"), _nn_api_layers("cuda")
    rows, bad, syncs = {}, [], []
    reset_launches()
    for name, fn, shapes, dtype in cases:
        rng = np.random.default_rng(SEED)
        arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        with torch.no_grad():
            shape = fn(F, host_layers, *[torch.from_numpy(a) for a in arrays]).shape
        want = _nn_api_run(name, fn, *_nn_api_inputs("cpu", arrays, shape), dtype, host_layers)
        _nn_api_run(name, fn, *_nn_api_inputs("cuda", arrays, shape), dtype, card_layers)  # warm
        ins, w = _nn_api_inputs("cuda", arrays, shape)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = _nn_api_run(name, fn, ins, w, dtype, card_layers)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if any("synchroniz" in str(m.message) for m in caught):
            syncs.append(name)
        got = [t.float().cpu() for t in got]
        want = [t.float() for t in want]
        errs = [float((g - t).abs().max()) / max(float(t.abs().max()), 1e-30)
                for g, t in zip(got, want)]
        good = (len(got) == len(want) and all(g.shape == t.shape for g, t in zip(got, want))
                and max(errs) <= NN_API_TOL[dtype])
        rows[name] = dict(dtype=str(dtype).replace("torch.", ""), out_err=errs[0],
                          grad_err=max(errs[1:], default=0.0), tensors=len(got))
        if not good:
            bad.append(name)
    launches = read_launches()
    ok = not bad and all(v == 0 for v in launches.values())
    emit(phase="nn_layers_api", ok=ok, cases=len(cases), failed=bad, host_syncs=syncs,
         tol={str(k).replace("torch.", ""): v for k, v in NN_API_TOL.items()}, rows=rows,
         launches=launches)
    if not ok:
        raise AssertionError(f"nn_layers_api phase failed: {bad}")
    return launches


def dlrm_config(vocab_sizes=None):
    from paddle_tpu_torch.models.dlrm import DLRMConfig

    c = DLRM_TRAIN
    return DLRMConfig(num_dense=c["num_dense"], vocab_sizes=vocab_sizes or c["vocab_sizes"],
                      embedding_dim=c["embedding_dim"], bottom_mlp=c["bottom_mlp"],
                      top_mlp=c["top_mlp"])


def dlrm_batches(cfg, batch, k, rounds, seed=0):
    """``bench_recsys.py:_measure``'s ``make_batch`` (``:72-81``), copied:
    ``rounds`` stacks of ``k`` batches from ``default_rng(seed)``, power-law
    ids (a hot head and a long tail per feature)."""
    rng = np.random.default_rng(seed)

    def make_batch():
        dense = rng.normal(size=(batch, cfg.num_dense)).astype(np.float32)
        ids = np.stack(
            [np.minimum((rng.pareto(1.05, batch) * (v // 50)).astype(np.int64), v - 1)
             for v in cfg.vocab_sizes], axis=1).astype(np.int32)
        labels = rng.integers(0, 2, (batch, 1)).astype(np.float32)
        return (dense, ids), (labels,)

    return [[make_batch() for _ in range(k)] for _ in range(rounds)]


def _fused_rows(cfg, stack):
    """The fused table's rows that the batches of ``stack`` look up."""
    offsets = np.cumsum((0,) + cfg.vocab_sizes[:-1])[None, :]
    return np.unique(np.concatenate([b[0][1] + offsets for b in stack]).ravel())


def _table_state(model, opt):
    """The table and its Adam moments (the optimizer's state of
    ``embedding.weight``)."""
    i = [n for n, _ in model.named_parameters()].index("embedding.weight")
    return model.embedding.weight, opt._state["m"][i], opt._state["v"][i]


def _dlrm_group(name):
    """The group of a device kernel of the DLRM step by its name (the
    optimizer's kernels are told apart by their place, the step's last)."""
    if any(t in name for t in ("embedding", "segment", "Radix", "radix", "cub::", "krn_",
                               "compute_grad_weight", "sum_and_scatter")):
        return "embedding backward (sort, segment sums)"
    if "indexSelect" in name or "index_select" in name:
        return "embedding lookup"
    if "FillFunctor" in name or "fill_kernel" in name:
        return "zero-fill"
    group = _kernel_group(name)
    return "MLP and interaction GEMMs (cuBLAS)" if group == "matmul (cuBLAS)" else "elementwise"


def profile_dlrm_step(step, opt, inputs, labels):
    """One DLRM step traced: device ms by group, the busy time (union of the
    kernel intervals) and the step's wall time. The optimizer's update is
    told apart by two marker kernels (``torch.cuda._sleep(1)``, ATen's
    ``spin_kernel``) launched just before and just after it. After the
    earlier phases' traces the tracer misses the first kernels of a trace
    (13 of 44 in one run; all of 5 warm-up markers and more in another), so
    the step starts after 64 warm-up markers, and only the kernels after
    the last of those count. Where fewer than 3 markers show, returns the
    counts the trace holds instead."""
    from torch.profiler import ProfilerActivity, profile

    update = opt._traced_update

    def marked(*args):
        torch.cuda._sleep(1)
        update(*args)
        torch.cuda._sleep(1)

    opt._traced_update = marked
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(inputs, labels)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        del opt._traced_update  # the bound method again
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    marks = [j for j, e in enumerate(kernels) if "spin_kernel" in e.name]
    if len(marks) < 3:
        return dict(kernels_traced=len(kernels), markers_traced=len(marks))
    first, opt_begin, opt_end = marks[-3] + 1, marks[-2], marks[-1]
    groups, busy, end = {}, 0.0, -1.0
    for j in range(first, len(kernels)):
        if j in (opt_begin, opt_end):
            continue
        e = kernels[j]
        g = "optimizer (RowSparseAdam)" if opt_begin < j < opt_end else _dlrm_group(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
        a, b = e.time_range.start, e.time_range.end
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(step_ms=wall_ms, device_busy_ms=busy / 1e3, busy_share=busy / 1e3 / wall_ms,
                kernels=len(kernels) - first - 2, optimizer_kernels=opt_end - opt_begin - 1,
                device_ms_by_group=dict(sorted(groups.items(), key=lambda x: -x[1])))


def phase_dlrm_train():
    """``bench_recsys.py:_measure``'s one-chip branch through the port,
    uncut: ``DLRM`` over the fused 800,000 x 64 table, ``RowSparseAdam``
    (lr 1e-3), ``TrainStep.run_steps`` over stacks of 8 batches of 4096
    from the bench's generator; one warm-up call (``time_to_first_step``,
    synchronised), 4 timed calls; the bench's keys, ms per step, peak
    memory, one traced step and the bounds of the masked-table update and
    of a touched-rows-only one. Gates: the losses finite, one dispatch per
    ``run_steps`` call, and after a further call every table row outside
    its ids with its value and both moments bitwise unchanged. Returns the
    K1-K4b launches (none)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.dlrm import DLRM, DLRMCriterion
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.optimizer import RowSparseAdam

    c = DLRM_TRAIN
    cfg = dlrm_config()
    b, k, rounds = c["batch"], c["k"], c["rounds"]
    stacks = dlrm_batches(cfg, b, k, rounds)
    # the bench's per-step touched fraction of the fused table
    offsets = np.cumsum((0,) + cfg.vocab_sizes[:-1])[None, :]
    uniques = [np.unique(bt[0][1] + offsets).size for stack in stacks for bt in stack]
    touched = float(np.mean(uniques)) / cfg.total_vocab
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()  # what earlier phases still hold
    model = DLRM(cfg, seed=SEED)
    opt = RowSparseAdam(learning_rate=c["lr"], parameters=model.parameters(),
                        sparse_params=model.sparse_param_names())
    step = TrainStep(model, opt, DLRMCriterion())
    t0 = time.perf_counter()
    first = step.run_steps(stacks[0])
    float(first["loss"][-1])
    ttfs = time.perf_counter() - t0
    metrics.reset_counters("train_step.")
    t0 = time.perf_counter()
    outs = [step.run_steps(stack) for stack in stacks]
    float(outs[-1]["loss"][-1])  # host sync: everything above finished
    seconds = time.perf_counter() - t0
    dispatches = metrics.counters("train_step.").get("train_step.dispatches", 0)
    steps = rounds * k
    metrics.counter_inc("recsys.steps", steps)
    metrics.counter_inc("recsys.examples", steps * b)
    peak = torch.cuda.max_memory_allocated() - held_before
    losses = [float(v) for o in [first] + outs for v in o["loss"]]
    # the row-sparse contract over one more call: rows outside its ids
    before = [t.detach().clone() for t in _table_state(model, opt)]
    step.run_steps(stacks[1])
    rows = torch.from_numpy(_fused_rows(cfg, stacks[1])).to("cuda")
    looked_up = torch.zeros(model.embedding.padded_rows, dtype=torch.bool, device="cuda")
    looked_up[rows] = True
    after = [t.detach() for t in _table_state(model, opt)]
    untouched_bitwise = all(torch.equal(a[~looked_up], o[~looked_up]) for a, o in zip(after, before))
    rows_moved = int((after[0] != before[0]).any(dim=1).sum())
    launches = read_launches()
    exch = model.embedding.exchange_stats(b * cfg.num_sparse)
    # the traced step, and the optimizer's update alone by CUDA events
    inputs = tuple(torch.from_numpy(x).to("cuda") for x in stacks[0][0][0])
    labels = tuple(torch.from_numpy(x).to("cuda") for x in stacks[0][0][1])
    breakdown = profile_dlrm_step(step, opt, inputs, labels)
    lr = opt.lr_at(opt._step_count)
    optimizer_ms = cuda_ms(lambda: opt._traced_update(lr, step._param_names), iters=10)
    # bounds: the masked update reads g, m, v, p and writes m, v, p over the
    # whole table, and the backward zero-fills its dense gradient; an update
    # of the touched rows alone moves 7 row-sized passes over this run's
    # mean unique rows per step; both against the MLP and interaction flops
    # (forward and backward, 6 per weight and example, 6 per bmm MAC)
    table_bytes = model.embedding.weight.numel() * 4
    mlp_params = sum(p.numel() for n, p in model.named_parameters() if n != "embedding.weight")
    f1 = cfg.num_sparse + 1
    flops = 6 * b * mlp_params + 6 * b * f1 * f1 * cfg.embedding_dim
    t_ops = flops / PEAK_FLOPS[torch.float32]
    masked_bytes = 8 * table_bytes
    touched_bytes = 7 * float(np.mean(uniques)) * cfg.embedding_dim * 4
    bounds = {name: dict(bytes=nbytes, bytes_ms=1e3 * nbytes / PEAK_BYTES, flops=flops,
                         flops_ms=1e3 * t_ops, bound_ms=1e3 * max(nbytes / PEAK_BYTES, t_ops),
                         bound_by="bytes" if nbytes / PEAK_BYTES >= t_ops else "operations")
              for name, nbytes in (("masked_table", masked_bytes), ("touched_rows", touched_bytes))}
    ms_per_step = 1e3 * seconds / steps
    ok = (all(np.isfinite(losses)) and dispatches / rounds == 1 and untouched_bitwise
          and rows_moved > 0 and all(v == 0 for v in launches.values()))
    emit(phase="dlrm_train", ok=ok, config=f"dlrm-v{cfg.total_vocab}d{cfg.embedding_dim}b{b}x1",
         recsys_examples_per_sec=steps * b / seconds, steps_per_sec=steps / seconds,
         embedding_a2a_bytes_per_step=exch["bytes_total"], touched_row_fraction=touched,
         exchange_capacity=exch["capacity"], shards=1, batch=b, total_vocab=cfg.total_vocab,
         embedding_dim=cfg.embedding_dim, loss_final=losses[-1],
         dispatches_per_run_steps=dispatches / rounds, time_to_first_step=ttfs,
         ms_per_step=ms_per_step, peak_memory_allocated=peak, held_before=held_before, params=sum(
             p.numel() for p in model.parameters()), mlp_params=mlp_params,
         losses=losses[::k] + losses[-1:], untouched_rows_bitwise=untouched_bitwise,
         rows_looked_up=int(rows.numel()), rows_moved=rows_moved, optimizer_ms=optimizer_ms,
         bounds=bounds, masked_bound_share=bounds["masked_table"]["bound_ms"] / ms_per_step,
         profile=breakdown,
         device_busy_share_of_timed_step=(breakdown["device_busy_ms"] / ms_per_step
                                          if "device_busy_ms" in breakdown else None),
         launches=launches)
    if not ok:
        raise AssertionError("dlrm_train phase failed")
    return launches


def _bce(logits, labels):
    """``DLRMCriterion``'s expression in the logits' own dtype (float64 for
    the float64 check; ``DLRMCriterion`` computes in f32)."""
    x, y = logits.reshape(-1), labels.reshape(-1).to(logits.dtype)
    return torch.mean(torch.maximum(x, x.new_zeros(())) - x * y + torch.log1p(torch.exp(-torch.abs(x))))


def _dlrm_run_on(device, dtype, cfg, state, batches, lr):
    """``RowSparseAdam`` steps of DLRM from ``state`` on ``device`` in
    ``dtype`` through one ``run_steps`` call: the losses, every parameter
    and the table's moments, on the CPU."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.dlrm import DLRM, DLRMCriterion
    from paddle_tpu_torch.optimizer import RowSparseAdam

    model = DLRM(cfg, device=device)
    model.load_state_dict(state)
    model.to(dtype)
    opt = RowSparseAdam(learning_rate=lr, parameters=model.parameters(),
                        sparse_params=model.sparse_param_names())
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    batches = [((d.astype(np_dtype), i), (y.astype(np_dtype),)) for (d, i), (y,) in batches]
    loss_fn = DLRMCriterion() if dtype == torch.float32 else _bce
    losses = TrainStep(model, opt, loss_fn).run_steps(batches)["loss"].cpu()
    _, m, v = _table_state(model, opt)
    out = {n: p.detach().cpu() for n, p in model.named_parameters()}
    out.update({"embedding.m": m.cpu(), "embedding.v": v.cpu()})
    return losses, out


def _eager_lazy_run_on(device, weight, ids, ys, lr):
    """Eager ``Adam(lazy_mode=True)`` over ``Embedding(sparse=True)``: the
    table and its moments after one step per ``ys``."""
    from paddle_tpu_torch.nn.layer import Embedding
    from paddle_tpu_torch.optimizer import Adam

    emb = Embedding(*weight.shape, sparse=True, device=device)
    with torch.no_grad():
        emb.weight.copy_(weight)
    opt = Adam(learning_rate=lr, parameters=emb.parameters(), lazy_mode=True)
    idx = torch.from_numpy(ids).to(device)
    for y in ys:
        (emb(idx) * torch.from_numpy(y).to(device)).sum().backward()
        opt.step()
        opt.clear_grad()
    return {"table": emb.weight.detach().cpu(), "m": opt._state["m"][0].cpu(),
            "v": opt._state["v"][0].cpu()}


def phase_dlrm_check():
    """DLRM at the full widths with a cut vocabulary (8 x 10,000) and batch
    (512): 3 ``run_steps`` steps of ``RowSparseAdam`` on the card and on the
    CPU from the same weights (seed 30) and the bench's batches (seed 31),
    in f32 (twice on the card: bitwise equal) and in float64
    (``DLRM_CHECK_TOL``); the rows no batch looked up keep their values and
    zero moments; then 2 eager ``Adam(lazy_mode=True)`` steps over
    ``Embedding(sparse=True)`` with the first batch's fused ids, f32, the
    table and its moments within the f32 table limit."""
    from paddle_tpu_torch.models.dlrm import DLRM

    c = DLRM_CHECK
    cfg = dlrm_config(c["vocab_sizes"])
    state = DLRM(cfg, device="cpu", seed=SEED + 30).state_dict()
    batches = dlrm_batches(cfg, c["batch"], c["steps"], 1, seed=SEED + 31)[0]
    lr = DLRM_TRAIN["lr"]
    untouched = ~torch.isin(torch.arange(state["embedding.weight"].shape[0]),
                            torch.from_numpy(_fused_rows(cfg, batches)))
    results, ok = {}, True
    for dtype in (torch.float32, torch.float64):
        tol = DLRM_CHECK_TOL[dtype]
        loss_c, got_c = _dlrm_run_on("cuda", dtype, cfg, state, batches, lr)
        loss_h, got_h = _dlrm_run_on("cpu", dtype, cfg, state, batches, lr)
        extra = {}
        if dtype == torch.float32:
            loss_c2, got_c2 = _dlrm_run_on("cuda", dtype, cfg, state, batches, lr)
            extra["card_runs_bitwise"] = bool(torch.equal(loss_c, loss_c2) and all(
                torch.equal(got_c[n], got_c2[n]) for n in got_c))
        loss_rel = float(((loss_c - loss_h).abs() / loss_h.abs()).max())
        rel = _grad_rel_l2(got_c, got_h)
        table = {n: rel[n] for n in ("embedding.weight", "embedding.m", "embedding.v")}
        mlp = {n: r for n, r in rel.items() if n not in table}
        worst = max(mlp, key=mlp.get)
        kept = bool(torch.equal(got_c["embedding.weight"][untouched],
                                state["embedding.weight"][untouched].to(dtype))
                    and not got_c["embedding.m"][untouched].any())
        agree = (loss_rel <= tol["loss_rtol"] and max(table.values()) <= tol["table_rel_l2_max"]
                 and mlp[worst] <= tol["mlp_rel_l2_max"] and kept
                 and extra.get("card_runs_bitwise", True) and bool(torch.isfinite(loss_c).all()))
        ok = ok and agree
        results[str(dtype).replace("torch.", "")] = dict(
            ok=agree, losses_card=loss_c.tolist(), losses_cpu=loss_h.tolist(), loss_rel=loss_rel,
            table_rel_l2=table, mlp_rel_l2_worst=mlp[worst], worst=worst,
            mlp_rel_l2_median=float(np.median(list(mlp.values()))), untouched_rows_kept=kept,
            **extra, **tol)
    # eager lazy Adam over the fused ids of the first batch
    offsets = np.cumsum((0,) + cfg.vocab_sizes[:-1])[None, :]
    ids = (batches[0][0][1] + offsets).astype(np.int64)
    rng = np.random.default_rng(SEED + 32)
    ys = [rng.normal(size=ids.shape + (cfg.embedding_dim,)).astype(np.float32)
          for _ in range(c["eager_steps"])]
    weight = state["embedding.weight"][:cfg.total_vocab]
    eager_c = _eager_lazy_run_on("cuda", weight, ids, ys, lr)
    eager_h = _eager_lazy_run_on("cpu", weight, ids, ys, lr)
    eager_rel = _grad_rel_l2(eager_c, eager_h)
    eager_ok = max(eager_rel.values()) <= DLRM_CHECK_TOL[torch.float32]["table_rel_l2_max"]
    ok = ok and eager_ok
    emit(phase="dlrm_check", ok=ok, vocab_sizes=list(c["vocab_sizes"]), batch=c["batch"],
         steps=c["steps"], eager_lazy_rel_l2=eager_rel, eager_lazy_ok=eager_ok,
         tf32=torch.backends.cuda.matmul.allow_tf32, **results)
    if not ok:
        raise AssertionError("dlrm_check phase failed: the card's steps and the CPU's disagree")


def _optim_cases():
    """name -> (optimizer factory over (parameters), the update path)."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.nn import clip as C
    from paddle_tpu_torch.regularizer import L1Decay, L2Decay

    lr = OPTIM_CHECK["lr"]
    cases = {
        "SGD": lambda ps: O.SGD(lr, parameters=ps),
        "SGD_L2_global_norm": lambda ps: O.SGD(lr, parameters=ps, weight_decay=L2Decay(1e-2),
                                               grad_clip=C.ClipGradByGlobalNorm(1.0)),
        "Momentum_L1_norm": lambda ps: O.Momentum(lr, parameters=ps, weight_decay=L1Decay(1e-3),
                                                  grad_clip=C.ClipGradByNorm(1.0)),
        "Momentum_nesterov_float": lambda ps: O.Momentum(lr, parameters=ps, use_nesterov=True,
                                                         weight_decay=1e-2),
        "Adam_L2_value": lambda ps: O.Adam(lr, parameters=ps, weight_decay=L2Decay(1e-2),
                                           grad_clip=C.ClipGradByValue(0.5)),
        "AdamW": lambda ps: O.AdamW(lr, parameters=ps, weight_decay=0.01),
        "RowSparseAdam": lambda ps: O.RowSparseAdam(lr, parameters=ps, sparse_params=["0"]),
        "Lamb": lambda ps: O.Lamb(lr, parameters=ps),
        "Adagrad": lambda ps: O.Adagrad(lr, parameters=ps, initial_accumulator_value=0.1),
        "RMSProp": lambda ps: O.RMSProp(lr, parameters=ps, momentum=0.5),
        "RMSProp_centered": lambda ps: O.RMSProp(lr, parameters=ps, momentum=0.5, centered=True),
        "Adadelta": lambda ps: O.Adadelta(lr, parameters=ps),
        "Adamax": lambda ps: O.Adamax(lr, parameters=ps),
    }
    return {f"{name}/{path}": (make, path) for name, make in cases.items()
            for path in ("step", "train_step")}


def _optim_step_on(device, make, path, p0, g0):
    """One update of ``make``'s optimizer over a weight and a bias on
    ``device``: the parameters and every state tensor, on the CPU."""
    params = [torch.tensor(p, device=device, requires_grad=True) for p in p0]
    for p, g in zip(params, g0):
        p.grad = torch.tensor(g, device=device)
    opt = make(params)
    if path == "step":
        opt.step()
    else:
        opt._traced_update(opt.lr_at(0))
    out = {f"param.{i}": p.detach().cpu() for i, p in enumerate(params)}
    out.update({f"{k}.{i}": t.cpu() for k, ts in (opt._state or {}).items() for i, t in enumerate(ts)})
    return out


def phase_optim_check():
    """One step of each optimizer core on the card against the CPU, through
    ``step()`` (clip, then decay) and the ``TrainStep`` update (decay, then
    clip), over a ``[4096, 1024]`` weight and a ``[1024]`` bias from seed 40,
    whose weight rows 0-511 have an all-zero gradient (so ``RowSparseAdam``'s
    masked path keeps them): each parameter and state tensor within
    ``OPTIM_CHECK_TOL`` of its largest entry."""
    rng = np.random.default_rng(SEED + 40)
    shape = OPTIM_CHECK["shape"]
    p0 = [rng.normal(size=shape).astype(np.float32), rng.normal(size=shape[1:]).astype(np.float32)]
    g0 = [rng.normal(size=shape).astype(np.float32), rng.normal(size=shape[1:]).astype(np.float32)]
    g0[0][:512] = 0.0
    errs, kept = {}, False
    for name, (make, path) in _optim_cases().items():
        got = _optim_step_on("cuda", make, path, p0, g0)
        want = _optim_step_on("cpu", make, path, p0, g0)
        errs[name] = max(float((got[k] - want[k]).abs().max() / want[k].abs().max().clamp(min=1e-30))
                         for k in want)
        if name == "RowSparseAdam/train_step":
            kept = torch.equal(got["param.0"][:512], torch.from_numpy(p0[0][:512]))
    worst = max(errs, key=errs.get)
    ok = errs[worst] <= OPTIM_CHECK_TOL and kept
    emit(phase="optim_check", ok=ok, shape=list(shape), cases=len(errs), max_err=errs,
         worst=worst, row_sparse_zero_rows_kept=kept, tol=OPTIM_CHECK_TOL)
    if not ok:
        raise AssertionError("optim_check phase failed: an optimizer's card step and CPU step disagree")


# ---------------------------------------------------------------- slice 10
# dlrm_sharded_train: bench_recsys.py:49-54's config (8 x 100,000 x 64 fused
# into one 800,000 x 64 f32 table, global batch 4096, the bench's power-law
# ids, RowSparseAdam lr 1e-3) at 4 shards: the table row-sharded over dp 4,
# the MLPs data-parallel, as 4 gloo processes on cuda:0. 8 steps against
# one process's 8 from the same weights and batches; then a rotation: the
# dp 4 state saved through EmbeddingCheckpointRotation, restored onto dp 2,
# saved again, restored onto dp 4.
DLRM_SHARDED = dict(shards=4, batch=4096, steps=8, lr=1e-3, timeout=600.0)
# the losses and the table's moments after the steps against the
# one-process run: tests/test_recsys.py's dp4-against-dp1 gate (rtol 2e-5,
# atol 2e-6), the reference's own; the lookup and the table gradient of one
# batch are held bitwise. A rank's MLPs run on a quarter of the batch, and
# cuBLAS's GEMMs for 1024 rows round otherwise than for 4096: batch 0's
# table gradient from the whole model is bitwise one process's with its
# MLPs on the same quarter blocks and differs from its whole-batch one
# (_dlrm_grad_witness, read on the card: 1.4e6 of the table's entries, by
# up to 9.3e-10; the MLP gradients in 77% of entries, 3.6e-7 relative).
# From there Adam moves an entry whose moment m is a cancelling sum by
# up to lr times a sign. So the table: every entry within the steps' reach
# (2 lr a step); the rows the steps touched within a relative L2 error of
# touched_rel_l2; and every entry outside the reference's entrywise gate
# one whose m is noise, off by more than noise_m_rel of itself (read on the
# card: losses 6.0e-8 apart, moments 1.5e-6; touched rows 7.1e-7 relative
# L2; 268 entries outside the entrywise gate, up to 9.7e-4 apart, their m
# off by 0.7% to 47000% of itself)
DLRM_SHARDED_TOL = dict(rtol=2e-5, atol=2e-6, touched_rel_l2=3e-6, noise_m_rel=1e-3)
# zero_offload_gpt3_train: zero_gpt3_train's step (GPT-3 1.3B, selective
# recompute, O2, 2 micro-batches, ZeRO stage 2 at world 1 over NCCL) with
# sharding_configs.offload: the AdamW moments in pinned host memory
# amp_o1_gpt_train / fp16_gpt_train: bench.py's train GPT (SERVE_CFG) with
# the per-layer trunk, whose linears and attention the AMP lists cast (the
# stacked trunk is one unlisted op in the reference, so O1 would run its
# attention in f32), ids [8, 1024], AdamW lr 1e-4
AMP_GPT = dict(batch=8, seq=1024, lr=1e-4, o1_steps=3, fp16_steps=5)
# fp16_gpt_train's GradScaler: a small initial scale (no overflow of its
# own at this config), growth after 2 clean steps, a back-off at the first
# overflow; the planted inf is in the gradients of step 1
FP16_SCALER = dict(init_loss_scaling=4096.0, incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
FP16_PLANT_STEP = 1
# the AMP steps' losses through K1/K2 against the same steps with the plain
# attention (sdpa=xla) from the same weights: bf16 (O1) and float16 round
# the attention's outputs and gradients at other places than the plain
# version's f32 math (read on the card: 6.2e-6 in bf16, 2.7e-6 in float16)
AMP_LOSS_RTOL = {"bfloat16": 6e-5, "float16": 3e-5}


def _dlrm_sharded_rank(root):
    """Rank body of ``dlrm_sharded_train`` at dp = the world: the lookup and
    table gradient of batch 0 against one process's; the steps over this
    rank's blocks (losses, s a step, staged and exchanged bytes); this
    rank's table rows and moments against the one-process run's; then the
    state published through the rotation (``root/ckpt_a``)."""
    from pathlib import Path

    import torch.nn.functional as F

    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.embedding import (EmbeddingCheckpointRotation,
                                                        ShardedEmbedding)
    from paddle_tpu_torch.distributed.resilience import CheckpointManager
    from paddle_tpu_torch.models.dlrm import DLRM, DLRMCriterion
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.optimizer import RowSparseAdam
    from paddle_tpu_torch.utils.convert import expert_split_names, shard_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(root)
    c = DLRM_SHARDED
    cfg = dlrm_config()
    full = torch.load(root / "weights.pt", mmap=True, weights_only=True)
    batches = dlrm_batches(cfg, c["batch"], c["steps"], 1, seed=SEED + 1)[0]
    offsets = np.cumsum((0,) + cfg.vocab_sizes[:-1])
    fused = torch.from_numpy(batches[0][0][1] + offsets).to("cuda")
    dy = torch.randn((*fused.shape, cfg.embedding_dim), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(SEED + 3))
    # one process's lookup of the whole batch (no fleet yet: one shard)
    one = ShardedEmbedding(cfg.total_vocab, cfg.embedding_dim, device="cuda")
    with torch.no_grad():
        one.weight.copy_(full["embedding.weight"])
    e_one = one(fused)
    e_one.backward(dy)
    fleet.init(is_collective=True, strategy=_dp_strategy(c["shards"]))
    hcg = fleet.get_hybrid_communicate_group()
    r, n = hcg.get_data_parallel_rank(), c["shards"]
    model = DLRM(cfg, seed=SEED)
    model.load_state_dict(shard_state(full, ep_rank=r, ep_degree=n,
                                      ep_names=expert_split_names(model)))
    lo, hi = model.embedding.rows
    blk = c["batch"] // n
    e = model.embedding(fused[r * blk:(r + 1) * blk])
    e.backward(dy[r * blk:(r + 1) * blk])
    lookup_bitwise = bool(torch.equal(e, e_one[r * blk:(r + 1) * blk]))
    grad_bitwise = bool(torch.equal(model.embedding.weight.grad, one.weight.grad[lo:hi]))
    del one, e_one, e, dy
    model.zero_grad(set_to_none=True)
    # the table gradient of batch 0's loss on this rank's block against the
    # one-process witness (_dlrm_grad_witness): its MLPs on the same blocks,
    # and on the whole batch
    (dense0, ids0), (labels0,) = batches[0]
    block = [torch.from_numpy(a[r * blk:(r + 1) * blk]).to("cuda") for a in (dense0, ids0, labels0)]
    DLRMCriterion()(model(*block[:2]), block[2]).backward()
    g = model.embedding.weight.grad.cpu()
    witness = torch.load(root / "witness.pt", mmap=True, weights_only=True)
    step1 = {"blocks_bitwise": bool(torch.equal(g, witness["blocks"][lo:hi])),
             "whole_bitwise": bool(torch.equal(g, witness["whole"][lo:hi])),
             "whole_entries_differ": int((g != witness["whole"][lo:hi]).sum()),
             "whole_max_abs": float((g - witness["whole"][lo:hi]).abs().max())}
    del witness, g, block
    model.zero_grad(set_to_none=True)
    opt = RowSparseAdam(learning_rate=c["lr"], parameters=model.parameters(),
                        sparse_params=model.sparse_param_names())
    step = fleet.distributed_step(model, opt, DLRMCriterion())
    feeds = [(fleet.shard_batch(*x), (fleet.shard_batch(*y),)) for x, y in batches]
    metrics.reset_counters("collective.")
    metrics.reset_counters("embedding.")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step.run_steps(feeds)
    losses = [float(v) for v in out["loss"]]
    seconds = time.perf_counter() - t0
    calls = metrics.counters("collective.")
    emb = metrics.counters("embedding.")
    ref = torch.load(root / "one.pt", weights_only=True)
    table, m, v = (t.detach() for t in _table_state(model, opt))
    tol = DLRM_SHARDED_TOL

    def err(got, want):
        d = (got.cpu() - want).abs()
        return dict(max_abs=float(d.max()), ok=bool((d <= tol["atol"] + tol["rtol"] * want.abs()).all()),
                    outside_ref_tol=int((d > tol["atol"] + tol["rtol"] * want.abs()).sum()),
                    sq_err=float(d.double().square().sum()), sq_ref=float(want.double().square().sum()))

    held = {"table": err(table, ref["table"][lo:hi]), "m": err(m, ref["m"][lo:hi]),
            "v": err(v, ref["v"][lo:hi])}
    reach = 2 * c["lr"] * c["steps"]
    held["table"]["ok"] = held["table"]["max_abs"] <= reach
    # the rows the steps touched: the table's error over them alone, and
    # the entries outside the reference's gate with their moments
    rows = _fused_rows(cfg, batches)
    rows = torch.from_numpy(rows[(rows >= lo) & (rows < hi)] - lo)
    d = (table.cpu()[rows] - ref["table"][lo:hi][rows]).double()
    held["table"].update(touched_rows=int(rows.numel()), touched_sq_err=float(d.square().sum()),
                         touched_sq_ref=float(ref["table"][lo:hi][rows].double().square().sum()))
    want_t = ref["table"][lo:hi]
    out_of_gate = ((table.cpu() - want_t).abs() > tol["atol"] + tol["rtol"] * want_t.abs())
    idx = out_of_gate.nonzero(as_tuple=True)
    outliers = [dict(d_table=float((table.cpu() - want_t)[i, j]), m=float(ref["m"][lo:hi][i, j]),
                     d_m=float(m.cpu()[i, j] - ref["m"][lo:hi][i, j]),
                     v=float(ref["v"][lo:hi][i, j]), d_v=float(v.cpu()[i, j] - ref["v"][lo:hi][i, j]))
                for i, j in zip(idx[0].tolist(), idx[1].tolist())]
    touched_m = ref["m"][lo:hi][rows].abs().flatten().double()
    touched_v = ref["v"][lo:hi][rows].flatten().double()
    moments_touched = {"abs_m_quantiles": [float(x) for x in torch.quantile(
                           touched_m[:1 << 24], torch.tensor([0.01, 0.5, 0.99], dtype=torch.double))],
                       "sqrt_v_quantiles": [float(x) for x in torch.quantile(
                           touched_v[:1 << 24].sqrt(),
                           torch.tensor([0.01, 0.5, 0.99], dtype=torch.double))]}
    # the rotation's first save: the dp 4 state, written whole
    rot = EmbeddingCheckpointRotation(CheckpointManager(str(root / "ckpt_a"), keep_last_k=1),
                                      every=c["steps"], table_names=model.sparse_param_names())
    t1 = time.perf_counter()
    rot.maybe_save(step, c["steps"])
    save_s = time.perf_counter() - t1
    rows_checkpointed = metrics.counters("embedding.").get("embedding.rows_checkpointed", 0)
    fleet._hcg = None
    return dict(rank=r, rows=[lo, hi], lookup_bitwise=lookup_bitwise, grad_bitwise=grad_bitwise,
                losses=losses, one_losses=ref["losses"], seconds_per_step=seconds / c["steps"],
                host_staged_bytes_per_step=calls.get(collective.HOST_STAGED, 0) / c["steps"],
                a2a_bytes_per_step=emb.get("embedding.a2a_bytes", 0) / c["steps"],
                ids_exchanged_per_step=emb.get("embedding.ids_exchanged", 0) / c["steps"],
                rows_checkpointed=rows_checkpointed, held=held, step1=step1, outliers=outliers,
                moments_touched=moments_touched, save_seconds=save_s, launches=read_launches())


def _dlrm_grad_witness(model, batch, n):
    """The gradients of one batch's loss from one process's DLRM, over one
    lookup of the whole batch: with the MLPs on the whole batch (the loss
    ``n`` times the batch's mean), and with them on each of ``n`` blocks
    (the sum of the blocks' means, as ``n`` ranks' losses give it). Returns
    both table gradients on the host and how far the two runs' table and
    MLP gradients differ."""
    from paddle_tpu_torch.models.dlrm import DLRMCriterion

    crit = DLRMCriterion()
    (dense, ids), (labels,) = batch
    dense, ids, labels = (torch.from_numpy(a).to("cuda") for a in (dense, ids, labels))
    w = model.embedding.weight
    mlp = [p for name, p in model.named_parameters() if not name.startswith("embedding.")]
    emb = model.lookup(ids)
    whole = torch.autograd.grad(crit(model.interact(dense, emb), labels) * n, [w] + mlp,
                                retain_graph=True)
    blk = dense.shape[0] // n
    blocks = torch.autograd.grad(
        sum(crit(model.interact(dense[i * blk:(i + 1) * blk], emb[i * blk:(i + 1) * blk]),
                 labels[i * blk:(i + 1) * blk]) for i in range(n)), [w] + mlp)
    mlp_rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(whole[1:], blocks[1:])]
    return dict(whole=whole[0].cpu(), blocks=blocks[0].cpu(),
                table_entries_differ=int((whole[0] != blocks[0]).sum()),
                mlp_entries_differ=sum(int((a != b).sum()) for a, b in zip(whole[1:], blocks[1:])),
                mlp_entries=sum(p.numel() for p in mlp), mlp_max_rel=max(mlp_rel))


def _dp_strategy(dp):
    """A strategy of ``dp`` data-parallel ranks."""
    from paddle_tpu_torch.distributed import DistributedStrategy

    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp}
    return s


def _dlrm_rotation_rank(root, source, target, compare_with):
    """Rank body of the rotation at dp = the world: a fresh DLRM step
    restored from the newest checkpoint under ``root/source``, published
    again under ``root/target`` (when given); with ``compare_with``, the
    whole restored state against that checkpoint's, bitwise."""
    from pathlib import Path

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.converter import gather_to_host
    from paddle_tpu_torch.distributed.checkpoint import flatten
    from paddle_tpu_torch.distributed.embedding import EmbeddingCheckpointRotation
    from paddle_tpu_torch.distributed.resilience import CheckpointManager
    from paddle_tpu_torch.models.dlrm import DLRM, DLRMCriterion
    from paddle_tpu_torch.optimizer import RowSparseAdam

    root = Path(root)
    cfg = dlrm_config()
    fleet.init(is_collective=True, strategy=_dp_strategy(dist.get_world_size()))
    model = DLRM(cfg, seed=SEED + 7)  # other weights: the restore must overwrite them
    opt = RowSparseAdam(learning_rate=DLRM_SHARDED["lr"], parameters=model.parameters(),
                        sparse_params=model.sparse_param_names())
    step = fleet.distributed_step(model, opt, DLRMCriterion())
    rot = EmbeddingCheckpointRotation(CheckpointManager(str(root / source)), every=1,
                                      table_names=model.sparse_param_names())
    t0 = time.perf_counter()
    _, at = rot.restore(target=step)
    restore_s = time.perf_counter() - t0
    out = dict(at=at, restore_seconds=restore_s, rows=list(model.embedding.rows))
    if target is not None:
        EmbeddingCheckpointRotation(CheckpointManager(str(root / target)), every=1,
                                    table_names=model.sparse_param_names()).save(step, at)
    if compare_with is not None:
        whole = dict(flatten(gather_to_host(step)))
        saved, _ = CheckpointManager(str(root / compare_with)).restore_latest()
        saved = dict(flatten(saved))
        same = whole.keys() == saved.keys() and all(
            torch.equal(torch.as_tensor(whole[k]), torch.as_tensor(saved[k])) for k in saved)
        out.update(bitwise=same, leaves=len(saved))
    fleet._hcg = None
    return out


def phase_dlrm_sharded_train():
    """``bench_recsys.py:49-54`` at 4 shards (:data:`DLRM_SHARDED`): one
    process's 8 ``run_steps`` steps on the card from the weights it writes,
    then 4 gloo processes on ``cuda:0``, each holding 200,000 table rows
    and its block of each global batch. Gates: each rank's lookup and table
    gradient of batch 0 bitwise equal to the one-process lookup's (a single
    shard's ``F.embedding`` and its backward over the whole batch); the
    losses, the rank's rows and moments within :data:`DLRM_SHARDED_TOL` of
    the one-process run; then the rotation dp 4 -> dp 2 -> dp 4, the
    restored state bitwise equal to the saved one. Prints s a step, the
    bytes staged through the host a rank, ``exchange_stats``'s bytes
    against the exchange counters, and the rows each rank owns of a
    batch's unique ids. Returns the launches (none: the path runs no repo
    kernel)."""
    import gc
    import shutil

    from paddle_tpu_torch.distributed.embedding import exchange_stats
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.dlrm import DLRM, DLRMCriterion
    from paddle_tpu_torch.optimizer import RowSparseAdam
    from paddle_tpu_torch.testing.dist import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    c = DLRM_SHARDED
    cfg = dlrm_config()
    root = _ckpt_dir("dlrm_sharded")
    t0 = time.perf_counter()
    try:
        model = DLRM(cfg, seed=SEED)
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                   root / "weights.pt")
        batches = dlrm_batches(cfg, c["batch"], c["steps"], 1, seed=SEED + 1)[0]
        witness = _dlrm_grad_witness(model, batches[0], c["shards"])
        torch.save({k: witness.pop(k) for k in ("whole", "blocks")}, root / "witness.pt")
        opt = RowSparseAdam(learning_rate=c["lr"], parameters=model.parameters(),
                            sparse_params=model.sparse_param_names())
        step = TrainStep(model, opt, DLRMCriterion())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one = step.run_steps(batches)
        one_losses = [float(v) for v in one["loss"]]
        one_s = (time.perf_counter() - t1) / c["steps"]
        torch.save({"losses": one_losses, **{k: t.detach().cpu() for k, t in zip(
            ("table", "m", "v"), _table_state(model, opt))}}, root / "one.pt")
        del model, opt, step, one
        gc.collect()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        ranks = run_ranks(_dlrm_sharded_rank, c["shards"], str(root), device="cuda:0",
                          backend="gloo", timeout=c["timeout"])
        t3 = time.perf_counter()
        down = run_ranks(_dlrm_rotation_rank, 2, str(root), "ckpt_a", "ckpt_b", None,
                         device="cuda:0", backend="gloo", timeout=c["timeout"])
        up = run_ranks(_dlrm_rotation_rank, c["shards"], str(root), "ckpt_b", None, "ckpt_a",
                       device="cuda:0", backend="gloo", timeout=c["timeout"])
        t4 = time.perf_counter()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tol = DLRM_SHARDED_TOL
    loss_ok = all(abs(a - b) <= tol["atol"] + tol["rtol"] * abs(b)
                  for r in ranks for a, b in zip(r["losses"], one_losses))
    table_rel_l2 = math.sqrt(sum(r["held"]["table"]["sq_err"] for r in ranks)
                             / sum(r["held"]["table"]["sq_ref"] for r in ranks))
    touched_rel_l2 = math.sqrt(sum(r["held"]["table"]["touched_sq_err"] for r in ranks)
                               / sum(r["held"]["table"]["touched_sq_ref"] for r in ranks))
    outliers = [o for r in ranks for o in r["outliers"]]
    step1 = [r["step1"] for r in ranks]
    noise_m = all(abs(o["d_m"]) > tol["noise_m_rel"] * abs(o["m"]) for o in outliers)
    stats = exchange_stats(c["batch"] * cfg.num_sparse, cfg.total_vocab, cfg.embedding_dim,
                           c["shards"])
    moved = sum(r["host_staged_bytes_per_step"] for r in ranks) / 2  # copied out and back in
    counted = sum(r["a2a_bytes_per_step"] for r in ranks)
    offsets = np.cumsum((0,) + cfg.vocab_sizes[:-1])
    uniq = np.unique(batches[0][0][1] + offsets)
    owner_rows = np.bincount(uniq // (cfg.total_vocab // c["shards"]),
                             minlength=c["shards"]).tolist()
    launches = {n: sum(r["launches"][n] for r in ranks) for n in ranks[0]["launches"]}
    ok = (all(r["lookup_bitwise"] and r["grad_bitwise"] for r in ranks) and loss_ok
          and all(h["ok"] for r in ranks for h in r["held"].values())
          and touched_rel_l2 <= tol["touched_rel_l2"] and noise_m
          and all(w["blocks_bitwise"] for w in step1)
          and all(np.isfinite(r["losses"]).all() for r in ranks)
          and counted == stats["bytes_total"] and moved == stats["bytes_total"]
          and all(d["at"] == c["steps"] for d in down + up)
          and all(u["bitwise"] for u in up)
          and ranks[0]["rows_checkpointed"] == cfg.total_vocab
          and all(v == 0 for v in launches.values()))
    emit(phase="dlrm_sharded_train", ok=ok, backend="gloo", device="cuda:0", shards=c["shards"],
         batch=c["batch"], total_vocab=cfg.total_vocab, embedding_dim=cfg.embedding_dim,
         steps=c["steps"], one_process_losses=one_losses, one_process_seconds_per_step=one_s,
         ranks=[{k: r[k] for k in ("rank", "rows", "lookup_bitwise", "grad_bitwise", "losses",
                                   "seconds_per_step", "host_staged_bytes_per_step",
                                   "a2a_bytes_per_step", "ids_exchanged_per_step", "held",
                                   "save_seconds", "rows_checkpointed")} for r in ranks],
         tol=tol, table_rel_l2=table_rel_l2, table_touched_rel_l2=touched_rel_l2,
         table_reach=2 * c["lr"] * c["steps"], witness=witness,
         step1=step1, outside_ref_gate=len(outliers), outliers_m_noise=noise_m,
         outliers=outliers,
         moments_touched=[r["moments_touched"] for r in ranks],
         exchange_stats_bytes_per_step=stats["bytes_total"],
         exchange_counter_bytes_per_step=counted, exchange_moved_bytes_per_step=moved,
         owner_rows_of_batch0_unique_ids=owner_rows, unique_ids_batch0=int(uniq.size),
         rotation=dict(down=down, up=up), launches=launches,
         seconds=dict(one_process=t2 - t0, world4=t3 - t2, rotation=t4 - t3))
    if not ok:
        raise AssertionError("dlrm_sharded_train phase failed")
    return launches


def phase_zero_offload_gpt3_train(gpt3_losses, zero_peak, zero_ms):
    """``zero_gpt3_train``'s step with ``sharding_configs.offload``: the same
    model, batch and 8 steps from the same seed through
    ``fleet.distributed_step`` at ZeRO stage 2 in a world of one over NCCL,
    the AdamW moments in pinned host memory, streamed through the card
    chunk by chunk for the update. Gates: the losses bitwise equal to
    ``gpt3_1p3b_train``'s, 96 K1 and 48 K2 launches a step, the moments
    pinned on the host, the peak device memory below ``zero_gpt3_train``'s.
    Prints the peak against it, the pinned bytes, ms a step and the last
    update's copy times. Returns the launches of the 8 counted steps."""
    import gc

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import DistributedStrategy, fleet, init_parallel_env
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    init_parallel_env()
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "sharding_degree": 1}
    strategy.sharding = True
    strategy.sharding_configs = {"sharding_stage": 2, "offload": True}
    strategy.amp = True
    strategy.amp_configs = {"level": "O2", "dtype": "bfloat16"}
    strategy.pipeline_configs = {"accumulate_steps": GPT3_TRAIN["accumulate"]}
    fleet.init(is_collective=True, strategy=strategy)
    backend, world = dist.get_backend(), dist.get_world_size()
    cfg = GPTConfig.gpt3_1p3b(recompute=True, recompute_granularity="selective")
    b, s = GPT3_TRAIN["batch"], GPT3_TRAIN["seq"]
    n_steps = GPT3_TRAIN["warmup"] + GPT3_TRAIN["steps"]
    try:
        model = GPTForPretraining(cfg, seed=SEED)
        n_params = sum(p.numel() for p in model.parameters())
        opt = AdamW(learning_rate=GPT3_TRAIN["lr"], parameters=model.parameters())
        step = fleet.distributed_step(model, opt, GPTPretrainingCriterion())
        ids = fleet.shard_batch(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s))
                                .astype(np.int32))
        registry.clear_cache()
        before = read_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(ids, ids)["loss"]) for _ in range(GPT3_TRAIN["warmup"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = [step(ids, ids)["loss"] for _ in range(GPT3_TRAIN["steps"])]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        losses += [float(x) for x in timed]
        launches = {k: v - before[k] for k, v in read_launches().items()}
        peak = torch.cuda.max_memory_allocated()
        stats = opt.offload_stats()
        on_host = all(t.device.type == "cpu" and t.is_pinned()
                      for ts in opt._state.values() for t in ts)
        offloaded = opt._offload
    finally:
        dist.destroy_process_group()
        fleet._hcg = None
    L, k = cfg.num_layers, GPT3_TRAIN["accumulate"]
    want = {K1["name"]: 2 * L * k, K2["name"]: L * k, K3["name"]: 0, K3B["name"]: 0,
            K4["name"]: 0, K4B["name"]: 0}
    per_step = {n: v / n_steps for n, v in launches.items()}
    bitwise = losses == gpt3_losses
    moment_bytes = 2 * n_params * 4
    ms_per_step = 1e3 * seconds / GPT3_TRAIN["steps"]
    ok = (backend == "nccl" and world == 1 and offloaded and on_host and bitwise
          and per_step == want and stats["pinned_bytes"] == moment_bytes and peak < zero_peak)
    emit(phase="zero_offload_gpt3_train", ok=ok, backend=backend, world_size=world, stage=2,
         offload=offloaded, ids=[b, s], params=n_params, losses=losses,
         losses_bitwise_equal_gpt3_train=bitwise, launches=launches, launches_per_step=per_step,
         max_memory_allocated=peak, zero_gpt3_train_max_memory_allocated=zero_peak,
         device_bytes_saved=zero_peak - peak, moment_bytes=moment_bytes,
         pinned_host_bytes=stats["pinned_bytes"], chunks_per_update=stats["chunks"],
         copy_in_ms_last_update=stats["copy_in_ms"], copy_out_ms_last_update=stats["copy_out_ms"],
         copy_bytes_each_way=moment_bytes, ms_per_step=ms_per_step,
         zero_gpt3_train_ms_per_step=zero_ms)
    if not ok:
        raise AssertionError("zero_offload_gpt3_train phase failed")
    return launches


# offload_guard_check: a GPT small enough that its AdamW state (176 MB) is
# one offload chunk; ZeRO stage 2 and AMP O2 at world 1 over NCCL, the guard
# on and NaN gradients at dispatch 1. From dispatch 1 on, a sleep kernel of
# DP_HOLD_CYCLES (about 50 ms) holds the offload's copy-out stream before
# each dispatch, so the update's copies back to the host land long after
# its core: a guard that set the host moments back without waiting for them
# would be overwritten by the bad step's moments, or would write stale ones
# back over a clean step's
OFFLOAD_GUARD = dict(cfg=dict(vocab_size=8192, hidden_size=1024, num_layers=1, num_heads=16,
                              max_seq_len=1024), batch=4, seq=1024, lr=1e-4, steps=3, nan_at=1)


def _offload_guard_run(offload):
    """``OFFLOAD_GUARD``'s steps through ``fleet.distributed_step``, the
    optimizer state offloaded or not: the losses, the skipped count, the
    state after each dispatch (host copies), the offload's chunks, and
    whether the state was pinned on the host."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import DistributedStrategy, fleet, init_parallel_env
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing import chaos

    c = OFFLOAD_GUARD
    init_parallel_env()
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "sharding_degree": 1}
    strategy.sharding = True
    strategy.sharding_configs = {"sharding_stage": 2, "offload": offload}
    strategy.amp = True
    strategy.amp_configs = {"level": "O2", "dtype": "bfloat16"}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        cfg = GPTConfig(**c["cfg"])
        model = GPTForPretraining(cfg, seed=SEED)
        opt = AdamW(learning_rate=c["lr"], parameters=model.parameters())
        with chaos.inject(FLAGS_chaos_nan_at_step=c["nan_at"], FLAGS_train_guard=True):
            step = fleet.distributed_step(model, opt, GPTPretrainingCriterion())
        ids = fleet.shard_batch(np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                                   (c["batch"], c["seq"]))
                                .astype(np.int32))
        losses, states = [], []
        for i in range(c["steps"]):
            if offload and i >= c["nan_at"]:
                with torch.cuda.stream(opt._side[1]):  # the copy-out stream
                    torch.cuda._sleep(DP_HOLD_CYCLES)
            losses.append(float(step(ids, ids)["loss"]))
            st = step.state  # settles the flag and waits for the offload's copies
            states.append({"params": {n: t.detach().cpu().clone()
                                      for n, t in st["params"].items()},
                           "opt": {k: {n: t.detach().cpu().clone() for n, t in tree.items()}
                                   for k, tree in st["opt"].items()}})
        stats = opt.offload_stats()
        pinned = all(t.device.type == "cpu" and t.is_pinned()
                     for ts in opt._state.values() for t in ts)
        skipped = step.skipped
    finally:
        dist.destroy_process_group()
        fleet._hcg = None
    return dict(losses=losses, skipped=skipped, states=states,
                chunks=None if stats is None else stats["chunks"], pinned=pinned)


def _same_state(a, b):
    return (a["params"].keys() == b["params"].keys()
            and all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
            and all(torch.equal(a["opt"][k][n], b["opt"][k][n]) for k in a["opt"]
                    for n in a["opt"][k]))


def phase_offload_guard_check():
    """ZeRO offload under the training guard (``OFFLOAD_GUARD``): 3 steps
    with NaN gradients at dispatch 1, with the optimizer state offloaded and
    without, the offloaded run's copies out held late by a sleep kernel.
    Gates: the bad step skipped and leaving every f32 master and moment of
    the offloaded run bitwise; each dispatch's state and loss of the
    offloaded run equal in bits to the run without offload (the guard reads
    the moments on the host only after the update's copies out land); the
    state pinned on the host, in one chunk."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    off, plain = _offload_guard_run(True), _offload_guard_run(False)
    bad = OFFLOAD_GUARD["nan_at"]
    unchanged = _same_state(off["states"][bad - 1], off["states"][bad])
    same = [_same_state(a, b) for a, b in zip(off["states"], plain["states"])]
    ok = (off["pinned"] and off["chunks"] == 1 and off["skipped"] == plain["skipped"] == 1
          and unchanged and all(same) and off["losses"] == plain["losses"]
          and off["losses"][bad + 1] == off["losses"][bad])
    emit(phase="offload_guard_check", ok=ok, config=OFFLOAD_GUARD, losses=off["losses"],
         plain_losses=plain["losses"], skipped=off["skipped"], bad_step_state_bitwise=unchanged,
         state_bitwise_without_offload=same, chunks=off["chunks"], pinned=off["pinned"])
    if not ok:
        raise AssertionError("offload_guard_check phase failed")


def _amp_gpt_model():
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining

    return GPTForPretraining(GPTConfig(**SERVE_CFG, stacked=False), seed=SEED)


def _amp_ids(vocab):
    c = AMP_GPT
    return torch.randint(0, vocab, (c["batch"], c["seq"]), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(SEED + 2))


def _dtype_launches():
    from paddle_tpu_torch.ops import flash_attention as fa

    return {w.__name__: dict(w.launches_by_dtype)
            for w in (fa.flash_attention_fwd, fa.flash_attention_bwd)}


def _dtype_counts(dtype):
    return {n: counts.get(dtype, 0) for n, counts in _dtype_launches().items()}


def _with_overrides(overrides, fn):
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import registry

    registry.clear_cache()
    set_flags({"FLAGS_kernel_overrides": overrides})
    try:
        return fn()
    finally:
        set_flags({"FLAGS_kernel_overrides": ""})
        registry.clear_cache()


def phase_amp_o1_gpt_train():
    """bench.py's train GPT (per-layer trunk) under ``TrainStep(amp_level=
    "O1", amp_dtype="bfloat16")``: its linears and attention in bf16 by the
    AMP lists, LayerNorms and the loss in f32, f32 weights; 3 AdamW steps at
    [8, 1024], through K1/K2 and again with the plain attention (sdpa=xla)
    from the same weights. Gates: the bf16 instances of K1 and K2 launched
    exactly 16 times a step each (and no other instance); the plain run
    none; the losses within ``AMP_LOSS_RTOL`` of the plain run's. Returns
    the launches of the kernel run."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    c = AMP_GPT
    model = _amp_gpt_model()
    start = {n: t.clone() for n, t in model.state_dict().items()}
    ids = _amp_ids(model.gpt.cfg.vocab_size)

    def run():
        model.load_state_dict(start)
        step = TrainStep(model, AdamW(learning_rate=c["lr"], parameters=model.parameters()),
                         GPTPretrainingCriterion(), amp_level="O1", amp_dtype="bfloat16")
        reset_launches()
        losses = [float(step(ids, ids)["loss"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [float(step(ids, ids)["loss"]) for _ in range(c["o1_steps"] - 1)]
        ms = 1e3 * (time.perf_counter() - t0) / (c["o1_steps"] - 1)
        return (losses, read_launches(), _dtype_counts("bfloat16"), ms,
                all(p.dtype == torch.float32 for p in model.parameters()))

    losses, launches, bf16, ms, f32_weights = _with_overrides("", run)
    plain, plain_launches, _, plain_ms, _ = _with_overrides("sdpa=xla", run)
    L = model.gpt.cfg.num_layers
    want = L * c["o1_steps"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    ok = (bf16 == {K1["name"]: want, K2["name"]: want}
          and launches == {**{K["name"]: 0 for K in KERNELS}, K1["name"]: want, K2["name"]: want}
          and all(v == 0 for v in plain_launches.values()) and f32_weights
          and all(np.isfinite(losses)) and max(rel) <= AMP_LOSS_RTOL["bfloat16"])
    emit(phase="amp_o1_gpt_train", ok=ok, amp_level="O1", amp_dtype="bfloat16", trunk="per-layer",
         ids=[c["batch"], c["seq"]], losses=losses, plain_losses=plain, loss_rel_err=rel,
         loss_rtol=AMP_LOSS_RTOL["bfloat16"], bf16_launches=bf16, launches=launches,
         expected_bf16_launches_each=want, ms_per_step=ms, plain_ms_per_step=plain_ms)
    if not ok:
        raise AssertionError("amp_o1_gpt_train phase failed")
    del model, start
    return launches


def phase_fp16_gpt_train():
    """The same GPT trained eagerly in float16: the forward under
    ``auto_cast(dtype="float16")``, the loss outside it, ``loss.backward()``
    through ``GradScaler.scale``, ``GradScaler.step`` over the eager AdamW;
    5 steps, an inf planted in one gradient of step 1. Then the same with
    the plain attention. Gates: the float16 instances of K1 and K2 launched
    exactly 16 times a step each; step 1 skipped, the parameters bitwise
    as before it and the scale halved; the scale doubled after
    ``incr_every_n_steps`` clean steps; the losses finite and within
    ``AMP_LOSS_RTOL`` of the plain run's. Returns the launches of the
    kernel run."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    c = AMP_GPT
    model = _amp_gpt_model()
    start = {n: t.clone() for n, t in model.state_dict().items()}
    ids = _amp_ids(model.gpt.cfg.vocab_size)
    crit = GPTPretrainingCriterion()

    def run():
        model.load_state_dict(start)
        opt = AdamW(learning_rate=c["lr"], parameters=model.parameters())
        scaler = amp.GradScaler(**FP16_SCALER)
        reset_launches()
        losses, scales, skipped_unchanged, dtypes = [], [], None, set()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(c["fp16_steps"]):
            with amp.auto_cast(dtype="float16"):
                logits = model(ids)
            dtypes.add(str(logits.dtype))
            loss = crit(logits, ids)
            scaler.scale(loss).backward()
            if i == FP16_PLANT_STEP:
                params = [p.detach().clone() for p in model.parameters()]
                next(model.parameters()).grad.view(-1)[0] = float("inf")
            scaler.step(opt)
            opt.clear_grad()
            if i == FP16_PLANT_STEP:
                skipped_unchanged = all(torch.equal(a, p) for a, p in zip(params, model.parameters()))
                del params
            losses.append(float(loss))
            scales.append(scaler.get_loss_scaling())
        ms = 1e3 * (time.perf_counter() - t0) / c["fp16_steps"]
        return (losses, scales, skipped_unchanged, read_launches(), _dtype_counts("float16"), ms,
                sorted(dtypes))

    losses, scales, unchanged, launches, f16, ms, dtypes = _with_overrides("", run)
    plain, plain_scales, _, plain_launches, _, plain_ms, _ = _with_overrides("sdpa=xla", run)
    L = model.gpt.cfg.num_layers
    want = L * c["fp16_steps"]
    init = FP16_SCALER["init_loss_scaling"]
    p, n = FP16_PLANT_STEP, FP16_SCALER["incr_every_n_steps"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    ok = (f16 == {K1["name"]: want, K2["name"]: want}
          and launches == {**{K["name"]: 0 for K in KERNELS}, K1["name"]: want, K2["name"]: want}
          and all(v == 0 for v in plain_launches.values()) and dtypes == ["torch.float16"]
          and unchanged and scales[p] == init / 2 and scales[p + n] == init
          and scales == plain_scales and all(np.isfinite(losses))
          and max(rel) <= AMP_LOSS_RTOL["float16"])
    emit(phase="fp16_gpt_train", ok=ok, amp_dtype="float16", trunk="per-layer", eager=True,
         ids=[c["batch"], c["seq"]], losses=losses, plain_losses=plain, loss_rel_err=rel,
         loss_rtol=AMP_LOSS_RTOL["float16"], scales=scales, planted_inf_step=p,
         skipped_step_params_bitwise=unchanged, scaler=FP16_SCALER, f16_launches=f16,
         launches=launches, expected_f16_launches_each=want, ms_per_step=ms,
         plain_ms_per_step=plain_ms, logits_dtypes=dtypes)
    if not ok:
        raise AssertionError("fp16_gpt_train phase failed")
    del model, start
    return launches


def _mp_decode_rank(ids, new_tokens):
    """Rank body of ``mp_decode``: the serving GPT from the same seed under
    ``fleet.init(mp_degree=2)`` (each rank drawing every weight and keeping
    its shards), greedy ``generate``; the tokens, each step's whole logits
    (the gathered vocabulary shards, as the pick sees them), the decode's
    seconds and the kernel launches (none: decoding attends in plain
    PyTorch)."""
    import paddle_tpu_torch.models.gpt as G
    from paddle_tpu_torch.distributed import DistributedStrategy, fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    strat = DistributedStrategy()
    strat.hybrid_configs = {"mp_degree": MP_DECODE["mp"]}
    fleet.init(is_collective=True, strategy=strat)
    hcg = fleet.get_hybrid_communicate_group()
    model = G.GPTForPretraining(G.GPTConfig(**SERVE_CFG), device="cuda", seed=SEED).eval()
    model.generate(ids.cuda(), max_new_tokens=2)  # warm-up
    reset_launches()
    tokens, logits, seconds = _decode_with_logits(model, ids.cuda(), new_tokens)
    return dict(tokens=tokens, logits=logits, seconds=seconds, launches=read_launches(),
                mp_rank=hcg.get_model_parallel_rank(), heads=model.gpt.layers.num_heads,
                qkv=list(model.gpt.layers.qkv_w.shape))


def _decode_with_logits(model, ids, new_tokens):
    """``model.generate(ids, new_tokens)`` (greedy, synchronised and timed),
    with the logits of every pick recorded: ``(tokens, [steps, b, V] f32
    logits on the host, seconds)``."""
    import paddle_tpu_torch.models.gpt as G

    seen, pick = [], G._select_token

    def recording(logits, *args):
        seen.append(logits.detach().float().cpu())
        return pick(logits, *args)

    G._select_token = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = model.generate(ids, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        G._select_token = pick
    return tokens.cpu(), torch.stack(seen), seconds


def phase_mp_decode(model):
    """GPT decoding at mp 2: the serving GPT's greedy ``generate`` of
    ``MP_DECODE["new_tokens"]`` tokens on ``[4, 64]`` prompts, by this
    process and by two gloo processes on ``cuda:0`` at mp 2 (each with half
    the heads, its half of the KV cache and of the vocabulary). Gate: the
    tokens are bitwise equal on both ranks and to this process's. Shown per
    step: the largest logit difference from this process's and the
    smallest top-2 margin of its logits (a near tie would show there)."""
    import gc

    from paddle_tpu_torch.testing.dist import run_ranks

    M = MP_DECODE
    t_phase = time.perf_counter()
    ids = torch.randint(0, SERVE_CFG["vocab_size"], (M["batch"], M["prompt"]), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 5))
    model.generate(ids, max_new_tokens=2)  # warm-up
    want, logits, seconds = _decode_with_logits(model, ids, M["new_tokens"])
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(_mp_decode_rank, M["mp"], ids.cpu(), M["new_tokens"], device="cuda:0",
                      backend="gloo", timeout=M["timeout"])
    world_s = time.perf_counter() - t0
    top2 = logits.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).amin(dim=-1)  # [steps]
    diffs = [(o["logits"] - logits).abs().amax(dim=(1, 2)).tolist() for o in ranks]
    equal = [torch.equal(o["tokens"], want) for o in ranks]
    no_kernel = {n: 0 for n in read_launches()}
    ok = (all(equal) and torch.equal(ranks[0]["tokens"], ranks[1]["tokens"])
          and all(o["launches"] == no_kernel for o in ranks)
          and all(o["heads"] == SERVE_CFG["num_heads"] // M["mp"] for o in ranks))
    emit(phase="mp_decode", ok=ok, mp=M["mp"], backend="gloo", device="cuda:0",
         prompts=[M["batch"], M["prompt"]], new_tokens=M["new_tokens"], config=SERVE_CFG,
         tokens_equal_one_process_by_rank=equal,
         max_logit_diff_by_step_by_rank=diffs, top2_margin_min_by_step=margin.tolist(),
         ms_per_token_one_process=1e3 * seconds / M["new_tokens"],
         ms_per_token_by_rank=[1e3 * o["seconds"] / M["new_tokens"] for o in ranks],
         heads_by_rank=[o["heads"] for o in ranks], qkv_shard_by_rank=[o["qkv"] for o in ranks],
         world_seconds=world_s, seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError("mp_decode: the mp 2 tokens differ from one process's (see the "
                             "logit differences and top-2 margins)")


def _ckpt_dir(name):
    """A fresh directory under this checkout's ``build/`` (gitignored)."""
    import shutil
    from pathlib import Path

    d = Path(__file__).resolve().parent / "build" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def _gpt_o2_step(cfg, guard):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForPretraining(cfg, seed=SEED)
    return TrainStep(model, AdamW(learning_rate=TRAIN["lr"], parameters=model.parameters()),
                     GPTPretrainingCriterion(), amp_level="O2", guard=guard)


def _states_equal(a, b):
    """Whether two whole host states (``converter.gather_to_host``) hold the
    same leaves, bit for bit."""
    from paddle_tpu_torch.distributed.checkpoint import flatten

    fa, fb = dict(flatten(a)), dict(flatten(b))
    return set(fa) == set(fb) and all(
        torch.equal(torch.as_tensor(fa[k]), torch.as_tensor(fb[k])) for k in fa)


def phase_resilient_gpt_train():
    """train's O2 GPT (``[8, 1024]``, AdamW) with ``guard=True`` through
    ``run_resilient``: a ``CheckpointManager`` under ``build/``
    (``keep_last_k`` 2), a checkpoint every 2 steps, 6 steps, one
    ``ElasticNode`` over an in-process TCPStore, and three faults: a crash
    of the ``train_step`` point at step 3, the HOLD checkpoint of that
    crash corrupted on disk (so the restore walks back to step 2), and NaN
    gradients at dispatch 4, which the guard skips. Gates: the loss of every
    step equals in bits that of an uninterrupted guarded run on the same
    batch (its NaN at the same dispatch); the skipped step leaves the
    state bitwise; the restored state is bitwise the state saved at step 2,
    leaf by leaf; K1 and K2 16 times per dispatch (7 dispatches). Shows the
    checkpoint's bytes and the seconds of each save (gather, write, CRC)
    and restore (read, CRC, convert)."""
    import gc
    import shutil

    from paddle_tpu_torch.distributed.checkpoint import load_state
    from paddle_tpu_torch.distributed.converter import gather_to_host
    from paddle_tpu_torch.distributed.elastic import ElasticNode
    from paddle_tpu_torch.distributed.resilience import CheckpointManager, run_resilient
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.testing import chaos

    R = RESILIENT
    t_phase = time.perf_counter()
    cfg = GPTConfig(**SERVE_CFG)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN["batch"], TRAIN["seq"]), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
    with chaos.inject(FLAGS_chaos_nan_at_step=R["nan_at"]):
        plain = _gpt_o2_step(cfg, guard=True)
    want = [float(plain(ids, ids)["loss"]) for _ in range(R["steps"])]
    want_skipped = plain.state["skipped"]
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    d = _ckpt_dir("resilient_ckpt")
    with chaos.inject(FLAGS_chaos_nan_at_step=R["nan_at"]):
        step = _gpt_o2_step(cfg, guard=True)
    mgr = CheckpointManager(str(d), keep_last_k=R["keep_last_k"])
    saves, restores, events, losses, checks = [], [], [], {}, {}
    save = mgr.save

    def timed_save(state, n):
        out = save(state, n)
        saves.append(dict(step=n, **mgr.last_save))
        return out

    mgr.save = timed_save

    def on_event(kind, info):
        events.append((kind, info.get("step")))
        if kind == "hold":  # the HOLD checkpoint of the crash lands corrupted
            set_flags({"FLAGS_chaos_corrupt_ckpt": True})
        elif kind == "resume":
            set_flags({"FLAGS_chaos_corrupt_ckpt": False})
            restores.append(dict(step=info["step"], **mgr.last_restore))
            saved = load_state(os.path.join(mgr._step_dir(info["step"]), "state"))
            checks["restored_bitwise"] = _states_equal(gather_to_host(step), saved)

    def train(ts, n, members):
        bad_next = ts._dispatched == R["nan_at"]
        before = gather_to_host(ts) if bad_next else None
        m = ts(ids, ids)
        losses[n] = float(m["loss"])
        if bad_next:  # the skipped step: the state as it was, the skip counted
            after = gather_to_host(ts)
            checks["skipped_step_bitwise"] = (
                bool(m["health"]["bad_step"]) and after.pop("skipped") == before.pop("skipped") + 1
                and _states_equal(before, after))
        return ts

    store = TCPStore(is_master=True, timeout=60.0)
    node = ElasticNode(store, heartbeat_interval=0.2, timeout=5.0)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with chaos.inject(FLAGS_chaos_crash_point="train_step",
                          FLAGS_chaos_crash_at_step=R["crash_at"]):
            _, restarts = run_resilient(train, node=node, manager=mgr, init_state=step,
                                        num_steps=R["steps"], checkpoint_every=R["every"],
                                        max_restarts=2, backoff=0.0, settle=0.0,
                                        on_event=on_event)
    finally:
        node.leave()
        store.close()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    got = [losses[n] for n in range(R["steps"])]
    ckpt_bytes = saves[0]["bytes"] if saves else 0
    shutil.rmtree(d, ignore_errors=True)
    n_calls = 7  # steps 0-2, the crash at 3, then 2-5 again
    per = cfg.num_layers * n_calls
    want_launch = {K1["name"]: per, K2["name"]: per, K3["name"]: 0,
                   K3B["name"]: 0, K4["name"]: 0, K4B["name"]: 0}
    ok = ([x.hex() for x in got] == [x.hex() for x in want] and restarts == 1
          and checks.get("restored_bitwise") is True and checks.get("skipped_step_bitwise") is True
          and step.state["skipped"] == want_skipped == 1 and launches == want_launch
          and [e for e in events if e[0] in ("hold", "resume")] == [("hold", 3), ("resume", 2)])
    emit(phase="resilient_gpt_train", ok=ok, ids=[TRAIN["batch"], TRAIN["seq"]],
         amp_level="O2", guard=True, faults=dict(crash_at=R["crash_at"], corrupted="hold",
                                                 nan_at_dispatch=R["nan_at"]),
         losses=got, uninterrupted_losses=want, losses_bitwise=[x.hex() for x in got] == [
             x.hex() for x in want], events=events, restarts=restarts, checks=checks,
         skipped=step.state["skipped"], launches=launches, expected_launches=want_launch,
         dispatches=n_calls, checkpoint_bytes=ckpt_bytes, saves=saves, restores=restores,
         max_memory_allocated=torch.cuda.max_memory_allocated(), run_seconds=run_s,
         seconds=time.perf_counter() - t_phase)
    del step, mgr
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("resilient_gpt_train: a gate failed (losses, restore, skip or "
                             "launches)")
    return launches


def _read_jsonl(path):
    return [json.loads(line) for line in open(path)] if os.path.exists(path) else []


def _launcher(args, log):
    return subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch.distributed.launch", *args],
                            stdout=log, stderr=subprocess.STDOUT)


def phase_elastic_gpt_rescale(train_losses):
    """The launcher's elastic rescale on the card, as ``tests/test_elastic.py:121-171``
    drives it: two launchers (``--nnodes 2 --nproc_per_node 1 --elastic_np
    1:2``, node ranks 0 and 1) run ``examples/elastic_gpt_torch.py``: train's
    O2 GPT at sdp 2 with ZeRO-2, two gloo workers on ``cuda:0``, the global
    batch ``[8, 1024]``, a checkpoint every step (written whole by rank 0).
    After ``ELASTIC["world_steps"]`` steps the second node leaves (SIGTERM);
    the first launcher relaunches its worker at world 1 (NCCL), which
    restores the sdp-2 checkpoint through the converter and trains to
    ``ELASTIC["total_steps"]``. Gates: the
    restored world-1 state gathered back is bitwise the sdp-2 checkpoint;
    the world-1 losses equal in bits those of this process loading the same
    checkpoint; every step's loss within ``ELASTIC_LOSS_RTOL`` of train's
    at that step (the same weights and batch; the world-1 step's loss
    follows the workers' sdp-2 update); every worker's step
    launched K1 and K2 once per layer and no other kernel (each step's
    counts, set to 0 just before it, as the workers log them). Returns those
    launches summed over the workers' steps. Then ``--serve``: the
    launcher boots 2 replicas of the serving GPT on the card,
    ``ProcServingFleet.attach`` serves 8 requests, the tokens equal an
    in-process fleet's, and after ``shutdown()`` the launcher exits 0."""
    import gc
    import shutil
    import socket
    from pathlib import Path

    from paddle_tpu_torch.distributed.resilience import CheckpointManager
    from paddle_tpu_torch.models.gpt import GPTConfig

    E = ELASTIC
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = _ckpt_dir("elastic")
    ck, log = str(root / "ckpt"), str(root / "log.jsonl")
    worker = str(Path(__file__).resolve().parent / "examples" / "elastic_gpt_torch.py")

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    common = ["--nnodes", "2", "--nproc_per_node", "1", "--master", f"127.0.0.1:{free_port()}",
              "--elastic_np", "1:2", "--elastic_timeout", "5.0", worker,
              "--config", json.dumps(SERVE_CFG), "--seed", str(SEED), "--batch",
              str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]), "--lr", str(TRAIN["lr"]),
              "--device", "cuda:0", "--ckpt", ck, "--log", log, "--keep", str(E["keep"]),
              "--world_steps", str(E["world_steps"]), "--total_steps", str(E["total_steps"])]
    outs = [open(root / f"launcher{r}.out", "wb") for r in (0, 1)]
    t0 = time.perf_counter()
    a = _launcher(["--rank", "0"] + common, outs[0])
    b = _launcher(["--rank", "1"] + common, outs[1])
    try:
        deadline = time.monotonic() + E["timeout"]
        while sum(e["event"] == "step" for e in _read_jsonl(log)) < E["world_steps"]:
            if time.monotonic() > deadline or a.poll() is not None or b.poll() is not None:
                raise AssertionError("elastic_gpt_rescale: the world-2 steps did not come")
            time.sleep(0.5)
        t_world2 = time.perf_counter() - t0
        b.send_signal(15)  # SIGTERM: the second node leaves
        rc_b = b.wait(timeout=120)
        rc_a = a.wait(timeout=E["timeout"])
    finally:
        for p in (a, b):
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in outs:
            f.close()
    rescale_s = time.perf_counter() - t0 - t_world2
    launcher0 = (root / "launcher0.out").read_text(errors="replace")
    events = _read_jsonl(log)
    steps = [e for e in events if e["event"] == "step"]
    restored = [e for e in events if e["event"] == "restored"]

    # this process loads the same checkpoint and takes the same steps
    cfg = GPTConfig(**SERVE_CFG)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN["batch"], TRAIN["seq"]), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
    one = _gpt_o2_step(cfg, guard=False)
    CheckpointManager(ck, keep_last_k=E["keep"])._load_verified(E["world_steps"], one, None)
    reset_launches()
    mine = [float(one(ids, ids)["loss"]).hex()
            for _ in range(E["total_steps"] - E["world_steps"])]
    launches = read_launches()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    # every step against train's at that step: the world-1 steps follow the
    # sdp-2 update, which this holds against one process's
    loss_err = [abs(e["loss"] - train_losses[e["step"]]) / abs(train_losses[e["step"]])
                for e in steps]
    world1 = [e["loss_hex"] for e in steps if e["world"] == 1]
    shutil.rmtree(ck, ignore_errors=True)
    # the workers' own launches: K1 and K2 once per layer in each rank's step
    want = {K["name"]: cfg.num_layers if K in (K1, K2) else 0 for K in KERNELS}
    launches_ok = all(e.get("launches_by_rank") == [want] * e["world"] for e in steps)
    worker_launches = {n: sum(r[n] for e in steps for r in e.get("launches_by_rank") or [])
                       for n in want}
    ok_train = (rc_a == 0 and rc_b == 143 and launches_ok
                and [(e["world"], e["step"]) for e in steps]
                == [(2, i) for i in range(E["world_steps"])]
                + [(1, i) for i in range(E["world_steps"], E["total_steps"])]
                and len(restored) == 1 and restored[0]["bitwise"] is True
                and world1 == mine and max(loss_err) <= ELASTIC_LOSS_RTOL)
    serve = _elastic_serve_check(root)
    ok = ok_train and serve["ok"]
    emit(phase="elastic_gpt_rescale", ok=ok, ids=[TRAIN["batch"], TRAIN["seq"]], amp_level="O2",
         zero_stage=2, launcher_rc=[rc_a, rc_b], steps=steps, restored=restored,
         world1_losses_bitwise_one_process=world1 == mine, one_process_losses=mine,
         rel_err_vs_train_by_step=loss_err, loss_rtol=ELASTIC_LOSS_RTOL,
         world2_seconds=t_world2, rescale_and_world1_seconds=rescale_s,
         launches_per_rank_per_step=want, worker_launches_ok=launches_ok,
         worker_launches=worker_launches, one_process_launches=launches,
         membership_lines=[ln for ln in launcher0.splitlines() if "membership=" in ln],
         serve=serve, seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError("elastic_gpt_rescale: a gate failed (see its line)")
    return worker_launches


def _elastic_serve_check(root):
    """``--serve`` on the card: 2 replicas of the serving GPT booted by the
    launcher, adopted by ``ProcServingFleet.attach``, 8 requests against an
    in-process fleet's tokens; the launcher's exit code after shutdown."""
    import socket

    from paddle_tpu_torch.inference import ProcServingFleet, ServingFleet
    from paddle_tpu_torch.inference.procfleet import current_torch_config
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining

    E = ELASTIC
    P = SERVE_PROCFLEET
    kw = dict(max_batch_slots=P["slots"], max_seq_len=P["max_seq_len"], prefill_chunk=P["chunk"],
              fuse=P["fuse"])
    cfg = GPTConfig(**SERVE_CFG)
    prompts = _fleet_prompts(cfg.vocab_size, P["chunk"], E["serve_requests"], shared=False)
    model = GPTForPretraining(cfg, seed=SEED).eval()
    fids, done, _ = _fleet_run(ServingFleet(model, replicas=1, **kw), prompts,
                               E["serve_new_tokens"])
    want = [list(done[f].tokens) for f in fids]
    del model
    torch.cuda.empty_cache()
    spec = {"ns": "elastic-serve", "model": {"seed": SEED, "config": SERVE_CFG},
            "engine_kwargs": kw, "torch_config": current_torch_config()}
    (root / "serve.json").write_text(json.dumps(spec))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        master = f"127.0.0.1:{s.getsockname()[1]}"
    out = open(root / "serve.out", "wb")
    t0 = time.perf_counter()
    p = _launcher(["--serve", "--nnodes", "1", "--nproc_per_node", str(E["serve_replicas"]),
                   "--master", master, str(root / "serve.json")], out)
    try:
        fleet = ProcServingFleet.attach(master, E["serve_replicas"], ns="elastic-serve",
                                        heartbeat_timeout=P["heartbeat_timeout"],
                                        boot_timeout=300.0, **kw)
        boot_s = time.perf_counter() - t0
        try:
            fids, done, run_s = _fleet_run(fleet, prompts, E["serve_new_tokens"], timeout_s=600)
            got = [list(fleet.requests[f].tokens) for f in fids]
            child = _child_kernel_launches(fleet)
        finally:
            fleet.shutdown()
        rc = p.wait(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        out.close()
    child_launches = sum(n for c in child.values() for n in c.values())
    return dict(ok=got == want and rc == 0 and child_launches == 0,
                replicas=E["serve_replicas"], requests=len(prompts),
                new_tokens=E["serve_new_tokens"], tokens_equal_inproc=got == want,
                launcher_rc=rc, boot_seconds=boot_s, run_seconds=run_s,
                child_kernel_launches=child)


# -- slice 11: dropout and the nn layer library -----------------------------------------------
# dropout_gpt_train: bench.py's train GPT (SERVE_CFG, the stacked trunk)
# with dropout 0.1 and attn_dropout 0.0, AMP O2 over AdamW at [8, 1024]:
# `steps` steps timed after `warmup`; the resume takes the state after
# `resume_at` steps and runs `after` more
DROPOUT_GPT = dict(batch=8, seq=1024, lr=1e-4, p=0.1, warmup=1, steps=3, resume_at=2, after=2)
# the guard's cost with dropout: a guarded TrainStep's stream key reads the
# previous step's bad flag at the step's first draw (a host sync); each of
# the four arms (guard on or off, dropout p or 0) takes one warm step, then
# `guard_steps` timed ones
DROPOUT_GUARD_STEPS = 4
# the first entries of each recorded mask compared across steps, layers and
# sites (equal slices would mean the same stream)
MASK_SLICE = 1 << 16
# dropout_bert_train: BERT-base with dropout 0.1, AMP O2, bert_batch's
# padded [16, 512]; the losses through K3/K3b against those through
# sdpa=xla from the same weights and the same masks (dropout sits outside
# attention), per step within DROPOUT_BERT_RTOL (about 10x the 2.7e-4 read
# on the card: bf16 attention rounded at other places)
DROPOUT_BERT = dict(lr=1e-4, p=0.1, steps=4)
DROPOUT_BERT_RTOL = 3e-3
# transformer_encoder_train: BERT-base's encoder built from the layer
# library, nn.TransformerEncoder(TransformerEncoderLayer(768, 12, 3072,
# dropout=0.1, activation="gelu", attn_dropout=0.0), 12), under word and
# position tables and a tied MLM head, on bert_batch's [16, 512] with its
# padding bias; O2 bf16 through TrainStep, then O1 float16 eagerly with a
# GradScaler; each arm against sdpa=xla from the same weights and masks,
# within about 10x the readings on the card (3.1e-5 in bf16, 3.0e-6 in
# float16)
ENCODER = dict(d_model=768, nhead=12, ffn=3072, layers=12, p=0.1, lr=1e-4, steps=3)
ENCODER_RTOL = {"O2": 3e-4, "O1": 3e-5}
# transformer_base_decode: nn.Transformer() at its defaults (Transformer-base:
# d 512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1) under shared word
# tables of Vaswani et al.'s ~37000-token BPE vocabulary and learned
# positions, f32 (TF32 off), 3 AdamW steps at src/tgt [32, 128]; then greedy
# decoding of 32 tokens for 8 sources, by full recompute, through FixedCache
# and through QuantizedFixedCache
TRANSFORMER_BASE = dict(vocab=37000, batch=32, src=128, tgt=128, lr=1e-4, steps=3, sources=8,
                        new_tokens=32)
# FixedCache decoding's logits against the full recompute's: f32 attention
# over a longer, masked key row sums the same terms in another order
# (about 10x the 4.8e-7 read on the card)
DECODE_LOGITS_ATOL = 5e-6


def _recording_masks(record):
    """Wrap every dropout's mask draw: per draw its shape, keep count (on
    the card) and first MASK_SLICE entries appended to ``record``; returns
    the function to put back."""
    from paddle_tpu_torch.nn.functional import common

    real = common.dropout_mask

    def recording(shape, p, generator=None, device=None):
        keep = real(shape, p, generator, device)
        record.append((tuple(keep.shape), keep.sum(), keep.reshape(-1)[:MASK_SLICE].clone()))
        return keep

    common.dropout_mask = recording
    return real


def _restore_masks(real):
    from paddle_tpu_torch.nn.functional import common

    common.dropout_mask = real


def _keep_shares(record, p):
    """Each recorded draw's keep share and its distance from 1 - p in
    binomial standard deviations."""
    out = []
    for shape, kept, _ in record:
        n = math.prod(shape)
        share = float(kept) / n
        out.append((share, abs(share - (1 - p)) / math.sqrt(p * (1 - p) / n)))
    return out


def phase_dropout_gpt_train():
    """bench.py's train GPT with dropout 0.1 (attn_dropout 0.0) through
    TrainStep O2: the embeddings' and every block's two residual masks drawn
    from the step's stream (keep share within 5 binomial standard
    deviations of 0.9, masks differing between steps, layers and sites);
    exactly 16 K1 and 16 K2 a step; a selective-recompute twin's first step
    with bitwise the loss and gradients of the plain model's; a resume by
    ``state``/``load_state`` giving bitwise the later losses; and a step
    with attn_dropout 0.1, whose attention takes the plain composite (0
    K1/K2), as the reference's predicates route dropout. Returns the
    launches of the plain model's steps, its losses and its global gradient
    norm after the first step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    c = DROPOUT_GPT
    cfg = GPTConfig(**SERVE_CFG, dropout=c["p"])
    twin_cfg = GPTConfig(**SERVE_CFG, dropout=c["p"], recompute=True,
                         recompute_granularity="selective")
    model, twin = GPTForPretraining(cfg, seed=SEED), GPTForPretraining(twin_cfg, seed=SEED)

    def train_step(m):
        return TrainStep(m, AdamW(learning_rate=c["lr"], parameters=m.parameters()),
                         GPTPretrainingCriterion(), amp_level="O2", seed=SEED)

    step, twin_step = train_step(model), train_step(twin)
    ids = torch.randint(0, cfg.vocab_size, (c["batch"], c["seq"]), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
    record = []
    real = _recording_masks(record)
    try:
        reset_launches()
        losses = [float(step(ids, ids)["loss"])]
        first_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        grad1 = grad_norm(model)
        losses.append(float(step(ids, ids)["loss"]))
    finally:
        _restore_masks(real)
    per_step_draws = len(record) // 2
    shares = _keep_shares(record, c["p"])
    first, second = record[:per_step_draws], record[per_step_draws:]
    differ_steps = not any(torch.equal(a[2], b[2]) for a, b in zip(first, second))
    # draw 0 the embeddings, then per layer the residuals 1 and 2
    differ_layers = not torch.equal(first[1][2], first[3][2])
    differ_sites = not torch.equal(first[1][2], first[2][2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(ids, ids)["loss"] for _ in range(c["steps"])]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses += [float(x) for x in timed]
    launches = read_launches()
    n_steps = 2 + c["steps"]
    per_step = {k: v / n_steps for k, v in launches.items()}
    # the recompute twin's first step: the plain model's first step in bits
    reset_launches()
    twin_loss = float(twin_step(ids, ids)["loss"])
    twin_launches = read_launches()
    grads_bitwise = all(torch.equal(p.grad, first_grads[n]) for n, p in twin.named_parameters())
    del first_grads
    # the resume: the plain model's state after its steps, loaded into the
    # twin (recompute changes no bit), then the same later steps
    state = step.state
    saved = {k: ({n: t.clone() for n, t in v.items()} if k in ("params", "buffers") else v)
             for k, v in state.items()}
    saved["opt"] = {k: {n: t.clone() for n, t in tree.items()} for k, tree in state["opt"].items()}
    later = [float(step(ids, ids)["loss"]) for _ in range(c["after"])]
    twin_step.load_state(saved)
    del saved
    resumed = [float(twin_step(ids, ids)["loss"]) for _ in range(c["after"])]
    # attention dropout: the composite, no K1/K2
    twin.gpt.cfg.attn_dropout = c["p"]
    reset_launches()
    attn_loss = float(twin_step(ids, ids)["loss"])
    attn_launches = read_launches()
    guard = _guard_sync_cost(model, ids, c)
    L = cfg.num_layers
    ok = (all(np.isfinite(losses)) and np.isfinite(attn_loss) and guard["finite"]
          and per_step_draws == 1 + 2 * L and all(z <= 5.0 for _, z in shares)
          and differ_steps and differ_layers and differ_sites
          and per_step == {**{K["name"]: 0 for K in KERNELS}, K1["name"]: L, K2["name"]: L}
          and twin_loss == losses[0] and grads_bitwise
          and resumed == later
          and attn_launches[K1["name"]] == 0 and attn_launches[K2["name"]] == 0)
    emit(phase="dropout_gpt_train", ok=ok, ids=[c["batch"], c["seq"]], amp_level="O2",
         dropout=c["p"], attn_dropout=0.0, losses=losses, grad_norm_step1=grad1,
         launches=launches,
         launches_per_step=per_step, draws_per_step=per_step_draws,
         keep_share_min=min(s for s, _ in shares), keep_share_max=max(s for s, _ in shares),
         keep_share_max_sigmas=max(z for _, z in shares), masks_differ_steps=differ_steps,
         masks_differ_layers=differ_layers, masks_differ_sites=differ_sites,
         seconds=seconds, ms_per_step=1e3 * seconds / c["steps"],
         tokens_per_s=c["batch"] * c["seq"] * c["steps"] / seconds,
         selective_recompute=dict(loss=twin_loss, loss_bitwise=twin_loss == losses[0],
                                  grads_bitwise=grads_bitwise, launches=twin_launches),
         resume=dict(at_step=n_steps, later=later, resumed=resumed, bitwise=resumed == later),
         attn_dropout_step=dict(attn_dropout=c["p"], loss=attn_loss, launches=attn_launches),
         guard=guard)
    if not ok:
        raise AssertionError("dropout_gpt_train phase failed")
    return launches, losses, grad1


def _guard_sync_cost(model, ids, c):
    """ms a step of ``model`` through an unguarded and a guarded
    ``TrainStep``, each with dropout ``c["p"]`` and with dropout 0 (no draw,
    so the guarded step reads its flag only at its update). ``sync_ms``:
    what the guard costs with dropout beyond what it costs without, the
    price of the host read at the first draw."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    def make(guard):
        return TrainStep(model, AdamW(learning_rate=c["lr"], parameters=model.parameters()),
                         GPTPretrainingCriterion(), amp_level="O2", seed=SEED, guard=guard)

    def ms(step):
        losses = [step(ids, ids)["loss"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(ids, ids)["loss"] for _ in range(DROPOUT_GUARD_STEPS)]
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / DROPOUT_GUARD_STEPS, losses

    steps, out, losses = {False: make(False), True: make(True)}, {}, []
    try:
        for p in (c["p"], 0.0):
            model.gpt.cfg.dropout = p
            for guard, step in steps.items():
                out[f"{'guarded' if guard else 'unguarded'}_p{p}"], ls = ms(step)
                losses += ls
    finally:
        model.gpt.cfg.dropout = c["p"]
    del steps
    sync = ((out[f"guarded_p{c['p']}"] - out[f"unguarded_p{c['p']}"])
            - (out["guarded_p0.0"] - out["unguarded_p0.0"]))
    return dict(ms_per_step=out, sync_ms=sync, steps=DROPOUT_GUARD_STEPS,
                finite=bool(all(np.isfinite(float(x)) for x in losses)))


def _flat_dtype_counts():
    from paddle_tpu_torch.ops import flash_attention_flat as ff

    return {w.__name__: dict(w.launches_by_dtype) for w in (ff.flash_flat_fwd, ff.flash_flat_bwd)}


def phase_dropout_bert_train():
    """BERT-base with dropout 0.1 through TrainStep O2 on the padded batch,
    ``FLAGS_flash_flat`` on: 12 K3 and 12 K3b a step, and the losses
    against the same steps through ``sdpa=xla`` from the same weights (the
    same masks: dropout is outside attention and draws from the step's
    stream). Returns the launches of the kernel run."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    c = DROPOUT_BERT
    cfg = BertConfig(dropout=c["p"])
    inputs, labels, _ = bert_batch(BERT_TRAIN["batch"], BERT_TRAIN["seq"], cfg.vocab_size)

    def run(overrides):
        model = BertForPretraining(cfg, seed=SEED)
        step = TrainStep(model, AdamW(learning_rate=c["lr"], parameters=model.parameters()),
                         bert_loss, amp_level="O2", seed=SEED)
        set_flags({"FLAGS_flash_flat": True})
        try:
            def go():  # the first step warms up; the rest are timed
                reset_launches()
                losses = [float(step(inputs, labels)["loss"])]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses += [float(step(inputs, labels)["loss"]) for _ in range(c["steps"] - 1)]
                return losses, read_launches(), 1e3 * (time.perf_counter() - t0) / (c["steps"] - 1)
            return _with_overrides(overrides, go)
        finally:
            set_flags({"FLAGS_flash_flat": False})

    losses, launches, ms = run("")
    torch.cuda.empty_cache()
    plain, plain_launches, plain_ms = run("sdpa=xla")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    L = cfg.num_layers
    want = L * c["steps"]
    ok = (launches == {**{K["name"]: 0 for K in KERNELS}, K3["name"]: want, K3B["name"]: want}
          and all(v == 0 for v in plain_launches.values())
          and all(np.isfinite(losses + plain)) and max(rel) <= DROPOUT_BERT_RTOL)
    emit(phase="dropout_bert_train", ok=ok, ids=[BERT_TRAIN["batch"], BERT_TRAIN["seq"]],
         amp_level="O2", dropout=c["p"], losses=losses, xla_losses=plain, loss_rel_err=rel,
         loss_rtol=DROPOUT_BERT_RTOL, launches=launches, expected_each=want, ms_per_step=ms,
         xla_ms_per_step=plain_ms)
    if not ok:
        raise AssertionError("dropout_bert_train phase failed")
    return launches


class _EncoderLM(torch.nn.Module):
    """BERT-base's encoder from the layer library under word and position
    tables and an MLM head tied to the word table (its logits scaled by
    1/sqrt(d): the tables are Normal(0, 1))."""

    def __init__(self, c, vocab, max_seq, generator):
        super().__init__()
        from paddle_tpu_torch.nn import layer as L

        kw = dict(device="cuda", generator=generator)
        self.words = L.Embedding(vocab, c["d_model"], **kw)
        self.positions = L.Embedding(max_seq, c["d_model"], **kw)
        self.encoder = L.TransformerEncoder(
            L.TransformerEncoderLayer(c["d_model"], c["nhead"], c["ffn"], dropout=c["p"],
                                      activation="gelu", attn_dropout=0.0, **kw), c["layers"])

    def forward(self, ids, mask):
        pos = torch.arange(ids.shape[1], device=ids.device)
        h = self.encoder(self.words(ids) + self.positions(pos), src_mask=mask)
        return (h @ self.words.weight.T) / math.sqrt(h.shape[-1])


def _mlm_loss(logits, mlm):
    from paddle_tpu_torch.nn.functional.loss import cross_entropy

    per_tok = cross_entropy(logits.reshape(-1, logits.shape[-1]), mlm.reshape(-1),
                            ignore_index=-100, reduction="none").reshape(-1)
    keep = (mlm.reshape(-1) != -100).to(torch.float32)
    return (per_tok * keep).sum() / keep.sum()


def phase_transformer_encoder_train():
    """BERT-base's encoder from the layer library (``_EncoderLM``) on the
    padded [16, 512] batch, ``FLAGS_flash_flat`` on: 3 O2 bf16 steps
    through TrainStep (its [b, 1, s, s] bias cast to bf16 with the inputs)
    and 3 O1 float16 steps eagerly under ``auto_cast`` with a GradScaler
    (the bias kept f32); each arm against itself through ``sdpa=xla`` from
    the same weights and masks. Gates: 12 K3 and 12 K3b a step, the bf16
    instances in O2 and the float16 ones in O1; finite losses within
    ``ENCODER_RTOL`` of the xla arm's. Returns the launches of both kernel
    arms."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import random as R
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    from paddle_tpu_torch.models.bert import BertConfig

    c = ENCODER
    b, s, vocab = BERT_TRAIN["batch"], BERT_TRAIN["seq"], BertConfig().vocab_size
    inputs, labels, lengths = bert_batch(b, s, vocab)
    ids, mask, mlm = inputs[0].long(), inputs[3], labels[0]
    model = _EncoderLM(c, vocab, s, torch.Generator(device="cuda").manual_seed(SEED))
    start = {n: t.clone() for n, t in model.state_dict().items()}

    def o2():
        model.load_state_dict(start)
        step = TrainStep(model, AdamW(learning_rate=c["lr"], parameters=model.parameters()),
                         _mlm_loss, amp_level="O2", seed=SEED)
        reset_launches()
        losses = [float(step((ids, mask), (mlm,))["loss"])]  # warm-up, then timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [float(step((ids, mask), (mlm,))["loss"]) for _ in range(c["steps"] - 1)]
        return (losses, read_launches(), _flat_dtype_counts(),
                1e3 * (time.perf_counter() - t0) / (c["steps"] - 1))

    def o1():
        model.load_state_dict(start)
        opt = AdamW(learning_rate=c["lr"], parameters=model.parameters())
        scaler = amp.GradScaler()
        R.seed(SEED)  # the eager path draws from the global stream
        reset_launches()
        losses = []
        for i in range(c["steps"]):
            if i == 1:  # the first step warms up; the rest are timed
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with amp.auto_cast(dtype="float16"):
                logits = model(ids, mask)
            loss = _mlm_loss(logits.float(), mlm)
            scaler.scale(loss).backward()
            scaler.step(opt)
            opt.clear_grad()
            losses.append(float(loss.detach()))
        return (losses, read_launches(), _flat_dtype_counts(),
                1e3 * (time.perf_counter() - t0) / (c["steps"] - 1))

    set_flags({"FLAGS_flash_flat": True})
    try:
        arms = {}
        for level, run in (("O2", o2), ("O1", o1)):
            arms[level] = (_with_overrides("", run), _with_overrides("sdpa=xla", run))
            torch.cuda.empty_cache()
    finally:
        set_flags({"FLAGS_flash_flat": False})
    want = c["layers"] * c["steps"]
    report, ok, launches = {}, True, {K["name"]: 0 for K in KERNELS}
    for level, dtype in (("O2", "bfloat16"), ("O1", "float16")):
        (losses, got, by_dtype, ms), (plain, plain_got, _, plain_ms) = arms[level]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
        arm_ok = (got == {**{K["name"]: 0 for K in KERNELS}, K3["name"]: want, K3B["name"]: want}
                  and by_dtype == {K3["name"]: {dtype: want}, K3B["name"]: {dtype: want}}
                  and all(v == 0 for v in plain_got.values())
                  and all(np.isfinite(losses + plain)) and max(rel) <= ENCODER_RTOL[level])
        ok = ok and arm_ok
        launches = {k: launches[k] + v for k, v in got.items()}
        report[level] = dict(ok=arm_ok, dtype=dtype, losses=losses, xla_losses=plain,
                             loss_rel_err=rel, loss_rtol=ENCODER_RTOL[level], launches=got,
                             launches_by_dtype=by_dtype, ms_per_step=ms, xla_ms_per_step=plain_ms)
    emit(phase="transformer_encoder_train", ok=ok, ids=[b, s], layers=c["layers"],
         d_model=c["d_model"], nhead=c["nhead"], dropout=c["p"], attn_dropout=0.0,
         lengths=lengths.tolist(), expected_each=want, **report)
    if not ok:
        raise AssertionError("transformer_encoder_train phase failed")
    del model, start
    return launches


class _Seq2Seq(torch.nn.Module):
    """nn.Transformer() at its defaults under a shared source and target
    word table (Normal(0, d**-0.5), scaled by sqrt(d), as Vaswani et al.),
    learned positions and an output projection of its own (a tied one
    makes an untrained model repeat its input token)."""

    def __init__(self, vocab, max_seq, generator):
        super().__init__()
        from paddle_tpu_torch.nn import layer as L

        kw = dict(device="cuda", generator=generator)
        self.transformer = L.Transformer(**kw)
        d = self.transformer.d_model
        self.words = L.Embedding(vocab, d, **kw)
        with torch.no_grad():
            self.words.weight.normal_(0.0, d ** -0.5, generator=generator)
        self.positions = L.Embedding(max_seq, d, **kw)
        self.out = L.Linear(d, vocab, **kw)
        self.scale = math.sqrt(d)

    def embed(self, ids, start=0):
        pos = torch.arange(start, start + ids.shape[1], device=ids.device)
        return self.words(ids) * self.scale + self.positions(pos)

    def logits(self, h):
        return self.out(h)

    def forward(self, src, tgt):
        from paddle_tpu_torch.nn import layer as L

        mask = L.Transformer.generate_square_subsequent_mask(tgt.shape[1], device=tgt.device)
        return self.logits(self.transformer(self.embed(src), self.embed(tgt), tgt_mask=mask))


def _greedy(model, src, new_tokens, cache_kind):
    """Greedy decoding of ``new_tokens`` after a start token 0: by full
    recompute of the decoder over the tokens so far (``cache_kind`` None),
    or one token a step through per-layer ``FixedCache`` (or
    ``QuantizedFixedCache``) self-attention caches and the memory's
    ``StaticCache``. Returns the tokens and each step's f32 logits."""
    from paddle_tpu_torch.nn import layer as L

    tr = model.transformer
    memory = tr.encoder(model.embed(src))
    toks = torch.zeros((src.shape[0], 1), dtype=torch.long, device=src.device)
    cache = None
    if cache_kind is not None:
        first = model.embed(toks)
        cache = [(layer.self_attn.gen_cache(first, static=True, max_seq=new_tokens + 1,
                                            kv_dtype="int8" if cache_kind == "int8" else None),
                  layer.cross_attn.gen_cache(memory, memory, type=L.MultiHeadAttention.StaticCache))
                 for layer in tr.decoder.layers]
    logits = []
    for t in range(new_tokens):
        if cache is None:
            mask = L.Transformer.generate_square_subsequent_mask(t + 1, device=src.device)
            h = tr.decoder(model.embed(toks), memory, tgt_mask=mask)[:, -1:]
        else:
            h, cache = tr.decoder(model.embed(toks[:, -1:], start=t), memory, cache=cache)
        logits.append(model.logits(h))
        toks = torch.cat([toks, logits[-1].argmax(-1)], dim=1)
    return toks[:, 1:], torch.cat(logits, dim=1)


def phase_transformer_base_decode():
    """``nn.Transformer()`` at its defaults (Transformer-base) under a
    shared vocabulary of 37000 (``_Seq2Seq``): 3 f32 AdamW steps in training at src/tgt
    [32, 128] (attention dropout 0.1 and 2-D causal masks: the composite,
    no kernel, as the reference routes them); then in eval greedy decoding
    of 32 tokens for 8 sources by full recompute, through ``FixedCache``
    (its tokens bitwise the recompute's, its logits within
    ``DECODE_LOGITS_ATOL``: an untrained model may decode one token
    throughout) and ``QuantizedFixedCache`` (the share of equal tokens and
    the largest logit difference printed). The eval encoder takes K1 (no mask, no
    dropout): 6 launches per memory. Returns the launches."""
    from paddle_tpu_torch.nn.functional.loss import cross_entropy
    from paddle_tpu_torch.optimizer import AdamW

    c = TRANSFORMER_BASE
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = _Seq2Seq(c["vocab"], max(c["src"], c["tgt"]) + 1, gen)
    opt = AdamW(learning_rate=c["lr"], parameters=model.parameters())
    rng = torch.Generator(device="cuda").manual_seed(SEED + 3)
    src = torch.randint(1, c["vocab"], (c["batch"], c["src"]), device="cuda", generator=rng)
    tgt = torch.randint(1, c["vocab"], (c["batch"], c["tgt"] + 1), device="cuda", generator=rng)
    reset_launches()
    model.train()
    losses = []
    for i in range(c["steps"]):
        if i == 1:  # the first step warms up; the rest are timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        logits = model(src, tgt[:, :-1])
        loss = cross_entropy(logits.reshape(-1, c["vocab"]), tgt[:, 1:].reshape(-1))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    train_ms = 1e3 * (time.perf_counter() - t0) / (c["steps"] - 1)
    train_launches = read_launches()
    model.eval()
    srcs = src[:c["sources"]]
    out, logits, ms = {}, {}, {}
    with torch.no_grad():
        for kind in (None, "fixed", "int8"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[kind], logits[kind] = _greedy(model, srcs, c["new_tokens"], kind)
            torch.cuda.synchronize()
            ms[kind] = 1e3 * (time.perf_counter() - t0) / c["new_tokens"]
    logit_err = {k: (logits[k] - logits[None]).abs().max().item() for k in ("fixed", "int8")}
    top2 = logits[None].topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).min().item()
    launches = read_launches()
    decode_launches = {k: launches[k] - train_launches[k] for k in launches}
    enc_layers = len(model.transformer.encoder.layers)
    fixed_equal = torch.equal(out["fixed"], out[None])
    int8_share = float((out["int8"] == out[None]).float().mean())
    ok = (all(np.isfinite(losses)) and all(v == 0 for v in train_launches.values())
          and decode_launches == {**{K["name"]: 0 for K in KERNELS}, K1["name"]: 3 * enc_layers}
          and fixed_equal and logit_err["fixed"] <= DECODE_LOGITS_ATOL
          and tuple(out[None].shape) == (c["sources"], c["new_tokens"]))
    emit(phase="transformer_base_decode", ok=ok, config="nn.Transformer() defaults", vocab=c["vocab"],
         src_tgt=[c["batch"], c["src"], c["tgt"]], train_losses=losses, train_ms_per_step=train_ms,
         train_launches=train_launches, decode_launches=decode_launches,
         fixed_cache_tokens_equal_recompute=fixed_equal, int8_cache_equal_token_share=int8_share,
         logits_max_abs_err=logit_err, logits_atol=DECODE_LOGITS_ATOL, min_top2_margin=margin,
         ms_per_token={"recompute": ms[None], "fixed_cache": ms["fixed"], "int8_cache": ms["int8"]},
         distinct_tokens=int(out[None].unique().numel()), tokens=out[None][0].tolist())
    if not ok:
        raise AssertionError("transformer_base_decode phase failed")
    del model, opt
    return launches



# -- slice 12: dropout at mp, sep and pp > 1; the rest of the nn layer library ----------------
# parallel_dropout_gpt_train: dropout_gpt_train's GPT (SERVE_CFG, dropout
# 0.1, attn_dropout 0.0, AMP O2, AdamW at [8, 1024]) as worlds of 4 gloo
# processes on cuda:0, 2 steps each: mp 2 x sep 2 (every rank's losses held
# to dropout_gpt_train's first 2, one process from the same seed, weights
# and ids) and mp 2 x pp 2 through 1F1B with 2 micro-batches (held to one
# process's TrainStep accumulating 2 micro-batches), both within
# SEP_LOSS_RTOL, and the global gradient norm after step 1 within
# PDROP_GRAD_RTOL; the parameters replicated over mp bitwise equal on the
# two mp ranks of each coordinate (the replicated sites drew one mask);
# every rank's keep shares within 5 binomial standard deviations of 0.9.
# Two more worlds at mp 2 x sep 2: one with dropout 0, held so to train's
# run (the rounding that mp and sep give an O2 step without any mask), and
# the control, every sep rank keeping block 0 of each sharded mask (valid
# Bernoulli masks, the wrong ones), which must fail the loss or the
# gradient-norm limit, or those limits could not see a wrong slice
PDROP = dict(steps=2, timeout=600.0,
             worlds={"mp2_sep2": dict(mp=2, sep=2),
                     "mp2_pp2": dict(mp=2, pp=2, accumulate=2, schedule="1f1b"),
                     "nodrop_mp2_sep2": dict(mp=2, sep=2, p=0.0),
                     "control_mp2_sep2_block0": dict(mp=2, sep=2, control=True)})
# the gradient norm after step 1 against one process's: read 1.16e-4 (mp 2 x
# sep 2), 1.44e-4 (mp 2 x pp 2) and 1.71e-4 with dropout 0 on the H100, so
# not the masks but the bf16 partial products summed over the mp ranks
# after rounding (f32 worlds on the CPU read 2e-9); the control read 1.11e-2
PDROP_GRAD_RTOL = 1e-3
# the attention call on each rank: mp 2 x sep 2 holds 16 / 2 / 2 heads over
# the whole sequence after seq_to_heads; mp 2 x pp 2 a micro-batch of 4 rows
# and 16 / 2 heads (bf16, views of the packed projection)
PDROP_CALLS = {"parallel_dropout_mp2_sep2": (8, 1024, 4, 64, True),
               "parallel_dropout_mp2_pp2": (4, 1024, 8, 64, True)}
# rnn_lm_train: the "large" LSTM language model of Zaremba, Sutskever and
# Vinyals, Recurrent Neural Network Regularization (2014): vocabulary 10000,
# 2 layers of 1500 units, 35 steps unrolled, batch 20, dropout 0.65 on the
# non-recurrent connections, init uniform +-0.04, SGD lr 1.0, global norm
# clip 10; f32, TF32 off; synthetic ids from the seed (PTB is not in the
# repository); each 35-step segment starts from zero states (the
# reference's LSTM ignores initial_states). Then beam search over an
# LSTMCell with the first layer's weights (beam 4, 8 sources, 32 steps) and
# ctc_loss at a DeepSpeech2-like shape, each against the same call on the CPU
RNN_LM = dict(vocab=10000, hidden=1500, layers=2, steps_unrolled=35, batch=20, p=0.65,
              init=0.04, lr=1.0, clip=10.0, steps=3, beam=4, sources=8, decode_steps=32)
RNN_CTC = dict(T=400, batch=16, classes=29, max_label=80)
# the card against the CPU in f32: the dropout-0 step's loss (rtol) and its
# gradient (relative L2), the beams' scores (atol on log-probabilities
# summed over 32 steps), the CTC loss (rtol) and its gradient (relative L2;
# about 10x the 4.6e-6 read on the H100: 400 steps of f32 log-sum-exps)
RNN_TOL = dict(loss_rtol=1e-5, grad_rel_l2=1e-4, score_atol=1e-4, ctc_rtol=1e-5,
               ctc_grad_rel_l2=5e-5)


def _pdrop_rank(worlds, ids):
    """Rank body of ``parallel_dropout_gpt_train``: for each of ``worlds``
    in turn (one spawn of 4 processes for both), the dropout GPT from the
    seed under ``fleet.init`` at that world's degrees with AMP O2, 2 AdamW
    steps on its block of ``ids``; per world its coordinates, the keep
    shares of its draws, and a digest of each parameter that is replicated
    over mp. A ``control`` world keeps block 0 of every sharded mask on
    every rank."""
    import gc
    import hashlib

    from paddle_tpu_torch.distributed import DistributedStrategy, fleet
    from paddle_tpu_torch.framework import random as _random
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = DROPOUT_GPT
    out = {}
    for name, world in worlds.items():
        t0 = time.perf_counter()
        strat = DistributedStrategy()
        strat.hybrid_configs = {"mp_degree": world.get("mp", 1), "pp_degree": world.get("pp", 1),
                                "sep_degree": world.get("sep", 1)}
        strat.pipeline_configs = {"accumulate_steps": world.get("accumulate", 1),
                                  "schedule": world.get("schedule", "gpipe")}
        strat.amp = True
        strat.amp_configs = {"level": "O2", "dtype": "bfloat16"}
        fleet.init(is_collective=True, strategy=strat)
        hcg = fleet.get_hybrid_communicate_group()
        model = GPTForPretraining(GPTConfig(**SERVE_CFG, dropout=world.get("p", c["p"])),
                                  device="cuda", seed=SEED)
        load_s = time.perf_counter() - t0
        record = []
        real = _recording_masks(record)
        real_shard = _random.shard
        if world.get("control"):
            _random.shard = lambda g, blocks: real_shard(g, [(d, 0, n) for d, _, n in blocks])
        try:
            res = _rank_steps(fleet, model, AdamW(learning_rate=c["lr"],
                                                  parameters=model.parameters()), ids,
                              PDROP["steps"])
        finally:
            _restore_masks(real)
            _random.shard = real_shard
        shares = _keep_shares(record, c["p"]) or [(1.0 - c["p"], 0.0)]  # none at p = 0
        replicated = {n: hashlib.sha256(p.detach().float().cpu().numpy().tobytes()).hexdigest()
                      for n, p in model.named_parameters()
                      if getattr(p, "mp_group", None) is None}
        out[name] = dict(res, coord=list(hcg.coord), load_seconds=load_s, draws=len(record),
                         draw_shapes=sorted({r[0] for r in record}),
                         keep_share_min=min(sh for sh, _ in shares),
                         keep_share_max=max(sh for sh, _ in shares),
                         keep_share_max_sigmas=max(z for _, z in shares), replicated=replicated)
        del model, record
        fleet._hcg = None
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _pdrop_draws(world, stage):
    """The masks a rank draws in PDROP["steps"] steps: per micro-batch the
    embeddings' on the first stage, two per layer of its stage."""
    pp, acc = world.get("pp", 1), world.get("accumulate", 1)
    if world.get("p") == 0.0:
        return 0
    per_micro = (1 if stage == 0 else 0) + 2 * SERVE_CFG["num_layers"] // pp
    return PDROP["steps"] * acc * per_micro


def _mp_pairs(ranks):
    """The pairs of ranks whose coordinates ``(dp, pp, sdp, mp, sep)`` differ
    in mp alone."""
    return [(a, b) for a in ranks for b in ranks
            if a["coord"][3] < b["coord"][3] and a["coord"][:3] == b["coord"][:3]
            and a["coord"][4:] == b["coord"][4:]]


def _accumulated_losses(ids):
    """The dropout GPT from the seed through one process's O2 TrainStep
    accumulating 2 micro-batches: its first PDROP["steps"] losses and its
    global gradient norm after the first."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    c = DROPOUT_GPT
    model = GPTForPretraining(GPTConfig(**SERVE_CFG, dropout=c["p"]), seed=SEED)
    step = TrainStep(model, AdamW(learning_rate=c["lr"], parameters=model.parameters()),
                     GPTPretrainingCriterion(), amp_level="O2", seed=SEED, accumulate_steps=2)
    losses, grad1 = [], None
    for i in range(PDROP["steps"]):
        losses.append(float(step(ids, ids)["loss"]))
        if i == 0:
            grad1 = grad_norm(model)
    del step, model
    return losses, grad1


def _sliced_draw_cost(draws):
    """ms a step of the sliced mask draws at mp 2 x sep 2, in this process:
    ``draws`` residual-shaped masks, each as a sep rank draws it (the
    global ``[8, 1024, 1024]`` mask, then its block of ``[8, 512, 1024]``,
    ``framework.random.site_mask`` with a ``Shard``) and as a draw of the
    block alone would (``dropout_mask`` of ``[8, 512, 1024]``), each from a
    generator made per draw as the trunk makes it."""
    from paddle_tpu_torch.framework import random as R
    from paddle_tpu_torch.nn.functional import common

    c, sep = DROPOUT_GPT, PDROP["worlds"]["mp2_sep2"]["sep"]
    local = (c["batch"], c["seq"] // sep, SERVE_CFG["hidden_size"])

    def sliced():
        for i in range(draws):
            R.site_mask(local, c["p"], R.shard(R.site_generator(SEED, i, 1, "cuda"),
                                               [(1, 1, sep)]), "cuda")

    def local_only():
        for i in range(draws):
            common.dropout_mask(local, c["p"], R.site_generator(SEED, i, 1, "cuda"), "cuda")

    out = dict(draws_per_step=draws, local_shape=list(local),
               sliced_ms_per_step=[cuda_ms(sliced, 5), cuda_ms(sliced, 5)],
               local_ms_per_step=[cuda_ms(local_only, 5), cuda_ms(local_only, 5)])
    out["extra_ms_per_step"] = min(out["sliced_ms_per_step"]) - min(out["local_ms_per_step"])
    return out


def phase_parallel_dropout_gpt_train(dropout_losses, dropout_grad1, train_losses, train_grad1):
    """Dropout at mp, sep and pp > 1 on the card (see ``PDROP``): the worlds
    of 4 gloo processes on ``cuda:0``, run in turn by one spawn. Every
    rank's losses within ``SEP_LOSS_RTOL`` and its global gradient norm
    after step 1 within ``PDROP_GRAD_RTOL`` of its one-process reference
    (``dropout_gpt_train``'s, ``dropout_losses`` and ``dropout_grad1``, for
    mp 2 x sep 2; ``train``'s, ``train_losses`` and ``train_grad1``, for the
    world with dropout 0), and the control world outside one of those limits; 16 K1
    and 16 K2 a step on each rank (mp 2 x sep 2: 16 layers; mp 2 x pp 2: 8
    layers x 2 micro-batches); the parameters replicated over mp bitwise
    equal on both mp ranks; keep shares within 5 binomial standard
    deviations. Also times the sliced mask draws of a sep rank's step.
    Returns the launches summed over the worlds' ranks."""
    import gc

    from paddle_tpu_torch.testing.dist import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    c = DROPOUT_GPT
    ids = torch.randint(0, SERVE_CFG["vocab_size"], (c["batch"], c["seq"]), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
    t0 = time.perf_counter()
    one_sep = (dropout_losses[:PDROP["steps"]], dropout_grad1)
    refs = {"mp2_sep2": one_sep, "mp2_pp2": _accumulated_losses(ids),
            "nodrop_mp2_sep2": (train_losses[:PDROP["steps"]], train_grad1),
            "control_mp2_sep2_block0": one_sep}
    ref_seconds = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # the embeddings' and every layer's two residual masks, each sharded
    draw_cost = _sliced_draw_cost(1 + 2 * SERVE_CFG["num_layers"])
    steps, L = PDROP["steps"], SERVE_CFG["num_layers"]
    want = {**{K["name"]: 0 for K in KERNELS}, K1["name"]: L * steps, K2["name"]: L * steps}
    total = {K["name"]: 0 for K in KERNELS}
    ok_all, worlds = True, {}
    t0 = time.perf_counter()
    by_rank = run_ranks(_pdrop_rank, 4, PDROP["worlds"], ids.cpu(), device="cuda:0",
                        backend="gloo", timeout=PDROP["timeout"])
    t_worlds = time.perf_counter() - t0
    for name, world in PDROP["worlds"].items():
        ranks = [o[name] for o in by_rank]
        ref_losses, ref_grad1 = refs[name]
        errs = [max(abs(a - r) / abs(r) for a, r in zip(o["losses"], ref_losses)) for o in ranks]
        grad_errs = [abs(o["grad_norm_step1"] - ref_grad1) / ref_grad1 for o in ranks]
        within = max(errs) <= SEP_LOSS_RTOL and max(grad_errs) <= PDROP_GRAD_RTOL
        pairs = _mp_pairs(ranks)
        bitwise = bool(pairs) and all(a["replicated"] == b["replicated"] for a, b in pairs)
        ok = (all(np.isfinite(o["losses"]).all() for o in ranks)
              and within != bool(world.get("control")) and bitwise and len(pairs) == 2
              and all(o["launches"] == want for o in ranks)
              and all(o["keep_share_max_sigmas"] <= 5.0 for o in ranks)
              and all(o["draws"] == _pdrop_draws(world, o["coord"][1]) for o in ranks))
        ok_all = ok_all and ok
        for o in ranks:
            for k, v in o["launches"].items():
                total[k] += v
        worlds[name] = dict(
            ok=ok, degrees=world, reference_losses=ref_losses, reference_grad_norm_step1=ref_grad1,
            loss_rel_err_by_rank=errs, grad_norm_rel_err_by_rank=grad_errs,
            within_limits=within, replicated_bitwise=bitwise, mp_pairs=len(pairs),
            replicated_params=len(ranks[0]["replicated"]),
            ranks=[dict(coord=o["coord"], losses=o["losses"], grad_norm_step1=o["grad_norm_step1"],
                        step_seconds=o["step_seconds"],
                        ms_per_step=1e3 * float(np.mean(o["step_seconds"])),
                        launches_per_step={k: v / steps for k, v in o["launches"].items()},
                        draws=o["draws"], draw_shapes=o["draw_shapes"],
                        keep_share_min=o["keep_share_min"], keep_share_max=o["keep_share_max"],
                        keep_share_max_sigmas=o["keep_share_max_sigmas"],
                        host_staged_bytes_per_step=o["host_staged_bytes"] / steps,
                        max_memory_allocated=o["max_memory_allocated"],
                        load_seconds=o["load_seconds"], block=o["block"]) for o in ranks])
    emit(phase="parallel_dropout_gpt_train", ok=ok_all, backend="gloo", device="cuda:0",
         world_size=4, ids=[c["batch"], c["seq"]], config=SERVE_CFG, amp_level="O2",
         dropout=c["p"], attn_dropout=0.0, steps=steps, loss_rtol=SEP_LOSS_RTOL,
         grad_norm_rtol=PDROP_GRAD_RTOL, attention_calls={k: list(v) for k, v in PDROP_CALLS.items()},
         sliced_draws=draw_cost, one_process_seconds=ref_seconds, worlds_seconds=t_worlds,
         worlds=worlds)
    if not ok_all:
        raise AssertionError("parallel_dropout_gpt_train phase failed")
    return total


class _LstmLM(torch.nn.Module):
    """Zaremba et al.'s LSTM language model from the port's layers:
    Embedding, Dropout, two one-layer LSTMs with a Dropout after each (the
    reference's LSTM applies no dropout of its own between layers), Linear."""

    def __init__(self, p, device, generator):
        super().__init__()
        from paddle_tpu_torch.nn import initializer as I
        from paddle_tpu_torch.nn import layer as L

        c = RNN_LM
        u = I.Uniform(-c["init"], c["init"])
        I.set_global_initializer(u, u)  # every weight and bias uniform +-0.04
        try:
            kw = dict(device=device, generator=generator)
            self.embedding = L.Embedding(c["vocab"], c["hidden"], **kw)
            self.lstm1 = L.LSTM(c["hidden"], c["hidden"], **kw)
            self.lstm2 = L.LSTM(c["hidden"], c["hidden"], **kw)
            self.out = L.Linear(c["hidden"], c["vocab"], **kw)
        finally:
            I.set_global_initializer(None, None)
        self.drop = L.Dropout(p)

    def forward(self, ids):
        h = self.drop(self.embedding(ids))
        h = self.drop(self.lstm1(h)[0])
        h = self.drop(self.lstm2(h)[0])
        return self.out(h)


def _lm_loss(logits, labels):
    from paddle_tpu_torch.nn.functional import cross_entropy

    return cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def _lm_grads(model, ids, labels):
    """One forward and backward: the loss and every gradient (CPU copies)."""
    model.zero_grad()
    loss = _lm_loss(model(ids), labels)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def _beam(model, device, h0, c0):
    """Beam search over an LSTMCell holding ``model``'s first LSTM layer's
    weights, its embedding and its output projection; ids and scores on the
    host."""
    from paddle_tpu_torch.nn import layer as L

    c = RNN_LM
    cell = L.LSTMCell(c["hidden"], c["hidden"], device=device)
    with torch.no_grad():
        for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            getattr(cell, n).copy_(getattr(model.lstm1, f"{n}_l0_d0"))
    dec = L.BeamSearchDecoder(cell, start_token=1, end_token=2, beam_size=c["beam"],
                              embedding_fn=model.embedding, output_fn=model.out)
    ids, scores = L.dynamic_decode(dec, (h0.to(device), c0.to(device)),
                                   max_step_num=c["decode_steps"])
    return ids.cpu(), scores.cpu()


def _ctc(device, logits, labels, il, ll):
    from paddle_tpu_torch.nn.functional import ctc_loss

    x = logits.to(device).requires_grad_(True)
    loss = ctc_loss(x, labels.to(device), il.to(device), ll.to(device), reduction="none")
    loss.sum().backward()
    return loss.detach().cpu(), x.grad.detach().cpu()


def phase_rnn_lm_train():
    """Zaremba et al.'s large LSTM language model (``RNN_LM``) on the card:
    3 SGD steps with dropout 0.65 through ``TrainStep`` (ms a step); an arm
    with dropout 0 whose first loss and gradients are held to the same
    model on the CPU (same weights and ids); beam search over an LSTMCell
    with the first layer's weights against the CPU's (scores, the share of
    equal tokens); ``ctc_loss`` at a DeepSpeech2-like shape (``RNN_CTC``)
    and its gradient against the CPU's. No kernel of the repository runs
    (the caller checks K1-K4b stay at 0)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD

    c = RNN_LM
    gen = torch.Generator().manual_seed(SEED + 7)
    ids = torch.randint(0, c["vocab"], (c["batch"], c["steps_unrolled"] + 1), generator=gen)
    x, y = ids[:, :-1].cuda(), ids[:, 1:].cuda()
    model = _LstmLM(c["p"], "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    step = TrainStep(model, SGD(learning_rate=c["lr"], parameters=model.parameters(),
                                grad_clip=ClipGradByGlobalNorm(c["clip"])), _lm_loss, seed=SEED)
    losses = [float(step(x, y)["loss"])]  # the first step builds cuBLAS handles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [float(step(x, y)["loss"]) for _ in range(c["steps"] - 1)]
    torch.cuda.synchronize()
    ms_step = 1e3 * (time.perf_counter() - t0) / (c["steps"] - 1)
    # dropout 0: the card against the CPU, same weights and ids
    model.drop.p = 0.0
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    cpu = _LstmLM(0.0, "cpu", torch.Generator().manual_seed(SEED))
    cpu.load_state_dict(state)
    loss_card, grads_card = _lm_grads(model, x, y)
    loss_cpu, grads_cpu = _lm_grads(cpu, x.cpu(), y.cpu())
    grad_errs = _grad_rel_l2(grads_card, grads_cpu)
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    # beam search over the first layer's cell
    h0 = torch.randn((c["sources"], c["hidden"]), generator=gen) * 0.1
    c0 = torch.randn((c["sources"], c["hidden"]), generator=gen) * 0.1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids_card, scores_card = _beam(model, "cuda", h0, c0)
    decode_s = time.perf_counter() - t0
    ids_cpu, scores_cpu = _beam(cpu, "cpu", h0, c0)
    same_shape = ids_card.shape == ids_cpu.shape
    token_share = float((ids_card == ids_cpu).float().mean()) if same_shape else 0.0
    score_err = float((scores_card - scores_cpu).abs().max())
    # ctc_loss at a DeepSpeech2-like shape
    k = RNN_CTC
    logits = torch.randn((k["T"], k["batch"], k["classes"]), generator=gen)
    ll = torch.randint(k["max_label"] // 2, k["max_label"] + 1, (k["batch"],), generator=gen)
    il = torch.randint(k["T"] - 100, k["T"] + 1, (k["batch"],), generator=gen)
    labels = torch.randint(1, k["classes"], (k["batch"], k["max_label"]), generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctc_card, ctc_grad_card = _ctc("cuda", logits, labels, il, ll)
    ctc_s = time.perf_counter() - t0
    ctc_cpu, ctc_grad_cpu = _ctc("cpu", logits, labels, il, ll)
    ctc_err = float(((ctc_card - ctc_cpu).abs() / ctc_cpu.abs()).max())
    ctc_grad_err = _grad_rel_l2({"logits": ctc_grad_card}, {"logits": ctc_grad_cpu})["logits"]
    ok = (all(np.isfinite(losses)) and loss_err <= RNN_TOL["loss_rtol"]
          and max(grad_errs.values()) <= RNN_TOL["grad_rel_l2"] and same_shape
          and score_err <= RNN_TOL["score_atol"] and bool(torch.isfinite(ctc_card).all())
          and ctc_err <= RNN_TOL["ctc_rtol"] and ctc_grad_err <= RNN_TOL["ctc_grad_rel_l2"])
    emit(phase="rnn_lm_train", ok=ok, config=RNN_LM, dtype="float32", tf32=False,
         source="Zaremba, Sutskever, Vinyals 2014, 'large' (PTB); synthetic ids",
         cuts=["each 35-step segment starts from zero states: the reference's LSTM ignores "
               "initial_states", "synthetic ids from the seed: PTB is not in the repository",
               "3 steps"],
         losses=losses, ms_per_step=ms_step,
         tokens_per_s=c["batch"] * c["steps_unrolled"] * 1e3 / ms_step,
         dropout0_check=dict(loss_card=loss_card, loss_cpu=loss_cpu, loss_rel_err=loss_err,
                             grad_rel_l2_max=max(grad_errs.values()),
                             worst=max(grad_errs, key=grad_errs.get)),
         beam_search=dict(beam=c["beam"], sources=c["sources"], max_steps=c["decode_steps"],
                          tokens=list(ids_card.shape), equal_token_share=token_share,
                          score_max_abs_err=score_err, seconds_card=decode_s,
                          ms_per_token=1e3 * decode_s / max(ids_card.shape[-1], 1)),
         ctc=dict(shape=[k["T"], k["batch"], k["classes"]], max_label=k["max_label"],
                  loss_max_rel_err=ctc_err, grad_rel_l2=ctc_grad_err,
                  seconds_card=ctc_s, losses_card=ctc_card.tolist()[:4]),
         tolerances=RNN_TOL)
    if not ok:
        raise AssertionError("rnn_lm_train phase failed")

# the tensor API sweep on the card (phase 52): the PyLayer's tensor, its
# bf16 outputs and gradients (and autograd's of the same formula) held to
# f32 autograd within 2 bf16 roundings (2**-7) of the largest value;
# jacobian/hessian against the CPU at rtol and atol 1e-5
PYLAYER_SHAPE = (8, 1024, 4096)
PYLAYER_TOL = 2 ** -7
JACOBIAN_TOL = (1e-5, 1e-5)
# the random functions' moments: |mean - mu| within 5 standard errors
RANDOM_MOMENTS = {"rand": (0.5, 1 / 12), "randn": (0.0, 1.0), "standard_normal": (0.0, 1.0),
                  "normal": (1.0, 4.0), "uniform": (0.0, 16 / 12), "randint": (4.5, 8.25),
                  "randint_like": (4.5, 8.25), "bernoulli": (0.3, 0.21), "poisson": (3.0, 3.0),
                  "multinomial": (2.0, 1.0), "uniform_": (0.5, 1 / 12),
                  "exponential_": (0.5, 0.25)}


def _case_args(obj, device):
    """A case's numpy arrays as tensors on ``device`` (lists, tuples and the
    keyword arguments' dict walked)."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy()).to(device)
    if isinstance(obj, list):
        return [_case_args(o, device) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_case_args(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: _case_args(v, device) for k, v in obj.items()}
    return obj


def _case_leaves(obj):
    if isinstance(obj, (list, tuple)) and any(isinstance(o, (torch.Tensor, list, tuple))
                                              for o in obj):
        return [x for o in obj for x in _case_leaves(o)]
    return [obj]


def _case_numpy(o):
    if isinstance(o, torch.Tensor):
        return o.detach().resolve_conj().cpu().numpy()
    return np.asarray(o)


def _case_arrays(obj):
    if isinstance(obj, dict):
        return [x for o in obj.values() for x in _case_arrays(o)]
    if isinstance(obj, (list, tuple)):
        return [x for o in obj for x in _case_arrays(o)]
    return [obj] if isinstance(obj, np.ndarray) else []


def _case_call(paddle, case, device):
    """The case's call with its inputs made (from the seed) and moved to
    ``device`` already, and ``paddle.set_device`` naming it."""
    args, kwargs = case.make(np.random.default_rng(SEED))
    paddle.set_device("gpu" if device == "cuda" else "cpu")
    if not case.raw:
        args, kwargs = _case_args(args, device), _case_args(kwargs, device)
    return lambda: getattr(paddle, case.name)(*args, **kwargs)


def _case_grads(paddle, case, device):
    """The gradients of ``sum(out * w)`` over the case's float outputs (``w``
    from the next seed) with respect to its float array inputs, as numpy;
    ``None`` where no output is floating."""
    args, kwargs = case.make(np.random.default_rng(SEED))
    paddle.set_device("gpu" if device == "cuda" else "cpu")
    leaves = []

    def leaf(obj):
        if isinstance(obj, np.ndarray):
            t = torch.from_numpy(obj.copy()).to(device)
            if obj.dtype.kind == "f":
                t.requires_grad_(True)
                leaves.append(t)
            return t
        if isinstance(obj, (list, tuple)):
            return type(obj)(leaf(o) for o in obj)
        return obj

    args, kwargs = leaf(args), {k: leaf(v) for k, v in kwargs.items()}
    outs = _case_leaves(getattr(paddle, case.name)(*args, **kwargs))
    rng = np.random.default_rng(SEED + 1)
    terms = [torch.sum(o * torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(
                 np.float32)).to(device, o.dtype))
             for o in outs if isinstance(o, torch.Tensor) and o.is_floating_point()]
    if not terms or not leaves or not sum(terms).requires_grad:
        return None
    grads = torch.autograd.grad(sum(terms), leaves, allow_unused=True)
    return [np.zeros(tuple(t.shape), np.float32) if g is None else g.cpu().numpy()
            for g, t in zip(grads, leaves)]


def _case_error(case, got, want, inputs):
    """The largest error of the card's outputs against the CPU's, and
    whether it is within the case's family tolerance."""
    from paddle_tpu_torch.testing.tensor_cases import TOLERANCE

    got_l, want_l = _case_leaves(got), _case_leaves(want)
    if len(got_l) != len(want_l):
        return float("inf"), False
    g_np, w_np = [_case_numpy(o) for o in got_l], [_case_numpy(o) for o in want_l]
    if case.family == "invariant":
        ins = _case_arrays(inputs)
        g_u = case.unique(g_np if len(g_np) > 1 else g_np[0], ins)
        w_u = case.unique(w_np if len(w_np) > 1 else w_np[0], ins)
        g_np, w_np = [np.asarray(g_u[k]) for k in w_u], [np.asarray(w_u[k]) for k in w_u]
    rtol, atol = TOLERANCE[case.family]
    worst, ok = 0.0, True
    for g, w in zip(g_np, w_np):
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf"), False
        if g.dtype.kind in "fc":
            both_nan = np.isnan(g) & np.isnan(w)
            diff = np.where(both_nan, 0, np.abs(g.astype(np.complex128) - w.astype(np.complex128)))
            worst = max(worst, float(diff.max(initial=0.0)))
            ok &= bool(np.all(diff <= atol + rtol * np.abs(w)) & np.all(np.isnan(g) == np.isnan(w)))
        else:
            ok &= bool(np.array_equal(g, w))
    return worst, ok


def _random_check(paddle, name, make):
    args, kwargs = make(np.random.default_rng(SEED))
    args = _case_args(args, "cuda")
    before = torch.random.get_rng_state()
    paddle.seed(7)
    a = getattr(paddle, name)(*args, **kwargs)
    b = getattr(paddle, name)(*_case_args(make(np.random.default_rng(SEED))[0], "cuda"), **kwargs)
    paddle.seed(7)
    a2 = getattr(paddle, name)(*_case_args(make(np.random.default_rng(SEED))[0], "cuda"), **kwargs)
    ok = (a.is_cuda and torch.equal(a, a2) and not torch.equal(a, b)
          and torch.equal(torch.random.get_rng_state(), before))
    if name == "randperm":
        return ok and torch.equal(torch.sort(a).values, torch.arange(a.numel(), device="cuda"))
    mean, var = RANDOM_MOMENTS[name]
    x = a.double()
    return ok and abs(float(x.mean()) - mean) < 5 * (var / x.numel()) ** 0.5


def _gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def phase_tensor_api():
    """The tensor API sweep on the card (phase 52)."""
    import warnings

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as pdevice
    from paddle_tpu_torch.testing.tensor_cases import CASES, GRAD_TOLERANCE, RANDOM

    prev_device, prev_rng = pdevice._DEVICE[0], paddle.get_rng_state()
    by_family, bad, syncs, times = {}, [], [], {}
    grad_cases, grad_err = 0, 0.0
    for name, case in CASES.items():
        if case.family == "random":
            continue
        want = _case_call(paddle, case, "cpu")()
        _case_call(paddle, case, "cuda")()  # warm: the first call loads torch's kernels
        call = _case_call(paddle, case, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        times[name] = 1e3 * (time.perf_counter() - t0)
        if any("synchroniz" in str(w.message) for w in caught):
            syncs.append(name)
        on_card = all(o.is_cuda for o in _case_leaves(got) if isinstance(o, torch.Tensor))
        err, ok = _case_error(case, got, want, case.make(np.random.default_rng(SEED))[0])
        del got, want, call
        fam = by_family.setdefault(case.family, {"cases": 0, "max_abs_err": 0.0})
        fam["cases"] += 1
        fam["max_abs_err"] = max(fam["max_abs_err"], err)
        if not (ok and on_card):
            bad.append((name, err, on_card))
        if case.grad:
            g_cuda, g_cpu = _case_grads(paddle, case, "cuda"), _case_grads(paddle, case, "cpu")
            if g_cpu is not None:
                grad_cases += 1
                g_err = max(float(np.abs(a - b).max(initial=0.0)) for a, b in zip(g_cuda, g_cpu))
                grad_err = max(grad_err, g_err)
                if not all(np.allclose(a, b, rtol=GRAD_TOLERANCE[0], atol=GRAD_TOLERANCE[1])
                           for a, b in zip(g_cuda, g_cpu)):
                    bad.append((name, "gradient", g_err))
    paddle.set_device("gpu")
    random_bad = [n for n, make in RANDOM.items() if not _random_check(paddle, n, make)]

    # a PyLayer with a hand-written tanh-GELU backward, bf16, against
    # autograd of the plain formula (both held to f32 autograd)
    class TanhGelu(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return _gelu_tanh(x.float()).to(x.dtype)

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            xf = x.float()
            c = math.sqrt(2.0 / math.pi)
            t = torch.tanh(c * (xf + 0.044715 * xf ** 3))
            d = 0.5 * (1 + t) + 0.5 * xf * (1 - t * t) * c * (1 + 3 * 0.044715 * xf * xf)
            return (dy.float() * d).to(x.dtype)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(PYLAYER_SHAPE, device="cuda", generator=gen).to(torch.bfloat16)
    dy = torch.randn(PYLAYER_SHAPE, device="cuda", generator=gen).to(torch.bfloat16)

    def run(fn, dtype=None):
        xi = (x if dtype is None else x.to(dtype)).detach().requires_grad_(True)
        out = fn(xi)
        out.backward(dy if dtype is None else dy.to(dtype))
        return out.detach(), xi.grad

    def plain(t):  # the plain formula in f32 on the bf16 input, as the PyLayer's forward
        return _gelu_tanh(t.float()).to(t.dtype)

    truth_out, truth_grad = run(_gelu_tanh, torch.float32)
    layer_out, layer_grad = run(TanhGelu.apply)
    plain_out, plain_grad = run(plain)
    scale_out, scale_grad = float(truth_out.abs().max()), float(truth_grad.abs().max())
    pylayer = {name: {"out_err": float((o.float() - truth_out).abs().max()) / scale_out,
                      "grad_err": float((g.float() - truth_grad).abs().max()) / scale_grad,
                      "ms": cuda_ms(lambda f=f: run(f), iters=5)}
               for name, o, g, f in (("pylayer", layer_out, layer_grad, TanhGelu.apply),
                                     ("plain_autograd", plain_out, plain_grad, plain))}
    pylayer["pylayer_vs_plain"] = {
        "out_err": float((layer_out.float() - plain_out.float()).abs().max()) / scale_out,
        "grad_err": float((layer_grad.float() - plain_grad.float()).abs().max()) / scale_grad}
    del x, dy, truth_out, truth_grad, layer_out, layer_grad, plain_out, plain_grad
    pylayer_ok = all(v["out_err"] <= PYLAYER_TOL and v["grad_err"] <= PYLAYER_TOL
                     for v in pylayer.values())

    # jacobian and hessian on the card against the CPU
    w = torch.randn(48, 32, generator=torch.Generator().manual_seed(SEED))
    v = torch.randn(32, generator=torch.Generator().manual_seed(SEED + 1))
    funcs = {}
    for dev in ("cpu", "cuda"):
        wd, vd = w.to(dev), v.to(dev)
        funcs[dev] = (paddle.autograd.jacobian(lambda t, wd=wd: paddle.tanh(paddle.mv(wd, t)), vd),
                      paddle.autograd.hessian(lambda t: paddle.sum(paddle.sin(t) * t * t), vd))
    jac_err = [float((a.cpu() - b).abs().max()) for a, b in zip(funcs["cuda"], funcs["cpu"])]
    jac_ok = all(a.is_cuda for a in funcs["cuda"]) and all(
        torch.allclose(a.cpu(), b, rtol=JACOBIAN_TOL[0], atol=JACOBIAN_TOL[1])
        for a, b in zip(funcs["cuda"], funcs["cpu"]))
    pdevice._DEVICE[0] = prev_device
    paddle.set_rng_state(prev_rng)
    slowest = dict(sorted(times.items(), key=lambda kv: -kv[1])[:10])
    ok = not bad and not random_bad and pylayer_ok and jac_ok
    emit(phase="tensor_api", ok=ok, cases=sum(f["cases"] for f in by_family.values()),
         random_cases=len(RANDOM), by_family=by_family, grad_cases=grad_cases,
         grad_max_abs_err=grad_err, grad_tol=GRAD_TOLERANCE, failed=bad, random_failed=random_bad,
         host_syncs=syncs, slowest_ms=slowest, total_ms=sum(times.values()),
         pylayer=dict(pylayer, shape=list(PYLAYER_SHAPE), dtype="bfloat16", tol=PYLAYER_TOL),
         jacobian_hessian_max_abs_err=jac_err)
    if not ok:
        raise AssertionError("tensor_api phase failed")


def phase_paddle_api_gpt_train():
    """Phase 6's O2 GPT trained, saved and resumed through the port's
    ``paddle.*`` API (phase 53). Returns the resumed run's launches."""
    import shutil

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as pdevice
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    prev_device, prev_rng = pdevice._DEVICE[0], paddle.get_rng_state()
    paddle.set_device("gpu")
    paddle.seed(SEED)
    cfg = GPTConfig(**SERVE_CFG)
    b, s = TRAIN["batch"], TRAIN["seq"]
    batches = [paddle.randint(0, cfg.vocab_size, [b, s]) for _ in range(4)]

    def fresh():
        model = GPTForPretraining(cfg, seed=SEED)
        opt = AdamW(learning_rate=TRAIN["lr"], parameters=model.parameters())
        return model, opt, TrainStep(model, opt, GPTPretrainingCriterion(), amp_level="O2")

    def steps(step, ids_list, ms):
        out = []
        for ids in ids_list:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(float(step(ids, ids)["loss"]))
            ms.append(1e3 * (time.perf_counter() - t0))
        return out

    # the uninterrupted run
    model, opt, step = fresh()
    full_ms = []
    full = steps(step, batches, full_ms)
    del model, opt, step
    torch.cuda.empty_cache()

    # the run the user stops and resumes: 2 steps, save, delete, load, 2 steps
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    model, opt, step = fresh()
    resumed_ms = []
    first = steps(step, batches[:2], resumed_ms)
    root = _ckpt_dir("paddle_api_gpt")
    t0 = time.perf_counter()
    paddle.save(model.state_dict(), str(root / "model.pdparams"))
    paddle.save(opt.state_dict(), str(root / "model.pdopt"))
    save_s = time.perf_counter() - t0
    file_bytes = sum(p.stat().st_size for p in root.iterdir())
    del model, opt, step
    torch.cuda.empty_cache()
    model, opt, step = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.load_state_dict(paddle.load(str(root / "model.pdparams")))
    opt.set_state_dict(paddle.load(str(root / "model.pdopt")))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    second = steps(step, batches[2:], resumed_ms)
    launches = read_launches()
    peak_paddle = paddle.device.cuda.max_memory_allocated()
    peak_torch = torch.cuda.max_memory_allocated()
    shutil.rmtree(root, ignore_errors=True)
    del model, opt, step, batches
    pdevice._DEVICE[0] = prev_device
    paddle.set_rng_state(prev_rng)
    per_step = {k: v / 4 for k, v in launches.items()}
    ok = (first + second == full and all(np.isfinite(full))
          and per_step == {K1["name"]: cfg.num_layers, K2["name"]: cfg.num_layers,
                           K3["name"]: 0, K3B["name"]: 0, K4["name"]: 0, K4B["name"]: 0}
          and peak_paddle == peak_torch)
    emit(phase="paddle_api_gpt_train", ok=ok, ids=[b, s], amp_level="O2", losses=full,
         resumed_losses=first + second, bitwise=first + second == full, launches=launches,
         launches_per_step=per_step, file_bytes=file_bytes, save_s=save_s, load_s=load_s,
         ms_per_step=float(np.median(full_ms[1:])), step_ms=full_ms, resumed_step_ms=resumed_ms,
         max_memory_allocated=peak_paddle, torch_max_memory_allocated=peak_torch)
    if not ok:
        raise AssertionError("paddle_api_gpt_train phase failed")
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
    k1_row, k1_bf16_row, k1_d128, k1_f16 = phase_k1()
    k2_row, k2_f32_row, k2_d128, k2_f16 = phase_k2()
    flat_rows, flat_f16 = phase_flat_kernels()
    rows = {K1["name"]: k1_row, K2["name"]: k2_row, **flat_rows}
    # the bf16 calls of the O2 steps, beside K1's f32 main row (the forward's
    # call); K3's main row is already BERT's O2 call
    bf16_rows = {K1["name"]: k1_bf16_row, K3["name"]: rows[K3["name"]]}
    # K2's f32 call (its main row is the O2 step's bf16 call)
    f32_rows = {K2["name"]: k2_f32_row}
    # K1's and K2's d = 128 calls of the 1.3B and ERNIE steps
    d128_rows = {K1["name"]: k1_d128, K2["name"]: k2_d128}
    # K1's and K2's float16 instances at the O2 and 1.3B calls, K3's and
    # K3b's at BERT's call and GPT's packed call
    f16_rows = {K1["name"]: k1_f16, K2["name"]: k2_f16, **flat_f16}

    model = GPTForPretraining(GPTConfig(**SERVE_CFG), seed=SEED).eval()
    ids = torch.randint(0, SERVE_CFG["vocab_size"], (8, 1024), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
    with torch.no_grad():  # warm-up: cuBLAS handles and the kernel's library
        model(ids)
    # the main path: each of its runs counts launches from 0
    by_path = {}
    for path, run in (("forward", lambda: phase_forward(model, ids)),
                      ("serve", lambda: phase_serve(model)),
                      ("serve_round2", lambda: phase_serve_round2(model)),
                      ("serve_spec", lambda: phase_serve_spec(model)),
                      ("fleet", lambda: phase_fleet(model)),
                      ("procfleet", lambda: phase_procfleet(model)),
                      ("ingress", phase_ingress),
                      ("alerts", lambda: phase_alerts(model)),
                      ("mp_decode", lambda: phase_mp_decode(model))):
        reset_launches()
        run()
        by_path[path] = read_launches()
    del model
    torch.cuda.empty_cache()
    by_path["train"], train_losses, train_grad1 = phase_train()
    torch.cuda.empty_cache()
    phase_train_check()
    torch.cuda.empty_cache()
    reset_launches()
    phase_tensor_api()
    by_path["tensor_api"] = read_launches()
    torch.cuda.empty_cache()
    by_path["paddle_api_gpt_train"] = phase_paddle_api_gpt_train()
    torch.cuda.empty_cache()
    by_path["amp_o1_gpt_train"] = phase_amp_o1_gpt_train()
    torch.cuda.empty_cache()
    by_path["fp16_gpt_train"] = phase_fp16_gpt_train()
    torch.cuda.empty_cache()
    by_path["moe_train"], step_rows, moe_losses, moe_grad1 = phase_moe_train()
    torch.cuda.empty_cache()
    by_path["ep_moe_train"], ep_rows = phase_ep_moe_train(moe_losses, moe_grad1)
    torch.cuda.empty_cache()
    moe_rows, ep_moe_rows = phase_moe_kernels(step_rows, ep_rows)
    rows.update(moe_rows)
    torch.cuda.empty_cache()
    by_path["sep_gpt_train"] = phase_sep_gpt_train(train_losses, train_grad1)
    torch.cuda.empty_cache()
    by_path["resilient_gpt_train"] = phase_resilient_gpt_train()
    torch.cuda.empty_cache()
    by_path["elastic_gpt_rescale"] = phase_elastic_gpt_rescale(train_losses)
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
    by_path["bert_train"], bert_losses, bert_ms = phase_bert_train()
    torch.cuda.empty_cache()
    reset_launches()
    by_path["dp_bert_train"] = phase_dp_bert_train(bert_losses, bert_ms)
    torch.cuda.empty_cache()
    phase_bert_curves(bert_losses)
    torch.cuda.empty_cache()
    phase_bert_check()
    torch.cuda.empty_cache()
    by_path["dropout_gpt_train"], dropout_losses, dropout_grad1 = phase_dropout_gpt_train()
    torch.cuda.empty_cache()
    by_path["parallel_dropout_gpt_train"] = phase_parallel_dropout_gpt_train(
        dropout_losses, dropout_grad1, train_losses, train_grad1)
    torch.cuda.empty_cache()
    reset_launches()
    phase_rnn_lm_train()
    by_path["rnn_lm_train"] = read_launches()
    torch.cuda.empty_cache()
    by_path["dropout_bert_train"] = phase_dropout_bert_train()
    torch.cuda.empty_cache()
    by_path["transformer_encoder_train"] = phase_transformer_encoder_train()
    torch.cuda.empty_cache()
    by_path["transformer_base_decode"] = phase_transformer_base_decode()
    torch.cuda.empty_cache()
    phase_dist_two_rank()
    torch.cuda.empty_cache()
    phase_dist_zero3_ernie()
    torch.cuda.empty_cache()
    reset_launches()
    phase_flat_check()
    by_path["flat_check"] = read_launches()
    torch.cuda.empty_cache()
    by_path["gpt3_1p3b_train"], gpt3_losses, gpt3_ms = phase_gpt3_train()
    torch.cuda.empty_cache()
    reset_launches()
    by_path["zero_gpt3_train"], zero_peak, zero_ms = phase_zero_gpt3_train(gpt3_losses, gpt3_ms)
    torch.cuda.empty_cache()
    reset_launches()
    by_path["zero_offload_gpt3_train"] = phase_zero_offload_gpt3_train(gpt3_losses, zero_peak,
                                                                       zero_ms)
    torch.cuda.empty_cache()
    phase_offload_guard_check()
    torch.cuda.empty_cache()
    by_path["hybrid_gpt3"] = phase_hybrid_gpt3()
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
    torch.cuda.empty_cache()
    by_path["vision_zoo_train"] = phase_vision_zoo_train()
    torch.cuda.empty_cache()
    phase_vision_zoo_check()
    torch.cuda.empty_cache()
    by_path["nn_layers_api"] = phase_nn_layers_api()
    torch.cuda.empty_cache()
    by_path["dlrm_train"] = phase_dlrm_train()
    torch.cuda.empty_cache()
    phase_dlrm_check()
    torch.cuda.empty_cache()
    phase_optim_check()
    torch.cuda.empty_cache()
    by_path["dlrm_sharded_train"] = phase_dlrm_sharded_train()

    keys = ("shape", "causal", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # K4/K4b compute the live rows only: the bounds of their main call and of
    # their ep call count them, the ep row keeps the padded rows' bound apart
    for K in (K4, K4B):
        row = rows[K["name"]]
        rows[K["name"]] = dict(row, bound_ms=row["bound_live_ms"], bound_by=row["bound_live_by"])
        if K["name"] in ep_moe_rows:
            row = ep_moe_rows[K["name"]]
            ep_moe_rows[K["name"]] = dict(row, bound_padded_ms=row["bound_ms"],
                                          bound_ms=row["bound_live_ms"],
                                          bound_by=row["bound_live_by"])
    kernels = [dict(K, launches=sum(p[K["name"]] for p in by_path.values()),
                    launches_by_path={path: p[K["name"]] for path, p in by_path.items()},
                    **{k: rows[K["name"]][k] for k in keys if k in rows[K["name"]]},
                    **({"bf16_row": {k: bf16_rows[K["name"]][k] for k in keys + ("packed_qkv",)
                                     if k in bf16_rows[K["name"]]}}
                       if K["name"] in bf16_rows else {}),
                    **({"f32_row": {k: f32_rows[K["name"]][k] for k in keys + ("packed_qkv",)
                                    if k in f32_rows[K["name"]]}}
                       if K["name"] in f32_rows else {}),
                    **({"d128_rows": {path: {k: row[k] for k in keys + ("packed_qkv",) if k in row}
                                      for path, row in d128_rows[K["name"]].items()}}
                       if K["name"] in d128_rows else {}),
                    **({"f16_rows": {call: {k: row[k] for k in keys + ("packed_qkv",) if k in row}
                                     for call, row in f16_rows[K["name"]].items()}}
                       if K["name"] in f16_rows else {}),
                    **({"ep_row": {k: ep_moe_rows[K["name"]][k]
                                   for k in keys + ("experts", "rows", "fill", "bound_padded_ms")
                                   if k in ep_moe_rows[K["name"]]}}
                       if K["name"] in ep_moe_rows else {}))
               for K in KERNELS]
    emit(kernels=kernels, wall_s=time.perf_counter() - t_start)
    # K1 runs in the forward and in training, K2 in training, K4 and K4b in
    # the GPT-MoE step (with K1 and K2), K3 in BERT's forward, K3 and K3b in
    # BERT's step (alone and through fleet.distributed_step) and in GPT's
    # step with FLAGS_flash_flat on, K1 and K2 in
    # the 1.3B and ERNIE steps; the vision steps and DLRM's none (their
    # phases check that every count stays 0)
    expected = {"forward": [K1["name"]], "serve": [], "serve_round2": [], "serve_spec": [],
                "fleet": [], "procfleet": [], "ingress": [], "alerts": [], "mp_decode": [],
                "train": [K1["name"], K2["name"]], "tensor_api": [],
                "paddle_api_gpt_train": [K1["name"], K2["name"]],
                "amp_o1_gpt_train": [K1["name"], K2["name"]],
                "fp16_gpt_train": [K1["name"], K2["name"]],
                "moe_train": [K["name"] for K in (K1, K2, K4, K4B)],
                "ep_moe_train": [K["name"] for K in (K1, K2, K4, K4B)],
                "sep_gpt_train": [K1["name"], K2["name"]],
                "resilient_gpt_train": [K1["name"], K2["name"]],
                "elastic_gpt_rescale": [K1["name"], K2["name"]],
                "bert_forward": [K3["name"]], "bert_train": [K3["name"], K3B["name"]],
                "dp_bert_train": [K3["name"], K3B["name"]],
                "flat_check": [K3["name"], K3B["name"]],
                "gpt3_1p3b_train": [K1["name"], K2["name"]],
                "zero_gpt3_train": [K1["name"], K2["name"]],
                "zero_offload_gpt3_train": [K1["name"], K2["name"]],
                "hybrid_gpt3": [K1["name"], K2["name"]],
                "ernie_train": [K1["name"], K2["name"]],
                "dropout_gpt_train": [K1["name"], K2["name"]],
                "parallel_dropout_gpt_train": [K1["name"], K2["name"]], "rnn_lm_train": [],
                "dropout_bert_train": [K3["name"], K3B["name"]],
                "transformer_encoder_train": [K3["name"], K3B["name"]],
                "transformer_base_decode": [K1["name"]],
                "resnet50_train": [], "lenet_train": [], "vision_zoo_train": [],
                "nn_layers_api": [], "dlrm_train": [],
                "dlrm_sharded_train": []}
    missing = [(path, n) for path, names in expected.items() for n in names if by_path[path][n] == 0]
    if missing:
        raise AssertionError(f"the main path launched these kernels no time: {missing}")
    # the serving and vision paths run no kernel of this repository
    stray = [(path, n) for path, names in expected.items() if not names
             for n, count in by_path[path].items() if count]
    if stray:
        raise AssertionError(f"paths that run no repo kernel launched these: {stray}")
    emit(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # a failed phase: report it, exit non-zero, print no result
        print(json.dumps({"failed": type(exc).__name__, "error": str(exc)[:2000]}), flush=True)
        raise

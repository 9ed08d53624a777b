"""Rank bodies of the port's distributed parity tests
(``tests/test_torch_{collective,ddp,dist_step,mp_layers,sync_bn}.py``).

Each function runs in every rank of a gloo world that
:func:`paddle_tpu_torch.testing.dist.run_ranks` spawned on the CPU, and
returns picklable numpy results for the test process to hold against
``paddle_tpu``. This module imports torch, numpy and the port only: a rank
process never imports ``jax`` or ``paddle_tpu`` (``tests/test_torch_imports.py``
checks that).
"""
import os
import sys

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy()


def imported_reference_modules():
    """The modules of ``jax`` or ``paddle_tpu`` this rank has imported,
    after one step of a tiny GPT pipelined over the world (pp = world,
    1F1B) with ZeRO stage 2, one of a tiny GPT-MoE with its experts over dp
    = world, and one of a tiny GPT over sep = world."""
    import paddle_tpu_torch.distributed as D
    import paddle_tpu_torch.utils.convert  # noqa: F401
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining  # noqa: F401
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    fleet = _hybrid_fleet(dict(pp=D.get_world_size(), stage=2, accumulate=2, schedule="1f1b"))
    model = GPTForPretraining(GPTConfig.tiny(), device="cpu")
    step = fleet.distributed_step(model, AdamW(parameters=model.parameters()),
                                  GPTPretrainingCriterion())
    ids = torch.zeros(4, 8, dtype=torch.long)
    step(ids, ids)
    D.fleet._hcg = None
    for degrees, cfg in ((dict(dp=D.get_world_size()), GPTConfig.tiny(moe=4)),
                         (dict(sep=D.get_world_size()), GPTConfig.tiny())):
        fleet = _hybrid_fleet(degrees)
        model = GPTForPretraining(cfg, device="cpu")
        step = fleet.distributed_step(model, AdamW(parameters=model.parameters()),
                                      GPTPretrainingCriterion())
        x = fleet.shard_batch(ids)
        step(x, x)
        D.fleet._hcg = None
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))


# -- collectives ----------------------------------------------------------------
def collectives(inputs):
    """Every collective of the port on this rank's slice of ``inputs``
    (each ``[world, ...]``), with the ``collective.*.calls`` counters."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.observability import metrics

    metrics.reset_counters("collective.")
    r, n = D.get_rank(), D.get_world_size()
    x = {k: torch.from_numpy(np.ascontiguousarray(v[r])) for k, v in inputs.items()}
    out = {}
    for op in ("sum", "max", "min", "avg"):
        out[f"all_reduce_{op}"] = D.all_reduce(x["a"].clone(), op=op)
    out["reduce"] = D.reduce(x["a"].clone(), dst=1)
    out["all_gather_list"] = torch.stack(D.all_gather([], x["a"]))
    out["all_gather"] = D.all_gather(x["a"])
    out["all_gather_concat_0"] = D.all_gather_concat(x["m"], concat_axis=0)
    out["all_gather_concat_1"] = D.all_gather_concat(x["m"], concat_axis=1)
    out["reduce_scatter_0"] = D.reduce_scatter(None, x["rs"], scatter_axis=0)
    into = torch.empty(x["rs"].shape[0], x["rs"].shape[1] // n)
    out["reduce_scatter_1"] = D.reduce_scatter(into, x["rs"], scatter_axis=1)
    assert out["reduce_scatter_1"] is into
    out["alltoall_list"] = torch.stack(D.alltoall(list(x["l"].unbind(0)), []))
    out["alltoall_tiled"] = D.alltoall(x["rs"], split_axis=1, concat_axis=0)
    out["broadcast"] = D.broadcast(x["a"].clone(), src=1)
    out["scatter"] = D.scatter(torch.empty_like(x["l"][0]), list(x["l"].unbind(0)), src=n - 1)
    out["ppermute"] = D.ppermute(x["a"], [(i, (i + 1) % n) for i in range(n)])
    out["ppermute_partial"] = D.ppermute(x["a"], [(0, n - 1)])
    D.barrier()
    D.wait(x["a"])
    # send and recv around the ring: even ranks send first, odd ones receive
    got = torch.empty_like(x["a"])
    if r % 2 == 0:
        D.send(x["a"], dst=(r + 1) % n)
        D.recv(got, src=(r - 1) % n)
    else:
        D.recv(got, src=(r - 1) % n)
        D.send(x["a"], dst=(r + 1) % n)
    out["send_recv"] = got
    out["p2p"] = torch.empty_like(x["a"])
    D.p2p(sends=[(x["a"], (r + 1) % n)], recvs=[(out["p2p"], (r - 1) % n)])
    res = {k: v if isinstance(v, str) else _np(v) for k, v in out.items()}
    res["counters"] = metrics.counters("collective.")
    return res


def groups_and_axis_names(save_dir):
    """The collectives over the fleet's groups of a dp 2 x mp 2 world, by
    group and by axis name, and the topology's accessors; every rank calls
    ``save_persistables`` into ``save_dir``."""
    import paddle_tpu_torch.distributed as D

    s = D.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    D.fleet.init(is_collective=True, strategy=s, device="cpu")
    hcg = D.fleet.get_hybrid_communicate_group()
    r = D.get_rank()
    v = torch.tensor([float(10 ** r)])
    D.fleet.save_persistables(torch.nn.Linear(2, 2), save_dir)
    D.fleet.barrier_worker()
    return dict(
        rank=r, coord=hcg.coord,
        dp=(hcg.get_data_parallel_world_size(), hcg.get_data_parallel_rank(),
            hcg.get_data_parallel_group().ranks),
        mp=(hcg.get_model_parallel_world_size(), hcg.get_model_parallel_rank(),
            hcg.get_model_parallel_group().ranks),
        pp=(hcg.get_pipe_parallel_world_size(), hcg.get_pipe_parallel_rank(),
            hcg.get_pipe_parallel_group().ranks),
        sdp=(hcg.get_sharding_parallel_world_size(), hcg.get_sharding_parallel_rank()),
        sep=(hcg.get_sep_parallel_world_size(), hcg.get_sep_parallel_rank()),
        comm_mp=hcg.topo.get_comm_list("mp"), comm_dp=hcg.topo.get_comm_list("dp"),
        sum_mp=float(D.all_reduce(v.clone(), group="mp")),
        sum_dp=float(D.all_reduce(v.clone(), group=hcg.get_data_parallel_group())),
        sum_default=float(D.all_reduce(v.clone())),
        sum_world=float(D.all_reduce(v.clone(), group=D.new_group())),
        blocks=[_np(t) for t in D.fleet.shard_batch(np.arange(16).reshape(8, 2),
                                                     np.arange(8))],
        env=(D.ParallelEnv().rank, D.ParallelEnv().world_size, D.ParallelEnv().local_rank))


def topology_errors():
    """The errors of a world of 2: degrees that do not multiply to it; the
    groups of pp 2, sdp 2 and (the ``sep``, ``data_sep`` and data groups)
    sep 2; and ``shard_batch`` before ``fleet.init`` and on a batch that
    does not split."""
    import paddle_tpu_torch.distributed as D

    D.init_parallel_env(device="cpu")
    errors = []
    for kw in (dict(dp_degree=4), dict(dp_degree=1, pp_degree=2), dict(sharding_degree=2),
               dict(sep_degree=2)):
        try:
            hcg = D.HybridCommunicateGroup(**kw)
            if "sep_degree" in kw:
                errors.append((hcg.get_sep_parallel_group().ranks,
                               hcg.get_data_sep_group().ranks, hcg.group("data").ranks))
                continue
            errors.append((hcg.group("pp").ranks, hcg.group("sdp").ranks, hcg.group("data").ranks,
                           hcg.get_pp_ends_group().ranks))
        except (ValueError, NotImplementedError) as e:
            errors.append(f"{type(e).__name__}: {e}")
    try:
        D.fleet.shard_batch(np.zeros(3))
    except RuntimeError as e:
        errors.append(f"{type(e).__name__}: {e}")
    s = D.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2}
    D.fleet.init(strategy=s, device="cpu")
    try:
        D.fleet.shard_batch(np.zeros(3))
    except ValueError as e:
        errors.append(f"{type(e).__name__}: {e}")
    return errors


# -- DataParallel ---------------------------------------------------------------
def ddp_cases():
    """The reference's ``tests/test_hooks_ddp.py`` cases at world 2: the
    averaged gradient (ranks feed 1s and 2s), the parameters broadcast from
    rank 0, the unused-parameter error, ``no_sync`` and
    ``apply_collective_grads``, and ``find_unused_parameters``."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.nn.layer import Linear

    r = D.get_rank()
    m = Linear(4, 1, device="cpu", generator=torch.Generator().manual_seed(r))
    dp = D.DataParallel(m)
    out = {"grad_sync": dp._grad_sync, "weight": _np(m.weight), "hooks": len(dp._hook_handles)}
    x = torch.full((2, 4), r + 1.0)
    loss = dp.scale_loss(dp(x).sum())
    loss.backward()
    out["grad"] = _np(m.weight.grad)
    out["bias_grad"] = _np(m.bias.grad)

    class Two(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = Linear(3, 3, device="cpu")
            self.b = Linear(3, 3, device="cpu")

        def forward(self, x):
            return self.a(x)

    strict = D.DataParallel(Two())  # held: a discarded wrapper syncs nothing
    try:
        strict(torch.ones(1, 3)).sum().backward()
        out["unused_error"] = None
    except RuntimeError as e:
        out["unused_error"] = str(e)
    two = Two()
    loose = D.DataParallel(two, find_unused_parameters=True)
    loose(torch.full((1, 3), r + 1.0)).sum().backward()
    out["loose_grad"] = _np(two.a.weight.grad)
    out["loose_unused"] = two.b.weight.grad is None
    m.weight.grad, m.bias.grad = None, None
    with dp.no_sync():
        dp(x).sum().backward()
    out["no_sync_grad"] = _np(m.weight.grad)
    dp.apply_collective_grads()
    out["applied_grad"] = _np(m.weight.grad)
    out["state_keys"] = sorted(dp.state_dict())
    return out


def ddp_world_one():
    """A world of one: ``DataParallel`` is a passthrough with no hooks."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.nn.layer import Linear

    m = Linear(4, 2, device="cpu")
    dp = D.DataParallel(m)
    dp(torch.ones(2, 4)).sum().backward()
    return dict(grad_sync=dp._grad_sync, hooks=len(dp._hook_handles), world=D.get_world_size(),
                grad=_np(m.weight.grad))


def bucket_plans(shapes, dtypes, budgets):
    """The reducer's bucket plan (parameter indices per bucket, with the
    dtype) for parameters of these shapes and dtypes at each budget (MB)."""
    from paddle_tpu_torch.distributed.parallel import _BucketReducer

    params = [torch.nn.Parameter(torch.zeros(s, dtype=getattr(torch, d)))
              for s, d in zip(shapes, dtypes)]
    index = {id(p): i for i, p in enumerate(params)}
    plans = []
    for mb in budgets:
        r = _BucketReducer(params, comm_buffer_mb=mb)
        plans.append([(dt, [index[id(p)] for p in ps]) for dt, ps in r.buckets])
    return plans


def spawn_target(out_dir):
    """Writes this rank's world size under its rank's name (``spawn``)."""
    rank = os.environ["PADDLE_TRAINER_ID"]
    with open(os.path.join(out_dir, f"rank{rank}"), "w") as f:
        f.write(os.environ["PADDLE_TRAINERS_NUM"])


# -- fleet.distributed_step -------------------------------------------------------
def _fleet(dp, mp, **strategy):
    import paddle_tpu_torch.distributed as D

    s = D.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    for k, v in strategy.items():
        if k == "gradient_merge_configs":  # a plain dict: assigning one is dropped, as in the reference
            s.gradient_merge_configs.update(v)
        else:
            setattr(s, k, v)
    D.fleet.init(is_collective=True, strategy=s, device="cpu")
    return D.fleet


def bert_steps(dp, mp, cfg_kw, np_state, inputs, labels, steps, lr, clip=None):
    """``fleet.distributed_step`` of BERT at dp x mp over ``steps`` steps of
    the global batch ``(inputs, labels)`` (numpy), from the full state
    ``np_state`` (each rank loads its mp shard): the losses, this rank's
    final state, its coordinates, the whole global norm of the first step's
    averaged gradients (what the clip saw), and whether the seeded model
    held the shards."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining, BertPretrainingCriterion
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils.convert import shard_state

    fleet = _fleet(dp, mp)
    hcg = fleet.get_hybrid_communicate_group()
    cfg = BertConfig.tiny(**cfg_kw)
    model = BertForPretraining(cfg, device="cpu", seed=7)
    mp_rank = hcg.get_model_parallel_rank()
    # a model made from a seed holds the shards of the one-rank model
    saved, fleet._hcg = fleet._hcg, None
    whole = {k: _np(v) for k, v in BertForPretraining(cfg, device="cpu", seed=7).state_dict().items()}
    fleet._hcg = saved
    own = shard_state(whole, mp_rank, mp, cfg)
    seeded_shards = all(np.array_equal(own[k], _np(v)) for k, v in model.state_dict().items())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           shard_state(np_state, mp_rank, mp, cfg).items()})
    crit = BertPretrainingCriterion()

    def loss_fn(outs, mlm, nsp):
        return crit(outs[0], outs[1], mlm, nsp)

    grad_clip = None if clip is None else ClipGradByGlobalNorm(clip)
    opt = AdamW(learning_rate=lr, parameters=model.parameters(), grad_clip=grad_clip)
    step = fleet.distributed_step(model, opt, loss_fn)
    x_ids, x_types, x_pos, x_mask, y_mlm, y_nsp = fleet.shard_batch(*inputs, *labels)
    batch = ((x_ids, x_types, x_pos, x_mask), (y_mlm, y_nsp))
    losses, norm = [], None
    for i in range(steps):
        losses.append(float(step(*batch)["loss"]))
        if i == 0:  # the step leaves its averaged, unclipped gradients on the parameters
            norm = clip_norm_of(model)
    return dict(losses=losses, state={k: _np(v) for k, v in model.state_dict().items()},
                dp_rank=hcg.get_data_parallel_rank(), mp_rank=mp_rank, seeded_shards=seeded_shards,
                clip_norm=norm, reducer_buckets=len(step._reducer.buckets))


def clip_norm_of(model):
    """The whole global norm of the model's current gradients."""
    from paddle_tpu_torch.nn.clip import _reduce_terms, _shard_groups

    params = [p for p in model.parameters() if p.grad is not None]
    return float(torch.sqrt(_reduce_terms([p.grad.float().square().sum() for p in params],
                                          _shard_groups(params))))


def linear_dist_step(w, b, x, y, lr):
    """The reference's ``test_dist_matches_single_device`` at dp 2: a
    ``Linear(16, 4)`` SGD step on an MSE loss through ``distributed_step``
    and ``shard_batch``; the updated weight and bias."""
    from paddle_tpu_torch.nn.layer import Linear
    from paddle_tpu_torch.optimizer import SGD

    fleet = _fleet(2, 1)
    net = Linear(16, 4, device="cpu")
    net.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    step = fleet.distributed_step(net, SGD(learning_rate=lr, parameters=net.parameters()),
                                  lambda out, t: ((out - t) ** 2).mean())
    loss = float(step(fleet.shard_batch(x), fleet.shard_batch(y))["loss"])
    return _np(net.weight), _np(net.bias), loss


def strategy_errors():
    """What ``distributed_step`` refuses at world 1."""
    import warnings

    from paddle_tpu_torch.nn.layer import Linear
    from paddle_tpu_torch.optimizer import SGD

    errors = {}
    for name, kw in (("sharding", dict(sharding=True, sharding_configs={"sharding_stage": 2})),
                     ("offload", dict(sharding=True, sharding_configs={"offload": True})),
                     ("fp16", dict(amp=True, amp_configs={"dtype": "float16", "level": "O2"}))):
        fleet = _fleet(1, 1, **kw)
        net = Linear(2, 2, device="cpu")
        try:
            step = fleet.distributed_step(net, SGD(parameters=net.parameters()),
                                          lambda o, t: o.sum())
            errors[name] = f"stage {step._zero.stage}" + (" offload" if step.optimizer._offload
                                                          else "")
        except (NotImplementedError, ValueError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    fleet = _fleet(1, 1, sharding_configs={"comm_overlap": False}, gradient_merge=True,
                   gradient_merge_configs={"k_steps": 2}, recompute=True)
    net = Linear(2, 2, device="cpu")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        step = fleet.distributed_step(net, SGD(parameters=net.parameters()), lambda o, t: o.sum())
    errors["warned"] = any("comm_overlap" in str(w.message) for w in seen)
    errors["knobs"] = (step.accumulate_steps, step.remat, step.amp_level)
    try:
        fleet.save_inference_model(net, "unused")
    except NotImplementedError as e:
        errors["save_inference_model"] = str(e)
    return errors


# -- tensor-parallel layers ----------------------------------------------------------
def mp_layers(mp, case):
    """The four tensor-parallel layers at mp (the whole world), each loaded
    with this rank's shard of ``case``'s full weights: outputs and
    gradients under the cotangents of ``case``."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.mp_layers import _shard

    fleet = _fleet(1, mp)
    g = fleet.get_hybrid_communicate_group().get_model_parallel_group()
    res = {}
    for gather in (True, False):
        col = D.ColumnParallelLinear(16, 8 * mp, gather_output=gather, device="cpu")
        col.weight.data.copy_(_shard(torch.from_numpy(case["col_w"]), 1, g))
        col.bias.data.copy_(_shard(torch.from_numpy(case["col_b"]), 0, g))
        x = torch.from_numpy(case["x"]).requires_grad_()
        out = col(x)
        ct = torch.from_numpy(case["col_ct"])
        (out * (ct if gather else _shard(ct, 2, g))).sum().backward()
        res[f"col_{gather}"] = (_np(out), _np(x.grad), _np(col.weight.grad), _np(col.bias.grad),
                                col.weight.is_distributed is True, col.weight.split_axis)
    fused = D.ColumnParallelLinear(16, 12 * mp, gather_output=True, blocks=3, device="cpu")
    fused.weight.data.copy_(_shard(torch.from_numpy(case["qkv_w"]), 1, g, blocks=3))
    fused.bias.data.zero_()
    res["fused"] = _np(fused(torch.from_numpy(case["x"])))
    for parallel in (False, True):
        row = D.RowParallelLinear(8 * mp, 16, input_is_parallel=parallel, device="cpu")
        row.weight.data.copy_(_shard(torch.from_numpy(case["row_w"]), 0, g))
        row.bias.data.copy_(torch.from_numpy(case["row_b"]))
        xr = torch.from_numpy(case["xr"])
        xr = (_shard(xr, 2, g) if parallel else xr).requires_grad_()
        out = row(xr)
        (out * torch.from_numpy(case["row_ct"])).sum().backward()
        res[f"row_{parallel}"] = (_np(out), _np(xr.grad), _np(row.weight.grad), _np(row.bias.grad),
                                  getattr(row.bias, "mp_group", None) is not None)
    emb = D.VocabParallelEmbedding(12 * mp, 16, device="cpu")
    emb.weight.data.copy_(_shard(torch.from_numpy(case["emb_w"]), 0, g))
    out = emb(torch.from_numpy(case["ids"]))
    (out * torch.from_numpy(case["emb_ct"])).sum().backward()
    res["emb"] = (_np(out), _np(emb.weight.grad))
    try:
        emb(torch.tensor([12 * mp]))
        res["emb_range"] = None
    except ValueError as e:
        res["emb_range"] = str(e)
    from paddle_tpu_torch.framework.selected_rows import compiled_step

    with compiled_step():
        res["emb_bad_inside_step"] = _np(emb(torch.tensor([-1, 12 * mp, 0])))
    logits = _shard(torch.from_numpy(case["logits"]), 2, g).requires_grad_()
    loss = D.ParallelCrossEntropy(ignore_index=-100)(logits, torch.from_numpy(case["labels"]))
    (loss * torch.from_numpy(case["ce_ct"])).sum().backward()
    res["ce"] = (_np(loss), _np(logits.grad))
    # TensorParallel: replicated parameters broadcast from the group's rank 0
    torch.manual_seed(D.get_rank())
    net = torch.nn.Sequential(torch.nn.Linear(3, 3), D.ColumnParallelLinear(3, 2 * mp,
                                                                          device="cpu"))
    D.TensorParallel(net, hcg=fleet.get_hybrid_communicate_group())
    res["tp_replicated"] = _np(net[0].weight)
    res["tp_shard"] = _np(net[1].weight)
    for bad in (lambda: D.ColumnParallelLinear(4, 3 * mp + 1, device="cpu"),
                lambda: D.VocabParallelEmbedding(5 * mp + 1, 4, device="cpu")):
        try:
            bad()
            res.setdefault("indivisible", []).append(None)
        except ValueError as e:
            res.setdefault("indivisible", []).append(str(e))
    # what the later parts of item 13 brought: Lamb over shards (its trust
    # ratio from the whole parameter's norms), GPT and ERNIE at mp > 1
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import Lamb

    lin = D.ColumnParallelLinear(4, 2 * mp, device="cpu")
    lin.weight.data.copy_(_shard(torch.arange(8.0 * mp).reshape(4, 2 * mp), 1, g))
    lin(torch.ones(1, 4)).sum().backward()
    Lamb(learning_rate=0.1, parameters=lin.parameters()).step()
    res["lamb_weight"] = _np(lin.weight)
    res["gpt_heads"] = GPTForPretraining(GPTConfig.tiny(), device="cpu").gpt.layers.num_heads
    res["ernie_heads"] = ErnieForPretraining(ErnieConfig.tiny(),
                                             device="cpu").ernie.layers[0].attn.num_heads
    return res


def rng_tracker(seed):
    """Draws from the fleet-seeded model-parallel stream and the default one."""
    import paddle_tpu_torch.distributed as D

    # tensor_parallel_configs gives the mp degree that hybrid_configs leaves at 1
    fleet = _fleet(1, 1, tensor_parallel_configs={"tensor_init_seed": seed,
                                                  "tensor_parallel_degree": D.get_world_size()})
    mp = fleet.get_hybrid_communicate_group().get_model_parallel_world_size()
    tracker = D.get_rng_state_tracker()
    with tracker.rng_state() as gen:
        shared = torch.rand(4, generator=gen)
    torch.manual_seed(100 + D.get_rank())
    own = torch.rand(4)
    try:
        tracker.add("model_parallel_rng", seed + 1)
        clash = None
    except ValueError as e:
        clash = str(e)
    return _np(shared), _np(own), sorted(tracker.get_states_tracker()), clash, mp


# -- SyncBatchNorm ------------------------------------------------------------------
def sync_bn(x, ct, weight, bias, momentum, epsilon):
    """``SyncBatchNorm`` at dp (the whole world) over this rank's block of
    ``x``: its output, the input gradient, the weight and bias gradients
    averaged over the ranks (as ``DataParallel`` averages them), and the
    running statistics after the step."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.nn.layer import SyncBatchNorm

    fleet = _fleet(D.get_world_size(), 1)
    xb, cb = fleet.shard_batch(x, ct)
    bn = SyncBatchNorm(x.shape[1], momentum=momentum, epsilon=epsilon, device="cpu")
    bn.weight.data.copy_(torch.from_numpy(weight))
    bn.bias.data.copy_(torch.from_numpy(bias))
    dp = D.DataParallel(bn)
    xb.requires_grad_()
    out = dp(xb)
    (out * cb).sum().backward()
    return dict(out=_np(out), dx=_np(xb.grad), dw=_np(bn.weight.grad), db=_np(bn.bias.grad),
                mean=_np(bn._mean), var=_np(bn._variance))


def resnet_sync_bn(np_state, x, y):
    """The port's ResNet18 with its batch norms converted to
    ``SyncBatchNorm``, one training forward and loss at dp (the world) over
    this rank's block of ``x``: the logits, the dp-mean loss and the
    running statistics of the first batch norm."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.nn.layer import CrossEntropyLoss, SyncBatchNorm
    from paddle_tpu_torch.vision.models import resnet18

    fleet = _fleet(D.get_world_size(), 1)
    model = resnet18(num_classes=10, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in np_state.items()})
    SyncBatchNorm.convert_sync_batchnorm(model)
    model.train()
    xb, yb = fleet.shard_batch(x, y)
    out = model(xb)
    loss = CrossEntropyLoss()(out, yb)
    D.all_reduce(loss, op="avg")
    return dict(logits=_np(out), loss=float(loss), mean=_np(model.bn1._mean),
                var=_np(model.bn1._variance))


# -- ZeRO, the pipeline and the hybrid step -------------------------------------------
def _hybrid_fleet(c):
    """``fleet.init`` at config ``c``'s degrees (``dp``, ``mp``, ``pp``,
    ``sdp``, ``sep``), ZeRO stage, micro-batches and schedule."""
    import paddle_tpu_torch.distributed as D

    s = D.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": c.get("dp", 1), "mp_degree": c.get("mp", 1),
                        "pp_degree": c.get("pp", 1), "sharding_degree": c.get("sdp", 1),
                        "sep_degree": c.get("sep", 1)}
    if c.get("stage"):
        s.sharding = True
        s.sharding_configs = {"sharding_stage": c["stage"], "offload": c.get("offload", False)}
    s.pipeline_configs = {"accumulate_steps": c.get("accumulate", 1),
                          "schedule": c.get("schedule", "gpipe")}
    D.fleet.init(is_collective=True, strategy=s, device="cpu")
    return D.fleet


def _optimizer(c, model):
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, Lamb

    clip = ClipGradByGlobalNorm(c["clip"]) if c.get("clip") else None
    if c.get("optimizer") == "lamb":
        return Lamb(learning_rate=c["lr"], parameters=model.parameters(), grad_clip=clip)
    return AdamW(learning_rate=c["lr"], parameters=model.parameters(), grad_clip=clip)


def _moments(opt, model):
    """The optimizer's moments by parameter name (this rank's ZeRO blocks)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {k: {names[id(p)]: _np(t) for p, t in zip(opt._params, ts)}
            for k, ts in (opt._state or {}).items()}


def gpt_hybrid(configs, np_state, ids, mask=None):
    """Each config of ``configs`` (its degrees ``dp``, ``mp``, ``pp``,
    ``sdp``, ZeRO ``stage``, pipeline ``schedule`` and ``accumulate``,
    ``layers``, ``cfg`` (more ``GPTConfig.tiny`` keywords), ``optimizer``,
    ``lr``, ``clip``, ``steps``, and ``state``, the full state to load in
    place of ``np_state``; ``nan_at``, the dispatch whose gradients the
    chaos injector fills with NaN, under the training guard; its world the
    whole world) in turn: a stacked
    GPT built on the meta device and loaded with this rank's part of the
    full state, then
    ``fleet.distributed_step`` over ``shard_batch``'s block of ``ids``
    (labels = ids, with ``mask`` as the loss mask if given). Per config:
    the losses, this rank's coordinates, state, moments and ZeRO split
    dims, the pipeline's peak of held stage inputs and its order, the
    collective counters, and under the guard the skipped steps."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.sharding import state_shardings
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.testing import chaos
    from paddle_tpu_torch.utils.convert import shard_state

    out = []
    for c in configs:
        state = c.get("state", np_state)
        guard = c.get("nan_at") is not None
        fleet = _hybrid_fleet(c)
        hcg = fleet.get_hybrid_communicate_group()
        cfg = GPTConfig.tiny(num_layers=c.get("layers", 4), **c.get("cfg", {}))
        model = GPTForPretraining(cfg, device="meta")
        model.to_empty(device="cpu")
        pp_rank, mp_rank = hcg.get_pipe_parallel_rank(), hcg.get_model_parallel_rank()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in shard_state(
            state, mp_rank, c.get("mp", 1), cfg, pp_rank=pp_rank,
            pp_degree=c.get("pp", 1)).items()})
        opt = _optimizer(c, model)
        if guard:
            with chaos.inject(FLAGS_chaos_nan_at_step=c["nan_at"], FLAGS_train_guard=True):
                step = fleet.distributed_step(model, opt, GPTPretrainingCriterion())
        else:
            step = fleet.distributed_step(model, opt, GPTPretrainingCriterion())
        leaves = fleet.shard_batch(ids) if mask is None else fleet.shard_batch(ids, mask)
        x = leaves if mask is None else leaves[0]
        labels = x if mask is None else leaves
        metrics.reset_counters("collective.")
        metrics.reset_counters("kernels.")
        registry.clear_cache()
        losses = [float(step(x, labels)["loss"]) for _ in range(c.get("steps", 3))]
        sched = step.last_schedule
        skipped = step.state["skipped"] if guard else None
        out.append(dict(
            losses=losses, coord=hcg.coord, stage_rank=(pp_rank, hcg.get_sharding_parallel_rank(),
                                                        mp_rank),
            state={k: _np(v) for k, v in model.state_dict().items()},
            moments=_moments(opt, model), sdp_dims=state_shardings(model, hcg),
            state_devices=sorted({(t.device.type, t.is_pinned()) for ts in opt._state.values()
                                  for t in ts}),
            peak_held=None if sched is None else sched.peak_held,
            order=None if sched is None else sched.order, n_micro=step.n_micro,
            counters=metrics.counters("collective."),
            picked=metrics.counters("kernels.attention_core."), skipped=skipped))
        D.fleet._hcg = None
    return out


def sharding_levels():
    """``group_sharded_parallel``'s three levels through
    ``fleet.distributed_step`` at sdp = the world (the strategy names no
    stage), and what it refuses."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    fleet = _hybrid_fleet(dict(sdp=D.get_world_size()))
    out = {}
    for level in ("os", "os_g", "p_g_os"):
        model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=3)
        opt = AdamW(parameters=model.parameters())
        m, o, scaler = D.group_sharded_parallel(model, opt, level=level)
        step = fleet.distributed_step(m, o, GPTPretrainingCriterion())
        out[level] = (m is model and o is opt, scaler, step._zero.stage,
                      tuple(model.gpt.layers.qkv_w.shape))
    try:
        D.group_sharded_parallel(model, opt, level="os_x")
    except ValueError as e:
        out["level"] = f"{type(e).__name__}: {e}"
    for name, offload in (("offload", True), ("strategy_offload", False)):
        model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=3)
        opt = AdamW(parameters=model.parameters())
        m, o, _ = D.group_sharded_parallel(model, opt, offload=offload)
        fleet._strategy.sharding_configs.offload = not offload
        step = fleet.distributed_step(m, o, GPTPretrainingCriterion())
        out[name] = (step._zero.stage, step.optimizer._offload)
    D.fleet._hcg = None
    return out


def several(calls):
    """Each ``(name, args)`` of ``calls`` in turn: this module's function
    ``name`` on ``args``; their results, in order (one world for several
    bodies)."""
    return [globals()[name](*args) for name, args in calls]


def _tied_head(layer, x):
    """The tied use of a shared ``Linear``: ``x @ W^T`` (a language model's
    head on its embedding)."""
    return x @ layer.weight.T


def pipeline_layers(weights, x, lr, shared=None):
    """``PipelineLayer`` over the fleet's pp = the world: a ``Linear`` per
    entry of ``weights`` (``(w, b)``, numpy), this stage's segment loaded;
    the pipelined inference output of ``x`` (2 micro-batches, on every
    stage), and this stage's layers after one ``distributed_step`` of SGD
    at ``lr`` on ``mean(out ** 2)``. With ``shared`` (``(ws, bs, wm,
    bm)``), a second model: a shared ``Linear`` on the first stage, a plain
    one, and the shared one's tied use on the last stage; its stages'
    copies of the shared weight after one such step."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.nn.layer import Linear
    from paddle_tpu_torch.optimizer import SGD

    world = D.get_world_size()
    fleet = _hybrid_fleet(dict(pp=world, accumulate=2))
    hcg = fleet.get_hybrid_communicate_group()
    stage, group = hcg.get_pipe_parallel_rank(), hcg.get_pipe_parallel_group()
    d = weights[0][0].shape[0]
    pl = D.PipelineLayer([D.LayerDesc(Linear, d, d, device="cpu") for _ in weights])
    lo = pl.segments[stage]
    with torch.no_grad():
        for j, layer in enumerate(pl.layers):
            layer.weight.copy_(torch.from_numpy(weights[lo + j][0]))
            layer.bias.copy_(torch.from_numpy(weights[lo + j][1]))
    xt = torch.from_numpy(x)
    out = D.pipeline_forward(pl, xt, group, stage, world, n_micro=2)
    step = fleet.distributed_step(pl, SGD(learning_rate=lr, parameters=pl.parameters()),
                                  lambda o, y: (o ** 2).mean())
    loss = float(step(xt, xt)["loss"])
    res = dict(out=_np(out), loss=loss, segments=pl.segments, stage=stage,
               layers=[(_np(layer.weight), _np(layer.bias)) for layer in pl.layers])
    if shared is not None:
        ws, bs, wm, bm = shared
        tied = D.PipelineLayer([D.SharedLayerDesc("tied", Linear, d, d, device="cpu"),
                                D.LayerDesc(Linear, d, d, device="cpu"),
                                D.SharedLayerDesc("tied", Linear, d, d, device="cpu",
                                                  forward_func=_tied_head)])
        with torch.no_grad():
            if stage == 0:  # the copy on the last stage starts from this one
                tied.shared_layers["tied"].weight.copy_(torch.from_numpy(ws))
                tied.shared_layers["tied"].bias.copy_(torch.from_numpy(bs))
                tied.layers[0].weight.copy_(torch.from_numpy(wm))
                tied.layers[0].bias.copy_(torch.from_numpy(bm))
            C = D.collective
            C.broadcast(tied.shared_layers["tied"].weight.data, src=0, group=tied._shared["tied"][0])
        step = fleet.distributed_step(tied, SGD(learning_rate=lr, parameters=tied.parameters()),
                                      lambda o, y: (o ** 2).mean())
        res["tied_loss"] = float(step(xt, xt)["loss"])
        res["tied_weight"] = _np(tied.shared_layers["tied"].weight)
        res["tied_segments"] = tied.segments
    D.fleet._hcg = None
    return res


def ernie_steps(dp, mp, cfg_kw, np_state, inputs, labels, steps, lr):
    """``fleet.distributed_step`` of ERNIE at dp x mp over ``steps`` steps
    of the global batch (numpy), from the full state ``np_state`` (each
    rank loads its mp shard): the losses, this rank's final state and
    coordinates, and the attention kernels picked."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.models.ernie import (ErnieConfig, ErnieForPretraining,
                                               ErniePretrainingCriterion)
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils.convert import shard_state

    fleet = _fleet(dp, mp)
    hcg = fleet.get_hybrid_communicate_group()
    cfg = ErnieConfig.tiny(**cfg_kw)
    model = ErnieForPretraining(cfg, device="cpu", seed=7)
    mp_rank = hcg.get_model_parallel_rank()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           shard_state(np_state, mp_rank, mp, cfg).items()})
    crit = ErniePretrainingCriterion()

    def loss_fn(outs, mlm, sop):
        return crit(outs[0], outs[1], mlm, sop)

    step = fleet.distributed_step(model, AdamW(learning_rate=lr, parameters=model.parameters()),
                                  loss_fn)
    ids, mlm, sop = fleet.shard_batch(*inputs, *labels)
    metrics.reset_counters("kernels.")
    registry.clear_cache()
    losses = [float(step(ids, (mlm, sop))["loss"]) for _ in range(steps)]
    out = dict(losses=losses, state={k: _np(v) for k, v in model.state_dict().items()},
               dp_rank=hcg.get_data_parallel_rank(), mp_rank=mp_rank,
               heads=model.ernie.layers[0].attn.num_heads,
               picked=metrics.counters("kernels.sdpa."))
    D.fleet._hcg = None
    return out


# -- expert parallelism ------------------------------------------------------------
def gpt_moe(configs, ids):
    """Each config of ``configs`` in turn (``dp``, the world; ``experts``;
    ``cfg``, more ``GPTConfig.tiny`` keywords; ``state``, the full numpy state or None to build from ``seed``;
    ``jitter``, GShard's random routing on; ``meta``, build on the meta
    device; ``clip``; ``lr``; ``steps``): a tiny GPT-MoE (every block MoE)
    whose experts shard over dp, loaded with this rank's experts of
    ``state``, then ``fleet.distributed_step`` of AdamW over
    ``shard_batch``'s block of ``ids`` (labels = ids). Per config: the
    losses, this rank's dp rank and state, the moe kernel picked, and the
    collective counters."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.utils.convert import shard_state

    out = []
    for c in configs:
        fleet = _hybrid_fleet(dict(dp=c["dp"]))
        r = fleet.get_hybrid_communicate_group().get_data_parallel_rank()
        cfg = GPTConfig.tiny(moe=c["experts"], moe_every=1, **c.get("cfg", {}))
        model = GPTForPretraining(cfg, device="meta" if c.get("meta") else "cpu",
                                  seed=c.get("seed", 0))
        if c.get("meta"):
            model.to_empty(device="cpu")
        if c.get("state") is not None:
            model.load_state_dict({k: torch.from_numpy(v) for k, v in shard_state(
                c["state"], ep_rank=r, ep_degree=c["dp"]).items()})
        for blk in model.gpt.layers:
            blk.moe.gate.random_routing = bool(c.get("jitter"))
        step = fleet.distributed_step(model, _optimizer(dict(lr=c.get("lr", 1e-3),
                                                             clip=c.get("clip")), model),
                                      GPTPretrainingCriterion())
        x = fleet.shard_batch(ids)
        metrics.reset_counters("collective.")
        metrics.reset_counters("kernels.")
        registry.clear_cache()
        losses = [float(step(x, x)["loss"]) for _ in range(c.get("steps", 3))]
        out.append(dict(losses=losses, dp_rank=r, state={k: _np(v) for k, v in
                                                         model.state_dict().items()},
                        picked=metrics.counters("kernels.moe."),
                        counters=metrics.counters("collective.")))
        D.fleet._hcg = None
    return out


def expert_exchange(counts, width):
    """``global_scatter`` then ``global_gather`` over the world: this rank
    sends ``counts[r][j * ne + i]`` rows (row values ``1000 r + k``) to
    expert i of rank j; what it received, what came back, and the gradient
    of a weighted sum through both; plus the count errors."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.utils import global_gather, global_scatter

    r, n = D.get_rank(), D.get_world_size()
    counts = np.asarray(counts)
    lc = counts[r]
    gc = counts[:, r * (counts.shape[1] // n):(r + 1) * (counts.shape[1] // n)].reshape(-1)
    rows = int(lc.sum())
    x = (1000.0 * r + torch.arange(rows * width, dtype=torch.float32).reshape(rows, width))
    x.requires_grad_(True)
    recv = global_scatter(x, torch.from_numpy(lc), torch.from_numpy(gc))
    back = global_gather(recv * 2.0, lc, gc)
    (back * torch.arange(1.0, rows + 1)[:, None]).sum().backward()
    errors = []
    for call in (lambda: global_scatter(x[:-1], lc, gc), lambda: global_gather(recv, gc, gc[:-1]),
                 lambda: global_scatter(x, np.append(lc, 0), np.append(gc, 0))):
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return dict(recv=_np(recv), back=_np(back), grad=_np(x.grad), errors=errors)


def moe_refusals():
    """What a world of 2 refuses around GPT-MoE: ZeRO with sharded experts,
    the per-layer trunk at mp 2 and at sep 2, and experts that every rank
    holds whole under ``DataParallel``."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig.tiny(moe=4, moe_every=1)
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
        D.fleet._hcg = None

    def zero():
        fleet = _hybrid_fleet(dict(dp=2, stage=2))
        model = GPTForPretraining(cfg, device="cpu")
        fleet.distributed_step(model, AdamW(parameters=model.parameters()),
                               GPTPretrainingCriterion())

    def on(**degrees):
        _hybrid_fleet(degrees)
        GPTForPretraining(cfg, device="cpu")

    attempt("zero", zero)
    attempt("mp", lambda: on(mp=2))
    attempt("sep", lambda: on(sep=2))
    attempt("replicated", lambda: D.DataParallel(GPTForPretraining(cfg, device="cpu")))
    return out


# -- sequence parallelism ----------------------------------------------------------
def seq_attention(q, k, v):
    """``ring_attention`` and ``ulysses_attention`` over the world as one
    ``sep`` group, causal and full, on this rank's sequence block of the
    global ``[b, s, h, d]`` q, k, v: per case the output block and the
    gradients of ``mean(out ** 2)`` over the global output for this rank's
    q, k and v blocks."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.ring_attention import ring_attention, ulysses_attention

    fleet = _hybrid_fleet(dict(sep=D.get_world_size()))
    hcg = fleet.get_hybrid_communicate_group()
    r, n = hcg.get_sep_parallel_rank(), hcg.get_sep_parallel_world_size()
    c = q.shape[1] // n
    out = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for causal in (True, False):
            qkv = [torch.from_numpy(np.ascontiguousarray(t[:, r * c:(r + 1) * c])).requires_grad_()
                   for t in (q, k, v)]
            o = fn(*qkv, group="sep", causal=causal)
            ((o ** 2).sum() / (q.size)).backward()
            out[(name, causal)] = dict(out=_np(o), grads=[_np(t.grad) for t in qkv])
    try:
        ulysses_attention(*(torch.zeros(1, 4, n + 1, 8) for _ in range(3)), group="sep")
        out["uneven_heads"] = None
    except ValueError as e:
        out["uneven_heads"] = str(e)
    D.fleet._hcg = None
    return out


# -- decoding at mp > 1, the ep token-count check, checkpoints over a mesh ---------
def gpt_mp_decode(np_state, ids, max_new, cfg_kw=None):
    """Greedy ``generate`` of a stacked GPT at mp = the world: each rank
    built on the meta device and loaded with its shard of ``np_state``.
    Returns the tokens, the rank's heads and its qkv shard's shape."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.utils.convert import shard_state

    world = D.get_world_size()
    fleet = _hybrid_fleet(dict(mp=world))
    hcg = fleet.get_hybrid_communicate_group()
    cfg = GPTConfig.tiny(**(cfg_kw or {}))
    model = GPTForPretraining(cfg, device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in shard_state(
        np_state, hcg.get_model_parallel_rank(), world, cfg).items()})
    tokens = model.eval().generate(torch.as_tensor(ids), max_new_tokens=max_new)
    D.fleet._hcg = None
    return dict(tokens=_np(tokens), heads=model.gpt.layers.num_heads,
                qkv=tuple(model.gpt.layers.qkv_w.shape))


def gpt_decode_refusals():
    """What decoding refuses at the world's degree: ``generate`` at pp =
    world, the serving engine over an mp-sharded model."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining

    out = {}
    for name, degrees, call in (
            ("pp", dict(pp=D.get_world_size()),
             lambda m: m.generate(torch.zeros(1, 4, dtype=torch.long), max_new_tokens=2)),
            ("engine_mp", dict(mp=D.get_world_size()),
             lambda m: DecodeEngine(m, max_batch_slots=1, max_seq_len=32))):
        _hybrid_fleet(degrees)
        try:
            call(GPTForPretraining(GPTConfig.tiny(), device="cpu").eval())
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
        D.fleet._hcg = None
    return out


def moe_unequal_tokens():
    """A MoE layer with its experts over dp = the world, fed a batch of a
    different length on each rank: the error the forward raises (not a
    hang in the exchange)."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.moe import MoELayer

    _hybrid_fleet(dict(dp=D.get_world_size()))
    layer = MoELayer(16, 32, num_experts=4, device="cpu", seed=0)
    x = torch.randn(1, 8 + 2 * D.get_rank(), 16, generator=torch.Generator().manual_seed(1))
    try:
        layer(x)
        out = None
    except ValueError as e:
        out = str(e)
    D.fleet._hcg = None
    return out


def mesh_checkpoints(cases, ids, restore_dir, steps):
    """Checkpoints over meshes of the world's size: for each case (its
    degrees and ZeRO ``stage``, as ``gpt_hybrid``'s configs, ``dir`` and
    ``async_dir``), a tiny GPT (f32, AdamW) takes ``steps`` steps on its
    block of ``ids`` and a ``CheckpointManager`` saves it whole into the
    case's ``dir``; ``save_train_step(async_save=True)`` writes it again
    into ``async_dir`` and one more step runs before the handle is waited
    on; then a fresh step on the same mesh restores the world-1 checkpoint
    under ``restore_dir``. Per case: what the rank holds after the save
    and after the restore (numpy), its ``(pp, sdp, mp)`` coordinates and
    ZeRO split dims, the losses, whether the asynchronous save gave this
    rank a handle and the loss of the step after it."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.checkpoint import save_train_step
    from paddle_tpu_torch.distributed.resilience import CheckpointManager
    from paddle_tpu_torch.distributed.sharding import state_shardings
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    def held(step):  # copies: the step's state is views of its tensors
        st = step.state
        return dict(params={n: _np(t).copy() for n, t in st["params"].items()},
                    opt={k: {n: _np(t).copy() for n, t in v.items()}
                         for k, v in st["opt"].items()},
                    step=st["step"])

    out = []
    for c in cases:
        res = {}
        for key in ("written", "restored"):
            fleet = _hybrid_fleet(c)
            hcg = fleet.get_hybrid_communicate_group()
            model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=3)
            step = TrainStep(model, AdamW(learning_rate=1e-3, parameters=model.parameters()),
                             GPTPretrainingCriterion(), mesh=hcg,
                             state_shardings=c.get("stage", 0))
            if key == "written":
                block = fleet.shard_batch(torch.as_tensor(ids))
                res["losses"] = [float(step(block, block)["loss"]) for _ in range(steps)]
                CheckpointManager(c["dir"]).save(step, steps)
                res[key] = held(step)
                # an asynchronous save, then a step (its collectives) at once
                pending = save_train_step(step, c["async_dir"], async_save=True)
                res["async_handle"] = pending is not None
                res["after_async_loss"] = float(step(block, block)["loss"])
                if pending is not None:
                    pending.wait()
            else:
                restored = CheckpointManager(restore_dir).restore_latest(target=step)
                assert restored is not None and restored[0] is step
                res[key] = held(step)
            res["coord"] = (hcg.get_pipe_parallel_rank(), hcg.get_sharding_parallel_rank(),
                            hcg.get_model_parallel_rank())
            res["sdp_dims"] = state_shardings(model, hcg, c.get("stage", 0) or 1)
            D.fleet._hcg = None
        out.append(res)
    return out


def guarded_mesh_steps(ids, nan_at, steps):
    """A guarded tiny GPT (f32, AdamW, ZeRO stage 2 over sdp = the world)
    with NaN gradients injected at dispatch ``nan_at``: ``steps`` steps in
    one ``run_steps`` on its block of ``ids``. Returns the health leaves,
    the losses and the whole state gathered back (numpy)."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.converter import gather_to_host
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing import chaos

    fleet = _hybrid_fleet(dict(sdp=D.get_world_size(), stage=2))
    hcg = fleet.get_hybrid_communicate_group()
    model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=3)
    with chaos.inject(FLAGS_chaos_nan_at_step=nan_at):
        step = TrainStep(model, AdamW(learning_rate=1e-3, parameters=model.parameters()),
                         GPTPretrainingCriterion(), mesh=hcg, state_shardings=2, guard=True)
    block = fleet.shard_batch(torch.as_tensor(ids))
    m = step.run_steps([(block, block)] * steps)
    whole = gather_to_host(step)
    D.fleet._hcg = None
    return dict(bad=_np(m["health"]["bad_step"]).tolist(),
                skipped=_np(m["health"]["skipped"]).tolist(), losses=_np(m["loss"]).tolist(),
                params={n: _np(t) for n, t in whole["params"].items()}, step=whole["step"])


def dropout_streams(seed, ids):
    """A tiny dropout GPT's dropout at dp = world, then at mp = world: the
    keep masks one ``fleet.distributed_step`` step draws on this rank
    (``ids`` is the rank's block of the batch at dp, the whole batch at
    mp)."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.nn.functional import common
    from paddle_tpu_torch.optimizer import AdamW

    real = common.dropout_mask
    out = []
    for axis in ("dp", "mp"):
        drawn = []

        def recording(shape, p, generator=None, device=None):
            keep = real(shape, p, generator, device)
            drawn.append(_np(keep))
            return keep

        common.dropout_mask = recording
        fleet = _hybrid_fleet({axis: D.get_world_size()})
        model = GPTForPretraining(GPTConfig.tiny(dropout=0.1), device="cpu", seed=1)
        step = fleet.distributed_step(model, AdamW(parameters=model.parameters()),
                                      GPTPretrainingCriterion(), seed=seed)
        x = torch.from_numpy(ids)
        step(x, x)
        common.dropout_mask = real
        D.fleet._hcg = None
        out.append(drawn)
    return tuple(out)


# -- dropout at mp, sep, pp and ep > 1 ------------------------------------------------
def masked(table, name, *args):
    """This module's ``name(*args)`` with every dropout draw of the port fed
    from ``table``: the keep mask (a numpy bool array of the shape drawn)
    by the seed of the generator it is drawn from. Returns its result and
    the seeds drawn, in order."""
    from paddle_tpu_torch.nn.functional import common

    real, seeds = common.dropout_mask, []

    def feed(shape, p, generator=None, device=None):
        seeds.append(generator.initial_seed())
        keep = table[seeds[-1]]
        assert keep.shape == tuple(shape), (keep.shape, tuple(shape))
        return torch.from_numpy(keep).to(device)

    common.dropout_mask = feed
    try:
        return globals()[name](*args), seeds
    finally:
        common.dropout_mask = real


def dropout_resume(c, np_state, ids, ck_dir, steps):
    """A stacked dropout GPT at config ``c``'s degrees (``gpt_hybrid``'s
    keys) loaded with this rank's part of ``np_state``: ``steps`` steps, a
    ``CheckpointManager`` save, ``steps`` more; then a fresh step on the
    same mesh restored from the save and its ``steps`` steps. Returns both
    runs' later losses and this rank's parameters after each."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.resilience import CheckpointManager
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.utils.convert import shard_state

    def made():
        fleet = _hybrid_fleet(c)
        hcg = fleet.get_hybrid_communicate_group()
        cfg = GPTConfig.tiny(num_layers=c.get("layers", 4), **c.get("cfg", {}))
        model = GPTForPretraining(cfg, device="meta")
        model.to_empty(device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in shard_state(
            np_state, hcg.get_model_parallel_rank(), c.get("mp", 1), cfg,
            pp_rank=hcg.get_pipe_parallel_rank(), pp_degree=c.get("pp", 1)).items()})
        step = fleet.distributed_step(model, _optimizer(c, model), GPTPretrainingCriterion())
        return fleet, model, step

    fleet, model, step = made()
    x = fleet.shard_batch(ids)
    for _ in range(steps):
        step(x, x)
    CheckpointManager(ck_dir).save(step, steps)
    later = [float(step(x, x)["loss"]) for _ in range(steps)]
    state = {k: _np(v).copy() for k, v in model.state_dict().items()}
    D.fleet._hcg = None
    fleet, model, fresh = made()
    assert CheckpointManager(ck_dir).restore_latest(target=fresh) is not None
    resumed = [float(fresh(x, x)["loss"]) for _ in range(steps)]
    out = dict(later=later, resumed=resumed, state=state,
               resumed_state={k: _np(v) for k, v in model.state_dict().items()})
    D.fleet._hcg = None
    return out

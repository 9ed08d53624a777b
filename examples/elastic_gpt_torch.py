"""Elastic GPT training on the PyTorch port, one worker of
``python -m paddle_tpu_torch.distributed.launch --elastic_np MIN:MAX``.

Each worker joins the world the launcher describes (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``), trains a stacked GPT with AMP
O2 and AdamW at ZeRO stage 2 over ``sdp`` = the world, each rank on its
block of one global batch, and checkpoints the step (written whole by
world rank 0) after every step. A relaunched worker restores the newest
checkpoint through the converter onto its own world, checks that its state
gathered back is bitwise the checkpoint's, and trains on. Above one rank
the workers stop after ``--world_steps`` steps and wait for the launcher
to rescale them (a membership change); at world 1 they run to
``--total_steps`` and exit.

One JSON line per event goes to ``--log``: ``{"event": "step", "world",
"step", "loss", "launches_by_rank"}`` after each step (the loss as
``float.hex`` too, for bitwise comparisons; each rank's launches of each
hand-written kernel in that step, its counts set to 0 just before it) and
``{"event": "restored", "world", "step", "bitwise", "leaves"}`` after a
restore.

On the CPU (gloo)::

    python -m paddle_tpu_torch.distributed.launch --nnodes 2 --nproc_per_node 1 \\
        --rank 0 --master 127.0.0.1:29500 --elastic_np 1:2 \\
        examples/elastic_gpt_torch.py --device cpu --ckpt /tmp/ckpt --log /tmp/log.jsonl

(and the same with ``--rank 1`` for the second node). On the card,
``--device cuda:0``: several workers share the card over gloo, a world of
one runs NCCL.
"""
import argparse
import json
import os
import time

import torch


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", default='{"vocab_size": 512, "hidden_size": 64, "num_layers": 2, '
                                       '"num_heads": 4, "max_seq_len": 128}',
                   help="GPTConfig keywords, JSON")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--amp_level", default="O2")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--keep", type=int, default=3)
    p.add_argument("--log", required=True)
    p.add_argument("--world_steps", type=int, default=2)
    p.add_argument("--total_steps", type=int, default=4)
    a = p.parse_args()

    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import converter
    from paddle_tpu_torch.distributed.checkpoint import flatten, load_state
    from paddle_tpu_torch.distributed.resilience import CheckpointManager
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
    from paddle_tpu_torch.ops import kernel_launches, kernel_wrappers
    from paddle_tpu_torch.optimizer import AdamW

    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    dev = torch.device(a.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    D.init_parallel_env(backend="gloo" if world > 1 or dev.type == "cpu" else None, device=dev)
    strategy = D.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "sharding_degree": world}
    D.fleet.init(is_collective=True, strategy=strategy, device=a.device)
    hcg = D.fleet.get_hybrid_communicate_group()
    rank = D.get_rank()

    cfg = GPTConfig(**json.loads(a.config))
    model = GPTForPretraining(cfg, device=dev, seed=a.seed)
    step = TrainStep(model, AdamW(learning_rate=a.lr, parameters=model.parameters()),
                     GPTPretrainingCriterion(), mesh=hcg, state_shardings=2,
                     amp_level=a.amp_level)
    ids = torch.randint(0, cfg.vocab_size, (a.batch, a.seq), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(a.seed + 2))
    block = ids.chunk(world)[hcg.get_sharding_parallel_rank()]

    def log(**event):
        if rank == 0:
            with open(a.log, "a") as f:
                f.write(json.dumps(dict(event, world=world)) + "\n")

    mgr = CheckpointManager(a.ckpt, keep_last_k=a.keep)
    start = 0
    restored = mgr.restore_latest(target=step)
    if restored is not None:
        start = restored[1]
        whole = converter.gather_to_host(step)
        saved = load_state(os.path.join(mgr._step_dir(start), "state"))
        mine, theirs = dict(flatten(whole)), dict(flatten(saved))
        same = set(mine) == set(theirs) and all(
            torch.equal(torch.as_tensor(mine[k]), torch.as_tensor(theirs[k])) for k in mine)
        log(event="restored", step=start, bitwise=same, leaves=len(mine),
            read_s=mgr.last_restore.get("read"), crc_s=mgr.last_restore.get("crc"),
            convert_s=mgr.last_restore.get("convert"))
    for i in range(start, a.total_steps):
        if world > 1 and i >= a.world_steps:
            while True:  # hold: the launcher rescales the world
                time.sleep(0.5)
        for wrapper in kernel_wrappers():
            wrapper.launches = 0
        t0 = time.perf_counter()
        loss = float(step(block, block)["loss"])
        seconds = time.perf_counter() - t0
        launches = [kernel_launches()]
        if world > 1:
            launches = [None] * world
            torch.distributed.all_gather_object(launches, kernel_launches())
        mgr.save(step, i + 1)
        log(event="step", step=i, loss=loss, loss_hex=loss.hex(), seconds=seconds,
            save=mgr.last_save, launches_by_rank=launches)


if __name__ == "__main__":
    main()

"""Checkpoints, resume and the converter of the port against ``paddle_tpu``'s,
on the CPU.

- Resume: the tiny GPT (the reference's weights of ``paddle.seed(21)``,
  carried across by ``utils/convert.py``) trains 4 steps of AMP O2 with
  AdamW under a warm-up + cosine schedule, once straight through and once
  saved after step 2 (``checkpoint.save_train_step``) and restored into a
  fresh step built from other weights: steps 3-4 and the final state are
  bitwise the uninterrupted run's. The reference resumes the same way
  (orbax); the port's resumed losses are within rtol 2e-4 of its (O2: the
  two frameworks round activations to bf16 at different places,
  ``tests/test_torch_train.py``; measured here 1.5e-5 and 9.0e-6).
- The converter over 2 gloo ranks at sdp 2 (ZeRO-2 and ZeRO-3), mp 2 and
  pp 2: a step's checkpoint, written whole by rank 0, restores into a
  world-1 step bitwise equal to the ranks' pieces joined by
  ``utils/convert.py:gather_state``; a world-1 checkpoint restores into
  each rank's pieces, bitwise those ``shard_state`` cuts.
- An asynchronous save over the mesh meets the same barrier on every
  rank (the next step's collectives pair up) and writes the same bytes.
- ``CheckpointConversionError`` names the first mismatched leaf (a model
  whose config changed), and ``restore_latest`` lets it propagate.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed import checkpoint as jckpt  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models.gpt import GPTForPretraining as JGPT  # noqa: E402
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion  # noqa: E402
from paddle_tpu.optimizer import lr as jlr  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from torch_hybrid_reference import started  # noqa: E402
from paddle_tpu_torch.distributed import checkpoint as ckpt  # noqa: E402
from paddle_tpu_torch.distributed.converter import (CheckpointConversionError,  # noqa: E402
                                                     convert, gather_to_host, tree_shardings)
from paddle_tpu_torch.distributed.resilience import CheckpointManager  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.optimizer import lr as tlr  # noqa: E402
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu  # noqa: E402

O2_RTOL = 2e-4
BATCHES = [np.random.default_rng(22 + i).integers(0, 512, (2, 32)).astype(np.int32)
           for i in range(4)]
IDS = np.random.default_rng(30).integers(0, 512, (8, 16)).astype(np.int64)


def _schedule(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=10), warmup_steps=2,
                            start_lr=0.0, end_lr=1e-3)


@pytest.fixture(scope="module")
def weights():
    paddle.seed(21)
    jm = JGPT(JGPTConfig.tiny())
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_step(state, seed=0):
    model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=seed)
    if state is not None:
        model.load_state_dict(state_dict_from_paddle_tpu(state))
    return TrainStep(model, AdamW(learning_rate=_schedule(tlr), parameters=model.parameters()),
                     GPTPretrainingCriterion(), amp_level="O2")


def _reference_step(state, seed=0):
    paddle.seed(seed)
    jm = JGPT(JGPTConfig.tiny())
    if state is not None:
        jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return JTrainStep(jm, paddle.optimizer.AdamW(learning_rate=_schedule(jlr),
                                                 parameters=jm.parameters()),
                      JCriterion(), amp_level="O2")


@contextlib.contextmanager
def _one_thread():
    """One CPU thread for runs compared in bits within this process (as the
    ranks of ``testing.dist`` run): on the default threads the first O2
    run of a pytest process was seen to differ in its last bits from the
    same run repeated, in about one process of four."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_o2_resume_is_bitwise_the_uninterrupted_run_and_near_paddle_tpu(weights, tmp_path):
    with _one_thread():
        straight = _port_step(weights)
        want = [float(straight(b, b)["loss"]) for b in BATCHES]
        first = _port_step(weights)
        for b in BATCHES[:2]:
            first(b, b)
        ckpt.save_train_step(first, str(tmp_path / "port"))
        resumed = ckpt.load_train_step(_port_step(None, seed=9), str(tmp_path / "port"))
        assert resumed.state["step"] == 2 and resumed.state["lr"]["last_epoch"] == 0
        got = [float(resumed(b, b)["loss"]) for b in BATCHES[2:]]
    assert got == want[2:]  # bitwise
    a, b = straight.state, resumed.state
    for key in ("params", "buffers"):
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), n
    for k in a["opt"]:
        for n in a["opt"][k]:
            assert torch.equal(a["opt"][k][n], b["opt"][k][n]), (k, n)
    assert a["step"] == b["step"] == 4

    jfirst = _reference_step(weights)
    for bt in BATCHES[:2]:
        jfirst(paddle.to_tensor(bt), paddle.to_tensor(bt))
    jckpt.save_train_step(jfirst, str(tmp_path / "ref"))
    jresumed = _reference_step(None, seed=9)
    jckpt.load_train_step(jresumed, str(tmp_path / "ref"))
    jgot = [float(jresumed(paddle.to_tensor(bt), paddle.to_tensor(bt))["loss"].numpy())
            for bt in BATCHES[2:]]
    np.testing.assert_allclose(got, jgot, rtol=O2_RTOL)


CASES = {"sdp2_zero2": dict(sdp=2, stage=2), "sdp2_zero3": dict(sdp=2, stage=3),
         "mp2": dict(mp=2), "pp2": dict(pp=2)}


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """A world-1 checkpoint (1 step on the whole batch), then the 2-rank
    world of ``torch_dist_ranks.mesh_checkpoints`` over ``CASES``, queued
    in the background."""
    root = tmp_path_factory.mktemp("mesh")
    model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=3)
    one = TrainStep(model, AdamW(learning_rate=1e-3, parameters=model.parameters()),
                    GPTPretrainingCriterion())
    one(IDS, IDS)
    CheckpointManager(str(root / "world1")).save(one, 1)
    cases = [dict(c, dir=str(root / name), async_dir=str(root / f"{name}_async"))
             for name, c in CASES.items()]
    world = started(ranks.mesh_checkpoints, 2, cases, IDS, str(root / "world1"), 1)
    return dict(root=root, world1=gather_to_host(one), outs=world)


def _case(mesh_world, name):
    i = list(CASES).index(name)
    return [o[i] for o in mesh_world["outs"].result()]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_checkpoint_restores_at_world1_as_its_pieces_joined(mesh_world, name):
    """A checkpoint written over the mesh (whole, by rank 0) restores into
    a world-1 step bitwise equal to the ranks' pieces joined by
    ``utils/convert.py:gather_state`` (an independent join: the stacked
    trunk's stages, the mp shards' column blocks, the ZeRO blocks)."""
    from paddle_tpu_torch.utils.convert import gather_state

    outs = _case(mesh_world, name)
    stage = CASES[name].get("stage", 0)
    model = GPTForPretraining(GPTConfig.tiny(), device="cpu", seed=11)
    one = TrainStep(model, AdamW(learning_rate=1e-3, parameters=model.parameters()),
                    GPTPretrainingCriterion())
    restored = CheckpointManager(str(mesh_world["root"] / name)).restore_latest(target=one)
    assert restored is not None and restored[0] is one and restored[1] == 1
    st = one.state
    assert st["step"] == 1
    dims = outs[0]["sdp_dims"]
    if stage:
        assert any(d is not None for d in dims.values())  # some parameters split over sdp
    params = gather_state({o["coord"]: o["written"]["params"] for o in outs},
                          sdp_dims=dims if stage == 3 else None)
    assert set(params) == set(st["params"])
    for n, t in st["params"].items():
        np.testing.assert_array_equal(t.numpy(), params[n], err_msg=n)
    for k, tree in st["opt"].items():
        joined = gather_state({o["coord"]: o["written"]["opt"][k] for o in outs},
                              sdp_dims=dims if stage else None)
        for n, t in tree.items():
            np.testing.assert_array_equal(t.numpy(), joined[n], err_msg=f"{k} {n}")
    assert np.isfinite(float(one(IDS, IDS)["loss"]))  # and it trains on


@pytest.mark.parametrize("name", list(CASES))
def test_world1_checkpoint_restores_on_the_mesh_as_each_ranks_pieces(mesh_world, name):
    """A world-1 checkpoint restores into each rank's pieces, bitwise those
    ``utils/convert.py:shard_state`` cuts from the whole state."""
    from paddle_tpu_torch.utils.convert import shard_state

    c, outs = CASES[name], _case(mesh_world, name)
    stage = c.get("stage", 0)
    whole = mesh_world["world1"]
    dims = outs[0]["sdp_dims"]
    cfg = GPTConfig.tiny()
    for o in outs:
        pp_rank, sdp_rank, mp_rank = o["coord"]
        kw = dict(pp_rank=pp_rank, pp_degree=c.get("pp", 1), sdp_rank=sdp_rank,
                  sdp_degree=c.get("sdp", 1))
        got = o["restored"]
        assert got["step"] == 1
        want = shard_state({n: t.numpy() for n, t in whole["params"].items()}, mp_rank,
                           c.get("mp", 1), cfg, sdp_dims=dims if stage == 3 else None, **kw)
        assert set(want) == set(got["params"])
        for n, v in want.items():
            np.testing.assert_array_equal(got["params"][n], v, err_msg=n)
        for k, tree in whole["opt"].items():
            want = shard_state({n: t.numpy() for n, t in tree.items()}, mp_rank, c.get("mp", 1),
                               cfg, sdp_dims=dims if stage else None, **kw)
            for n, v in want.items():
                np.testing.assert_array_equal(got["opt"][k][n], v, err_msg=f"{k} {n}")


@pytest.mark.parametrize("name", list(CASES))
def test_async_mesh_save_pairs_its_barrier_and_writes_the_whole_state(mesh_world, name):
    """``save_train_step(async_save=True)`` over the mesh: rank 0 alone
    gets a handle, every rank meets the same barrier, so the step right
    after it (its collectives) runs on both ranks, and once the handle's
    ``wait()`` has returned the file is bitwise what the manager's
    synchronous save of the same state wrote."""
    outs = _case(mesh_world, name)
    assert [o["async_handle"] for o in outs] == [True, False]
    assert all(np.isfinite(o["after_async_loss"]) for o in outs)
    root = mesh_world["root"]
    sync = dict(ckpt.flatten(ckpt.load_state(
        os.path.join(CheckpointManager(str(root / name))._step_dir(1), "state"))))
    written = dict(ckpt.flatten(ckpt.load_state(str(root / f"{name}_async"))))
    assert set(written) == set(sync)
    for k, v in sync.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(written[k], v), k
        else:
            assert written[k] == v, k


def test_conversion_error_names_the_first_mismatched_leaf(tmp_path):
    small = _port_step(None)
    small(BATCHES[0], BATCHES[0])
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(small, 1)
    model = GPTForPretraining(GPTConfig.tiny(hidden_size=128), device="cpu")
    wider = TrainStep(model, AdamW(learning_rate=_schedule(tlr), parameters=model.parameters()),
                      GPTPretrainingCriterion(), amp_level="O2")
    with pytest.raises(CheckpointConversionError) as ei:
        mgr.restore_latest(target=wider)  # a caller bug: propagates, no fallback
    have, want = dict(ckpt.flatten(small.state)), dict(ckpt.flatten(wider.state))
    first = next(k for k in sorted(want)
                 if getattr(have[k], "shape", None) != getattr(want[k], "shape", None))
    assert ei.value.leaf == first and first in str(ei.value)
    assert "did the model config change" in str(ei.value)
    # a tree target: missing and extra leaves, then a dtype change
    state = {"w": np.zeros((2,), np.float32), "b": np.zeros((1,), np.float32)}
    with pytest.raises(CheckpointConversionError) as ei:
        convert(state, target={"w": np.zeros((2,), np.float32), "c": np.zeros((1,), np.float32)})
    assert ei.value.leaf == "['c']"
    with pytest.raises(CheckpointConversionError) as ei:
        convert(state, target={"w": np.zeros((2,), np.float64), "b": np.zeros((1,), np.float32)})
    assert ei.value.leaf == "['w']" and "float64" in str(ei.value)
    # placement onto a target tree: numpy stays numpy, tensors go to their device
    out = convert({"w": torch.ones(2), "s": 3},
                  target={"w": torch.zeros(2), "s": 0})
    assert torch.equal(out["w"], torch.ones(2)) and out["s"] == 3
    assert tree_shardings({"w": torch.zeros(1), "n": np.zeros(1)}) == {
        "['w']": torch.device("cpu"), "['n']": None}


def test_async_save_and_checksums_name_leaves(tmp_path):
    state = {"params": {"w": torch.arange(4.0)}, "step": 3, "bf": torch.ones(2, dtype=torch.bfloat16)}
    handle = ckpt.save_state(state, str(tmp_path / "a"), async_save=True)
    handle.wait()
    back = ckpt.load_state(str(tmp_path / "a"))
    assert torch.equal(back["params"]["w"], state["params"]["w"]) and back["step"] == 3
    assert ckpt.checksum_pytree(back) == ckpt.checksum_pytree(state)
    sums = ckpt.checksum_pytree(state)
    assert set(sums) == {"['params']['w']", "['step']", "['bf']"}
    assert sums["['bf']"]["dtype"] == "bfloat16" and sums["['step']"]["shape"] == []
    assert os.path.exists(tmp_path / "a" / ckpt.DATA_FILE)

"""The port's input pipeline (``paddle_tpu_torch.io``: datasets, samplers,
the DataLoader and its process workers) against ``paddle_tpu.io`` on the
same numpy data, on the CPU.

Tolerances: none. Orders, indices and batches are compared exactly: the
port's random samplers are handed a ``numpy.random.RandomState`` seeded as
the reference's global stream, so they draw the same permutations; batches
are the same numbers collated into torch tensors (int64 and float32 where
the reference makes int64 and float32 arrays). The process-worker messages
are those ``tests/test_dataloader_mp.py`` pins for the reference (its
wall-clock race is not repeated). ``TestDataLoaderPoisonSamples`` is
``tests/test_stability.py``'s, run on the port.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.io as rio

from paddle_tpu_torch import io as pio
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.framework.flags import get_flags, set_flags
from paddle_tpu_torch.observability import metrics as obs_metrics

SEEDS = [0, 7]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _batches(loader):
    return [[_np(x) for x in b] if isinstance(b, (list, tuple)) else _np(b) for b in loader]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(_np(a), _np(b))
            assert _np(a).dtype == _np(b).dtype


class _ArrayDS(pio.Dataset):
    def __init__(self, n=64, d=8):
        self.x = np.arange(n * d, dtype=np.float32).reshape(n, d)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], np.int64(i)


class _RefArrayDS(rio.Dataset):
    def __init__(self, n=64, d=8):
        self.x = np.arange(n * d, dtype=np.float32).reshape(n, d)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], np.int64(i)


class _CrashDS(pio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            import os

            os._exit(3)  # a worker killed as by a segfault or the OOM killer
        return np.float32(i)


class _RaiseDS(pio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise KeyError("bad sample 5")
        return np.float32(i)


class _InfoDS(pio.Dataset):
    def __len__(self):
        return 6

    def __getitem__(self, i):
        info = pio.get_worker_info()
        return np.int64(-1 if info is None else info.id), np.int64(-1 if info is None else info.seed)


# ------------------------------------------------------------- samplers


@pytest.mark.parametrize("seed", SEEDS)
def test_random_samplers_draw_the_reference_order(seed):
    data = list(range(23))
    np.random.seed(seed)
    want = [list(rio.RandomSampler(data)), list(rio.RandomSampler(data)),
            list(rio.RandomSampler(data, replacement=True, num_samples=40)),
            list(rio.WeightedRandomSampler(np.arange(1, 24), 30)),
            [list(s) for s in rio.random_split(data, [10, 13])],
            list(rio.BatchSampler(data, shuffle=True, batch_size=4))]
    g = np.random.RandomState(seed)
    got = [list(pio.RandomSampler(data, generator=g)), list(pio.RandomSampler(data, generator=g)),
           list(pio.RandomSampler(data, replacement=True, num_samples=40, generator=g)),
           list(pio.WeightedRandomSampler(np.arange(1, 24), 30, generator=g)),
           [list(s) for s in pio.random_split(data, [10, 13], generator=g)],
           list(pio.BatchSampler(data, shuffle=True, batch_size=4, generator=g))]
    assert got == want


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
def test_distributed_batch_sampler_is_the_reference(shuffle, drop_last):
    data = list(range(21))
    for rank in range(3):
        r = rio.DistributedBatchSampler(data, 4, num_replicas=3, rank=rank, shuffle=shuffle,
                                        drop_last=drop_last)
        p = pio.DistributedBatchSampler(data, 4, num_replicas=3, rank=rank, shuffle=shuffle,
                                        drop_last=drop_last)
        for epoch in (0, 3):
            r.set_epoch(epoch)
            p.set_epoch(epoch)
            assert list(p) == list(r) and len(p) == len(r)


def test_sequence_sampler_and_the_default_generator():
    """Without a generator a sampler derives its stream from the port's seed:
    the same seed gives the same order."""
    import paddle_tpu_torch as port

    data = list(range(10))
    assert list(pio.SequenceSampler(data)) == list(rio.SequenceSampler(data))
    port.seed(11)
    a = list(pio.RandomSampler(data))
    port.seed(11)
    assert list(pio.RandomSampler(data)) == a and sorted(a) == data
    with pytest.raises(TypeError, match="RandomState"):
        pio.RandomSampler(data, generator=object())


def test_datasets_are_the_reference():
    xs = [np.arange(12, dtype=np.float32).reshape(6, 2), np.arange(6)]
    ys = [np.arange(6, dtype=np.float32) * 10]
    cases = [(pio.TensorDataset(xs), rio.TensorDataset(xs)),
             (pio.ComposeDataset([pio.TensorDataset(xs), pio.TensorDataset(ys)]),
              rio.ComposeDataset([rio.TensorDataset(xs), rio.TensorDataset(ys)])),
             (pio.ChainDataset([pio.TensorDataset(xs), pio.TensorDataset(ys)]),
              rio.ChainDataset([rio.TensorDataset(xs), rio.TensorDataset(ys)])),
             (pio.ConcatDataset([pio.TensorDataset(ys), pio.TensorDataset(xs)]),
              rio.ConcatDataset([rio.TensorDataset(ys), rio.TensorDataset(xs)])),
             (pio.Subset(pio.TensorDataset(xs), [4, 1, 3]),
              rio.Subset(rio.TensorDataset(xs), [4, 1, 3]))]
    for p, r in cases:
        assert len(p) == len(r)
        for i in range(len(r)):
            for a, b in zip(p[i], r[i]):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="indexing"):
        pio.IterableDataset()[0]


# ------------------------------------------------------------- collate


def test_default_collate_dtypes_and_structure():
    samples = [(np.full((2,), i, np.float64), i, float(i), np.int32(i), {"k": np.uint8(i)},
                torch.full((3,), float(i)))
               for i in range(4)]
    got = pio.default_collate_fn(samples)
    want = rio.default_collate_fn([s[:5] for s in samples])
    for g, w in zip(got[:4], want[:4]):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)
        assert g.numpy().dtype == w.dtype
    assert got[1].dtype == torch.int64 and got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[4]["k"].numpy(), want[4]["k"])
    assert got[5].shape == (4, 3) and got[5].dtype == torch.float32


# ------------------------------------------------------------- loaders


@pytest.mark.parametrize("mode,workers", [("serial", 0), ("thread", 3), ("process", 3)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_modes_equal_the_reference_serial_loader(mode, workers, shuffle):
    np.random.seed(3)
    want = _batches(rio.DataLoader(_RefArrayDS(), batch_size=8, shuffle=shuffle, drop_last=True))
    got = _batches(pio.DataLoader(_ArrayDS(), batch_size=8, shuffle=shuffle, drop_last=True,
                                  num_workers=workers,
                                  worker_mode="thread" if mode == "serial" else mode,
                                  generator=np.random.RandomState(3), device="cpu"))
    _assert_batches_equal(got, want)


def test_iterable_dataset_batches_and_rejects_process_mode():
    class It(pio.IterableDataset):
        def __iter__(self):
            yield from (np.float32(i) for i in range(7))

    got = [b.tolist() for b in pio.DataLoader(It(), batch_size=3, device="cpu")]
    assert got == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0], [6.0]]
    with pytest.raises(ValueError, match="map-style"):
        pio.DataLoader(It(), batch_size=2, num_workers=2, worker_mode="process", device="cpu")


def test_loader_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pio.DataLoader(_ArrayDS(), batch_size=4)


def test_fuse_steps_stacks_feed_run_steps():
    """``fuse_steps=2`` stacks equal the reference's ``stack_batches`` and
    drive ``TrainStep.run_steps(stack, k=2)`` to the same losses as the
    batches one by one."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.layer import Linear
    from paddle_tpu_torch.optimizer import SGD

    want = list(rio.stack_batches(iter(rio.DataLoader(_RefArrayDS(n=40), batch_size=8)), 2,
                                  to_device=False))
    stacks = list(pio.DataLoader(_ArrayDS(n=40), batch_size=8, fuse_steps=2, device="cpu"))
    assert [tuple(s[0].shape) for s in stacks] == [(2, 8, 8), (2, 8, 8), (1, 8, 8)]
    _assert_batches_equal(stacks, want)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = Linear(8, 1, device="cpu")
            with torch.no_grad():
                self.lin.weight.fill_(0.01)

        def forward(self, x):
            return self.lin(x / 512)

    def run(fused):
        net = Net()
        step = TrainStep(net, SGD(learning_rate=1e-2, parameters=net.parameters()),
                         lambda out, y: ((out[:, 0] - y.float() / 40) ** 2).mean())
        if fused:
            return torch.cat([step.run_steps(((x,), (y,)), k=x.shape[0])["loss"]
                              for x, y in stacks])
        return torch.stack([step((x,), (y,))["loss"]
                            for x, y in pio.DataLoader(_ArrayDS(n=40), batch_size=8,
                                                       device="cpu")])

    torch.testing.assert_close(run(True), run(False), rtol=0, atol=0)


# ------------------------------------------------------------- process workers


def test_worker_init_fn_and_get_worker_info():
    assert pio.get_worker_info() is None  # the main process
    seen = []

    def init(wid):
        seen.append(wid)  # runs in the worker: the parent's list stays empty

    def epoch(seed):
        return np.concatenate([np.stack([a.numpy(), b.numpy()], 1) for a, b in pio.DataLoader(
            _InfoDS(), batch_size=1, num_workers=2, worker_mode="process", worker_init_fn=init,
            generator=np.random.RandomState(seed), device="cpu")])

    rows = epoch(5)
    ids, seeds = rows[:, 0], rows[:, 1]
    assert ids.tolist() == [0, 1, 0, 1, 0, 1]  # batch i on worker i % 2
    assert len(set((seeds - ids).tolist())) == 1  # seed = base_seed + id
    np.testing.assert_array_equal(epoch(5), rows)  # the base seed comes from the generator
    assert not np.array_equal(epoch(6)[:, 1], seeds)
    assert seen == []
    # thread workers share the main process: no worker view
    thread = [a.item() for a, _ in pio.DataLoader(_InfoDS(), batch_size=1, num_workers=2,
                                                  device="cpu")]
    assert thread == [-1] * 6


def test_worker_crash_raises_clear_error():
    loader = pio.DataLoader(_CrashDS(), batch_size=2, num_workers=2, worker_mode="process",
                            device="cpu")
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        _ = [b for b in loader]


def test_worker_exception_propagates_with_traceback():
    loader = pio.DataLoader(_RaiseDS(), batch_size=2, num_workers=2, worker_mode="process",
                            device="cpu")
    with pytest.raises(RuntimeError, match="bad sample 5"):
        _ = [b for b in loader]


def test_worker_init_fn_failure_reports_real_error():
    def bad_init(wid):
        raise ValueError("init exploded")

    loader = pio.DataLoader(_ArrayDS(n=8), batch_size=2, num_workers=2, worker_mode="process",
                            worker_init_fn=bad_init, device="cpu")
    with pytest.raises(RuntimeError, match="init exploded"):
        _ = [b for b in loader]


def test_persistent_workers_reuse_and_recover():
    loader = pio.DataLoader(_ArrayDS(n=32), batch_size=4, num_workers=2, worker_mode="process",
                            persistent_workers=True, use_shared_memory=False, device="cpu")
    try:
        first = _batches(loader)
        pool = loader._pool
        for i, _ in enumerate(loader):  # an abandoned epoch leaks nothing into the next
            if i == 1:
                break
        _assert_batches_equal(_batches(loader), first)
        assert loader._pool is pool
        it1 = iter(loader)
        next(it1)
        it2 = iter(loader)
        with pytest.raises(RuntimeError, match="already serving"):
            next(it2)
        assert len(list(it1)) == 7  # the first iterator still completes its epoch
    finally:
        loader.shutdown()
    bad = pio.DataLoader(_RaiseDS(), batch_size=2, num_workers=2, worker_mode="process",
                         persistent_workers=True, device="cpu")
    with pytest.raises(RuntimeError, match="bad sample 5"):
        _ = [b for b in bad]
    assert bad._pool is None  # the dead pool is dropped and respawned next epoch
    bad.dataset = _ArrayDS(n=8)
    bad.batch_sampler = pio.BatchSampler(bad.dataset, batch_size=2)
    assert len(_batches(bad)) == 4
    bad.shutdown()


def test_loader_spans_and_counters():
    obs_metrics.reset_counters("dataloader.")
    n = len(list(pio.DataLoader(_ArrayDS(n=16), batch_size=4, num_workers=2, device="cpu")))
    assert obs_metrics.counters("dataloader.")["dataloader.batches"] == n == 4
    assert {"dataloader.fetch", "dataloader.prefetch"} <= set(obs_metrics.histograms("dataloader."))
    assert set(obs_metrics.DATALOADER_COUNTERS) >= {"dataloader.batches", "dataloader.bad_batches"}


# ------------------------------------------------------------- poison samples


class TestDataLoaderPoisonSamples:
    class _PoisonDataset:
        def __init__(self, n=16, bad={3}):
            self.n, self.bad = n, set(bad)

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            if i in self.bad:
                raise ValueError(f"poison sample {i}")
            return np.float32([i]), np.int64(i % 2)

    def test_skips_bad_batches_bounded(self):
        prev = get_flags(["FLAGS_dataloader_max_bad_batches"])
        set_flags({"FLAGS_dataloader_max_bad_batches": 2})
        obs_metrics.reset_counters("dataloader.bad_batches")
        try:
            dl = pio.DataLoader(self._PoisonDataset(), batch_size=2, shuffle=False, device="cpu")
            batches = list(dl)
            assert len(batches) == 7  # 8 batches, 1 poisoned and skipped
            assert obs_metrics.counters("dataloader.bad_batches")["dataloader.bad_batches"] == 1
            evs = obs.monitor().events("bad_batch")
            assert evs and "poison sample 3" in evs[-1]["error"]
            assert len(list(dl)) == 7  # the budget is per iteration: a second epoch works too
        finally:
            set_flags(prev)

    def test_budget_exceeded_raises(self):
        prev = get_flags(["FLAGS_dataloader_max_bad_batches"])
        set_flags({"FLAGS_dataloader_max_bad_batches": 1})
        try:
            dl = pio.DataLoader(self._PoisonDataset(bad={1, 5}), batch_size=2, shuffle=False,
                                device="cpu")
            with pytest.raises(RuntimeError, match="exceeds"):
                list(dl)
        finally:
            set_flags(prev)

    def test_off_by_default_raises_original(self):
        dl = pio.DataLoader(self._PoisonDataset(), batch_size=2, shuffle=False, device="cpu")
        with pytest.raises(ValueError, match="poison sample"):
            list(dl)

    def test_threaded_workers_skip_too(self):
        prev = get_flags(["FLAGS_dataloader_max_bad_batches"])
        set_flags({"FLAGS_dataloader_max_bad_batches": 4})
        try:
            dl = pio.DataLoader(self._PoisonDataset(bad={0, 7}), batch_size=2, shuffle=False,
                                num_workers=2, device="cpu")
            assert len(list(dl)) == 6
        finally:
            set_flags(prev)

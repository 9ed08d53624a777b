"""The port's native record feed (``paddle_tpu_torch.io.RecordFileLoader``
over its own copy of the C++ readers, built here with g++) against
``paddle_tpu.io.RecordFileLoader`` on the same record files.

Tolerances: none. With one reader thread both packages give the same
batches bitwise and in the same order, shuffle off and on at the same seed
(each epoch reseeds the block shuffle with ``seed`` plus the epoch), and
the written columns come back bitwise in file order with the shuffle off.
With three threads the threads' interleaving orders the batches, so an
epoch is compared as a set of records.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.io as rio

from paddle_tpu_torch import io as pio
from paddle_tpu_torch.framework import native

FIELDS = [("dense", "float32", (5,)), ("ids", "int32", (3,)), ("label", "float32", ()),
          ("flag", "uint8", (2,))]
N_FILES, PER_FILE, BATCH = 4, 37, 16


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("records")
    rng = np.random.default_rng(0)
    cols = {"dense": rng.normal(size=(N_FILES * PER_FILE, 5)).astype(np.float32),
            "ids": rng.integers(0, 1000, (N_FILES * PER_FILE, 3)).astype(np.int32),
            "label": rng.integers(0, 2, N_FILES * PER_FILE).astype(np.float32),
            "flag": rng.integers(0, 255, (N_FILES * PER_FILE, 2)).astype(np.uint8)}
    paths = []
    for f in range(N_FILES):
        part = {k: v[f * PER_FILE:(f + 1) * PER_FILE] for k, v in cols.items()}
        path = str(root / f"part-{f}.rec")
        assert pio.RecordSchema(FIELDS).write_records(path, part) == PER_FILE
        # the reference writes the same bytes
        ref_path = str(root / f"ref-{f}.rec")
        rio.RecordSchema(FIELDS).write_records(ref_path, part)
        assert open(path, "rb").read() == open(ref_path, "rb").read()
        paths.append(path)
    return paths, cols


def _port(paths, **kw):
    return pio.RecordFileLoader(paths, pio.RecordSchema(FIELDS), BATCH, device="cpu", **kw)


def _ref(paths, **kw):
    return rio.RecordFileLoader(paths, rio.RecordSchema(FIELDS), BATCH, **kw)


def _assert_epochs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k])
            assert g[k].numpy().dtype == w[k].dtype


def test_one_thread_gives_the_written_columns_in_order(files):
    paths, cols = files
    batches = list(_port(paths, num_workers=1))
    assert [len(b["label"]) for b in batches] == [16] * 9 + [4]
    for k, v in cols.items():
        np.testing.assert_array_equal(np.concatenate([b[k].numpy() for b in batches]), v)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
def test_one_thread_is_the_reference_bitwise(files, shuffle, drop_last):
    paths, _ = files
    port = _port(paths, num_workers=1, shuffle=shuffle, seed=5, drop_last=drop_last)
    ref = _ref(paths, num_workers=1, shuffle=shuffle, seed=5, drop_last=drop_last)
    for _ in range(2):  # two epochs: the shuffle's seed moves with the epoch
        _assert_epochs_equal(list(port), list(ref))


def test_three_threads_hold_each_epochs_records(files):
    paths, cols = files
    loader = _port(paths, num_workers=3, shuffle=True, seed=1)
    want = sorted(map(tuple, cols["ids"].tolist()))
    for _ in range(2):
        batches = list(loader)
        assert sum(len(b["ids"]) for b in batches) == N_FILES * PER_FILE
        assert sorted(map(tuple, np.concatenate([b["ids"].numpy() for b in batches]).tolist())) \
            == want


def test_one_iterator_at_a_time_and_the_build(files):
    paths, _ = files
    loader = _port(paths, num_workers=1)
    it = iter(loader)
    next(it)
    with pytest.raises(RuntimeError, match="one active iterator"):
        next(iter(loader))
    it.close()
    assert len(list(loader)) == 10
    lib = native.library_path()
    assert lib.exists() and lib.parent.name == "paddle_tpu_torch"
    assert sorted(p.name for p in native.HOST_SRC.iterdir()) == ["buffer.cc", "channel.h",
                                                                 "data_feed.cc"]
    with pytest.raises(ValueError, match="at least one file"):
        _port([])

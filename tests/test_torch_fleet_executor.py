"""The port's FleetExecutor against ``paddle_tpu``'s: the reference's
``tests/test_fleet_executor.py`` cases run through both packages, their
outputs equal, and the port's own channel held to the reference's native
channel's blocking and close semantics."""
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed import fleet_executor as jfe  # noqa: E402
from paddle_tpu.framework.native import Channel as JChannel  # noqa: E402

from paddle_tpu_torch.distributed import fleet_executor as tfe  # noqa: E402

BOTH = pytest.mark.parametrize("fe", [jfe, tfe], ids=["paddle_tpu", "port"])


def _chain(fe):
    return [fe.TaskNode(role="source"), fe.TaskNode(lambda x: x * 2, name="double"),
            fe.TaskNode(lambda x: x + 1, name="inc"), fe.TaskNode(role="sink")]


def test_linear_chain_ordering_and_results():
    want = jfe.FleetExecutor().init(_chain(jfe)).run(range(20))
    assert tfe.FleetExecutor().init(_chain(tfe)).run(range(20)) == want == [
        i * 2 + 1 for i in range(20)]


@BOTH
def test_backpressure_no_deadlock_beyond_capacity(fe):
    # feeds far beyond channel capacity x stages: the bounded channels must
    # back-pressure the source without deadlocking the collector
    outs = fe.FleetExecutor().init([fe.TaskNode(lambda x: x + 1)], capacity=2).run(range(200))
    assert outs == list(range(1, 201))


def test_amplifier_expands_messages():
    def nodes(fe):
        return [fe.TaskNode(lambda x: [x, x * 10], role="amplifier", name="amp"),
                fe.TaskNode(lambda x: x + 1)]

    want = jfe.FleetExecutor().init(nodes(jfe)).run([1, 2])
    assert tfe.FleetExecutor().init(nodes(tfe)).run([1, 2]) == want == [2, 11, 3, 21]


@BOTH
def test_stage_overlap_wall_clock(fe):
    d, n = 0.03, 6

    def slow(x):
        time.sleep(d)
        return x

    t0 = time.perf_counter()
    fe.FleetExecutor().init([fe.TaskNode(slow), fe.TaskNode(slow), fe.TaskNode(slow)]).run(range(n))
    pipelined = time.perf_counter() - t0
    # 3 stages overlapping: about (n + stages - 1) * d, well under serial
    assert pipelined < n * 3 * d * 0.75, (pipelined, n * 3 * d)


def test_model_stage():
    """A model stage: the reference's ``Linear`` under ``to_static`` and the
    port's ``Linear`` with its weights, each predicting the same batches."""
    from paddle_tpu_torch.nn.layer import Linear

    jm = paddle.nn.Linear(4, 4)
    jm.eval()
    jstatic = paddle.jit.to_static(jm)
    tm = Linear(4, 4, device="cpu")
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.array(jm.weight.numpy())))
        tm.bias.copy_(torch.from_numpy(np.array(jm.bias.numpy())))

    def jstage(x):
        return np.asarray(jstatic(paddle.to_tensor(x)).numpy())

    def tstage(x):
        with torch.no_grad():
            return tm(torch.from_numpy(x)).numpy()

    batches = [np.random.default_rng(i).standard_normal((2, 4)).astype("float32")
               for i in range(4)]
    want = jfe.FleetExecutor().init([jfe.TaskNode(jstage, name="predict")]).run(batches)
    got = tfe.FleetExecutor().init([tfe.TaskNode(tstage, name="predict")]).run(batches)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@BOTH
def test_error_propagates_with_stage_name(fe):
    def boom(x):
        raise ValueError("bad batch")

    ex = fe.FleetExecutor().init([fe.TaskNode(lambda x: x), fe.TaskNode(boom, name="boom")])
    with pytest.raises(RuntimeError, match="boom"):
        ex.run(range(3))


@BOTH
def test_carrier_direct_api(fe):
    assert fe.Carrier([fe.TaskNode(lambda x: -x)]).run([1, 2, 3]) == [-1, -2, -3]


@BOTH
def test_init_checks_the_chain_and_run_needs_init(fe):
    a, b, c = fe.TaskNode(name="a"), fe.TaskNode(name="b"), fe.TaskNode(name="c")
    a.add_downstream_task(c)
    with pytest.raises(ValueError, match="downstream"):
        fe.FleetExecutor().init([a, b, c])
    with pytest.raises(RuntimeError, match="init"):
        fe.FleetExecutor().run([1])


@pytest.mark.parametrize("make", [JChannel, tfe.Channel], ids=["native", "port"])
def test_channel_blocks_when_full_and_drains_after_close(make):
    ch = make(2)
    assert ch.put(b"a") and ch.put(b"b") and len(ch) == 2
    done = threading.Event()

    def third():
        ch.put(b"c")
        done.set()

    t = threading.Thread(target=third, daemon=True)
    t.start()
    assert not done.wait(0.2)  # full: the producer waits
    assert ch.get() == b"a"
    assert done.wait(5.0)
    ch.close()
    assert ch.put(b"d") is False
    assert [ch.get(), ch.get(), ch.get()] == [b"b", b"c", None]
    t.join()

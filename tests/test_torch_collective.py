"""The port's collectives over ``torch.distributed`` against ``paddle_tpu``'s.

The reference's collectives are ``jax.lax`` ones traced inside
``shard_map`` over a mesh axis of n CPU devices; the port's are eager
calls in n gloo processes (:func:`paddle_tpu_torch.testing.dist.run_ranks`,
one world for each n). Both get the same numpy inputs, device or rank i
taking row i. Tolerance: f32 sums of n terms in another order, atol 1e-6
and rtol 1e-6; everything else (max, min, gathers, permutations) bitwise.
Also here: the ``collective.<name>.calls`` counters, the fleet's groups by
object and by axis name, and the topology's accessors and errors.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import paddle_tpu.distributed.collective as jc  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from paddle_tpu_torch.testing.dist import run_ranks  # noqa: E402

SUM_TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs(n):
    rng = np.random.default_rng(n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"a": f(n, 6), "m": f(n, 2, 3), "rs": f(n, 2 * n, 2 * n), "l": f(n, n, 3)}


def _shard_map(fn, n, *xs):
    """``fn`` of each device's row of ``xs`` inside ``shard_map`` over a
    ``dp`` axis of n devices; the rows of the result, one per device."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    body = lambda *vs: fn(*(v[0] for v in vs))[None]  # noqa: E731
    mapped = jax.shard_map(body, mesh=mesh, in_specs=(P("dp"),) * len(xs), out_specs=P("dp"),
                           check_vma=False)
    return np.asarray(mapped(*xs))


def _reference(inputs, n):
    a, m, rs, lst = (inputs[k] for k in ("a", "m", "rs", "l"))
    ring = [(i, (i + 1) % n) for i in range(n)]
    return {
        "all_reduce_sum": _shard_map(lambda x: jc.all_reduce(x, op=jc.ReduceOp.SUM), n, a),
        "all_reduce_max": _shard_map(lambda x: jc.all_reduce(x, op=jc.ReduceOp.MAX), n, a),
        "all_reduce_min": _shard_map(lambda x: jc.all_reduce(x, op=jc.ReduceOp.MIN), n, a),
        "all_reduce_avg": _shard_map(lambda x: jc.all_reduce(x, op=jc.ReduceOp.AVG), n, a),
        "reduce": _shard_map(lambda x: jc.reduce(x, dst=1), n, a),
        "all_gather": _shard_map(lambda x: jc.all_gather(x), n, a),
        "all_gather_concat_0": _shard_map(lambda x: jc.all_gather_concat(x, concat_axis=0), n, m),
        "all_gather_concat_1": _shard_map(lambda x: jc.all_gather_concat(x, concat_axis=1), n, m),
        "reduce_scatter_0": _shard_map(lambda x: jc.reduce_scatter(None, x, scatter_axis=0), n, rs),
        "reduce_scatter_1": _shard_map(lambda x: jc.reduce_scatter(None, x, scatter_axis=1), n, rs),
        "alltoall_list": _shard_map(lambda x: jc.alltoall(list(x)), n, lst),
        "alltoall_tiled": _shard_map(lambda x: jc.alltoall(x, split_axis=1, concat_axis=0), n, rs),
        "broadcast": _shard_map(lambda x: jc.broadcast(x, src=1), n, a),
        "scatter": _shard_map(lambda x: jc.scatter(None, list(x), src=n - 1), n, lst),
        "ppermute": _shard_map(lambda x: jc.ppermute(x, ring), n, a),
        "ppermute_partial": _shard_map(lambda x: jc.ppermute(x, [(0, n - 1)]), n, a),
    }


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_paddle_tpu_shard_map(n):
    """Every collective at world n against the reference's inside
    ``shard_map`` over n devices, with the counters of one call each."""
    inputs = _inputs(n)
    got = run_ranks(ranks.collectives, n, inputs)
    want = _reference(inputs, n)
    want["all_gather_list"] = want["all_gather"]
    for r in range(n):
        for name, ref in want.items():
            tol = SUM_TOL if name in ("all_reduce_sum", "all_reduce_avg", "reduce",
                                      "reduce_scatter_0", "reduce_scatter_1") else dict(atol=0, rtol=0)
            np.testing.assert_allclose(got[r][name], ref[r], err_msg=f"{name} rank {r}", **tol)
        ring = want["ppermute"][r]  # send/recv and p2p around the ring give ppermute's
        np.testing.assert_array_equal(got[r]["send_recv"], ring)
        np.testing.assert_array_equal(got[r]["p2p"], ring)
        counts = got[r]["counters"]
        assert counts["collective.all_reduce.calls"] == 5  # four ops and reduce
        for name in ("all_gather", "reduce_scatter", "alltoall", "ppermute", "all_gather_concat"):
            assert counts[f"collective.{name}.calls"] == 2, name
        for name in ("broadcast", "scatter", "barrier"):
            assert counts[f"collective.{name}.calls"] == 1, name


def test_fleet_groups_axis_names_and_topology(tmp_path):
    """dp 2 x mp 2 over 4 ranks: the reference's grid order (rank r at
    ``unravel_index(r, (dp, pp, sdp, mp, sep))``), the accessors, the
    groups by object and by axis name, the default group (``dp``),
    ``shard_batch``'s contiguous blocks and ``save_persistables`` written
    by rank 0 alone; and the topology's errors."""
    import torch

    out = run_ranks(ranks.groups_and_axis_names, 4, str(tmp_path))
    assert [p.name for p in tmp_path.iterdir()] == ["model.pdparams"]
    assert set(torch.load(tmp_path / "model.pdparams")) == {"weight", "bias"}
    for r, o in enumerate(out):
        dp_rank, mp_rank = divmod(r, 2)
        assert o["rank"] == r and o["coord"] == (dp_rank, 0, 0, mp_rank, 0)
        assert o["dp"] == (2, dp_rank, [mp_rank, mp_rank + 2])
        assert o["mp"] == (2, mp_rank, [2 * dp_rank, 2 * dp_rank + 1])
        assert o["pp"] == (1, 0, [r]) and o["sdp"] == (1, 0) and o["sep"] == (1, 0)
        assert o["comm_mp"] == [[0, 1], [2, 3]] and o["comm_dp"] == [[0, 2], [1, 3]]
        assert o["sum_mp"] == sum(10.0 ** q for q in o["mp"][2])
        assert o["sum_dp"] == o["sum_default"] == sum(10.0 ** q for q in o["dp"][2])
        assert o["sum_world"] == 1111.0
        np.testing.assert_array_equal(o["blocks"][0], np.arange(16).reshape(8, 2)[4 * dp_rank:4 * dp_rank + 4])
        np.testing.assert_array_equal(o["blocks"][1], np.arange(8)[4 * dp_rank:4 * dp_rank + 4])
        assert o["env"] == (r, 4, r)
    errors = run_ranks(ranks.topology_errors, 2)[0]
    assert errors[0].startswith("ValueError") and "world has 2 ranks" in errors[0]
    # pp 2 and sdp 2 build their groups; the data group is dp x sdp; a
    # pipeline's first and last stage share a group
    assert errors[1] == ([0, 1], [errors[1][1][0]], errors[1][2], [0, 1])
    assert errors[1][2] in ([0], [1])
    assert errors[2][1] == [0, 1] and errors[2][2] == [0, 1] and errors[2][0] == errors[2][3]
    # sep 2 builds its group; a replicated gradient is summed over dp x sdp x sep
    assert errors[3] == ([0, 1], [0, 1], [errors[3][2][0]]) and errors[3][2] in ([0], [1])
    assert errors[4].startswith("RuntimeError") and "fleet.init" in errors[4]
    assert errors[5].startswith("ValueError") and "does not split over dp 2" in errors[5]


def test_host_helpers():
    from paddle_tpu_torch.distributed import utils

    ports = utils.find_free_ports(3)
    assert len(ports) == 3 and all(0 < p < 65536 for p in ports)
    name, ip = utils.get_host_name_ip()
    assert (name is None) == (ip is None)
    logger = utils.get_logger(name="paddle_tpu_torch.test")
    assert logger is utils.get_logger(name="paddle_tpu_torch.test") and len(logger.handlers) == 1


def test_init_parallel_env_needs_cuda_or_cpu():
    """Without CUDA and without ``device="cpu"`` joining a world raises,
    before any process group is made; the backend follows the device."""
    import torch

    from paddle_tpu_torch.distributed import env

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.init_parallel_env()
    assert not env.is_initialized() and env.get_rank() == 0 and env.get_world_size() == 1

"""Port faults found against the reference, each held by a case that fails
without its repair: the sweep's branch cases (``"name[branch]"`` in
``paddle_tpu_torch/testing/tensor_cases.py``: duplicate indices of the
overwrite-mode scatters, ``matrix_rank``'s absolute ``tol``, ``diff``'s
edges wider than one) through both packages, and the sweep's walk of the
keyword arguments, which made those edges tensors."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as port
from paddle_tpu_torch.testing.tensor_cases import CASES
from torch_tensor_api_common import _arrays, _convert, port_on_cpu, run_case  # noqa: F401

BRANCHES = sorted(k for k in CASES if "[" in k)


@pytest.mark.parametrize("key", BRANCHES)
def test_branch_case_matches_paddle_tpu(key):
    """Values, dtypes and gradients (the update that a duplicate index
    overwrites takes none) against the reference."""
    run_case(key)


def test_sweep_walks_keyword_arrays():
    args, kwargs = CASES["diff[wide_edges]"].make(np.random.default_rng(0))
    made = _convert(kwargs, torch.from_numpy)
    assert isinstance(made["prepend"], torch.Tensor) and isinstance(made["append"], torch.Tensor)
    assert len(_arrays(kwargs)) == 2 and made["axis"] == 1
    # an edge that is not a tensor, wider than one along the axis
    x = torch.from_numpy(args[0])
    got = port.diff(x, axis=1, prepend=kwargs["prepend"], append=kwargs["append"].tolist())
    want = np.diff(np.concatenate([kwargs["prepend"], args[0], kwargs["append"]], 1), axis=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("fn", ["scatter", "put_along_axis", "index_put"])
def test_overwrite_at_duplicates_keeps_the_last_write(fn):
    """The last of duplicate writes lands, whatever the order a device
    writes in, and only it takes a gradient; ``scatter_``/``put_along_axis_``
    write the same in place."""
    x = torch.arange(12.0).view(4, 3)
    u = (100 + torch.arange(9.0)).view(3, 3).requires_grad_()
    if fn == "scatter":
        out = port.scatter(x, torch.tensor([1, 3, 1]), u)
        want_rows = {1: 2, 3: 1}
    elif fn == "index_put":
        out = port.index_put(x, (torch.tensor([1, 3, 1]),), u)
        want_rows = {1: 2, 3: 1}
    else:
        idx = torch.tensor([[1, 3, 1]]).T.expand(3, 3).contiguous()
        out = port.put_along_axis(x, idx, u, 0)
        want_rows = {1: 2, 3: 1}
    for row, src in want_rows.items():
        assert torch.equal(out[row], u[src].detach())
    out.sum().backward()
    assert u.grad[0].eq(0).all() and u.grad[1:].eq(1).all()
    y = x.clone()
    if fn == "scatter":
        port.scatter_(y, torch.tensor([1, 3, 1]), u.detach())
    elif fn == "put_along_axis":
        port.put_along_axis_(y, idx, u.detach(), 0)
    else:
        y = out.detach()
    assert torch.equal(y, out.detach())

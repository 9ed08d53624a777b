"""The port's ``paddle_tpu/tensor/linalg.py`` functions against the
reference's, one parametrised case per public function, and ``norm`` in
every form of ``p`` and ``axis`` (the matrix norm over two axes)."""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from torch_tensor_api_common import SKIP_VALUE, port_on_cpu, reference_names, run_case  # noqa: F401


@pytest.mark.parametrize("name", reference_names("linalg"))
def test_linalg_function_matches_paddle_tpu(name):
    assert name not in SKIP_VALUE
    run_case(name)


NORM_FORMS = ([(p, [0, 1]) for p in (1, 2, np.inf, -np.inf, "fro", "nuc")]
              + [(p, 1) for p in (1, 2, np.inf, -np.inf, "fro", 3)]
              + [(p, None) for p in (1, 2, np.inf, "fro")])


@pytest.mark.parametrize("keepdim", [False, True])
@pytest.mark.parametrize("p,axis", NORM_FORMS, ids=[f"{p}-{a}" for p, a in NORM_FORMS])
def test_norm_matches_paddle_tpu_in_every_form(p, axis, keepdim):
    """Two axes: the matrix norm (the port computed a vector norm over both
    axes before, which disagreed for p = 1, 2 and inf and raised for nuc);
    one axis or None: the vector norm."""
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    want = ref.norm(ref.to_tensor(x), p=p, axis=axis, keepdim=keepdim)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port.norm(xt, p=p, axis=axis, keepdim=keepdim)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._value), rtol=1e-5,
                               atol=1e-6)
    xr = ref.to_tensor(x, stop_gradient=False)
    ref.sum(ref.norm(xr, p=p, axis=axis, keepdim=keepdim)).backward()
    (g,) = torch.autograd.grad(got.sum(), xt)
    np.testing.assert_allclose(g.numpy(), np.asarray(xr.grad._value), rtol=1e-5, atol=1e-5)


def test_norm_keeps_the_amp_cast():
    from paddle_tpu_torch.amp import auto_cast

    x = torch.ones(2, 3, dtype=torch.bfloat16)
    with auto_cast(dtype="bfloat16"):
        assert port.norm(x, p=2, axis=[0, 1]).dtype == torch.float32
    assert port.norm(x, p=2, axis=[0, 1]).dtype == torch.bfloat16

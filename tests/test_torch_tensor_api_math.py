"""The port's ``paddle_tpu/tensor/math.py`` functions against the
reference's, one parametrised case per public function (values, dtypes
and gradients; ``tests/torch_tensor_api_common.py``)."""
import pytest

from torch_tensor_api_common import SKIP_VALUE, port_on_cpu, reference_names, run_case  # noqa: F401


@pytest.mark.parametrize("name", reference_names("math"))
def test_math_function_matches_paddle_tpu(name):
    assert name not in SKIP_VALUE
    run_case(name)


CUSTOM_LISTS = [("sin", "white"), ("add", "white"), ("cumprod", "white"), ("multiply", "black"),
                ("maximum", "black"), ("exp", "white")]


@pytest.mark.parametrize("op,which", CUSTOM_LISTS, ids=[f"{o}-{w}" for o, w in CUSTOM_LISTS])
def test_custom_amp_lists_name_any_function_as_the_reference_hook_does(op, which):
    """Every function casts at entry under the reference's op name, so a
    custom white list (run in the scope's dtype) or black list (bf16 up to
    f32) naming it acts on it as the reference's dispatcher hook does."""
    import numpy as np
    import torch

    import paddle_tpu as ref
    import paddle_tpu_torch as port

    rng = np.random.default_rng(0)
    dtype = np.float32 if which == "white" else "bfloat16"
    a = rng.standard_normal((3, 3)).astype(np.float32)
    b = rng.standard_normal((3, 3)).astype(np.float32)
    args = [a] if op in ("sin", "cumprod", "exp") else [a, b]
    kw = {"custom_white_list": [op]} if which == "white" else {"custom_black_list": [op]}
    with ref.amp.auto_cast(dtype="bfloat16", **kw):
        r = getattr(ref, op)(*[ref.cast(ref.to_tensor(x), dtype) for x in args])
    with port.amp.auto_cast(dtype="bfloat16", **kw):
        p = getattr(port, op)(*[port.cast(torch.from_numpy(x), dtype) for x in args])
    want = "bfloat16" if which == "white" else "float32"
    assert str(np.asarray(r._value).dtype) == want and str(p.dtype) == f"torch.{want}"
    np.testing.assert_allclose(p.float().numpy(), np.asarray(r._value).astype(np.float32),
                               rtol=2e-2, atol=2e-2)

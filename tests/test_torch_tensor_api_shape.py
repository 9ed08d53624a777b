"""The port's manipulation, logic and creation functions against the
reference's (``paddle_tpu/tensor/{manipulation,logic,creation}.py``), one
parametrised case per public function; the random functions are held for
shape, dtype, device, determinism under ``paddle.seed``, moments and
torch's global generator instead of by value (``SKIP_VALUE``). Search and
stat: ``tests/test_torch_tensor_api_search.py``."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as port
from paddle_tpu_torch.testing.tensor_cases import CASES, RANDOM
from torch_tensor_api_common import SKIP_VALUE, port_on_cpu, reference_names, run_case  # noqa: F401

NAMES = [n for m in ("manipulation", "logic", "creation") for n in reference_names(m)]


@pytest.mark.parametrize("name", [n for n in NAMES if n not in SKIP_VALUE])
def test_function_matches_paddle_tpu(name):
    run_case(name)


def test_skip_list_is_the_random_functions():
    assert sorted(n for n in NAMES if n in SKIP_VALUE) == sorted(RANDOM)
    assert all(reason for reason in SKIP_VALUE.values())


# (mean, variance) of each draw; randperm is checked as a permutation
MOMENTS = {"rand": (0.5, 1 / 12), "randn": (0.0, 1.0), "standard_normal": (0.0, 1.0),
           "normal": (1.0, 4.0), "uniform": (0.0, 16 / 12), "randint": (4.5, 8.25),
           "randint_like": (4.5, 8.25), "bernoulli": (0.3, 0.21), "poisson": (3.0, 3.0),
           "multinomial": (2.0, 1.0), "uniform_": (0.5, 1 / 12), "exponential_": (0.5, 0.25)}
DTYPES = {"randint": torch.int64, "randperm": torch.int64, "multinomial": torch.int64}


def _draw(name):
    args, kwargs = RANDOM[name](np.random.default_rng(0))
    conv = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a for a in args]
    return getattr(port, name)(*conv, **kwargs)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_function_shape_dtype_seed_moments_and_global_generator(name):
    before = torch.random.get_rng_state()
    port.seed(7)
    a = _draw(name)
    b = _draw(name)
    port.seed(7)
    a2 = _draw(name)
    assert torch.equal(torch.random.get_rng_state(), before)  # torch's own generator untouched
    assert a.device.type == "cpu" and torch.equal(a, a2) and not torch.equal(a, b)
    assert a.dtype == DTYPES.get(name, torch.float32)
    expected_shape = (4096,) if name in ("randperm", "multinomial") else (64, 64)
    assert tuple(a.shape) == expected_shape
    if name == "randperm":
        assert torch.equal(torch.sort(a).values, torch.arange(4096))
        return
    mean, var = MOMENTS[name]
    x = a.double()
    assert abs(float(x.mean()) - mean) < 5 * (var / x.numel()) ** 0.5, (name, float(x.mean()))
    assert abs(float(x.var()) - var) < 0.1 * var + 1e-9, (name, float(x.var()))


def test_uniform_seed_is_its_own_stream():
    port.seed(1)
    a = port.uniform([8], seed=3)
    port.seed(2)
    assert torch.equal(a, port.uniform([8], seed=3))
    assert not torch.equal(port.uniform([8]), port.uniform([8]))


def test_creation_places_on_the_default_device_and_raises_without_one():
    from paddle_tpu_torch import device as D

    assert port.zeros([2]).device.type == "cpu" and port.get_device() == "cpu"
    D._DEVICE[0] = None
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    for make in (lambda: port.zeros([2]), lambda: port.to_tensor([1.0]),
                 lambda: port.arange(3), lambda: port.rand([2]), lambda: port.eye(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    # a function with a tensor input follows its input
    assert port.add(torch.ones(2), 1.0).device.type == "cpu"
    with pytest.raises(ValueError, match="no CUDA device"):
        port.set_device("gpu")


def test_to_tensor_dtypes_and_stop_gradient():
    assert port.to_tensor([1, 2]).dtype == torch.int64
    assert port.to_tensor([1.0, 2.0]).dtype == torch.float32
    assert port.to_tensor(np.zeros(2, np.float64)).dtype == torch.float64  # asked for: kept
    t = port.to_tensor([1.0], stop_gradient=False)
    assert t.requires_grad and not port.to_tensor([1.0]).requires_grad
    assert port.argmax(port.to_tensor([[1.0, 3.0]]), axis=1).dtype == torch.int64
    assert port.Tensor is torch.Tensor and not hasattr(torch.Tensor, "stop_gradient")


def test_inplace_on_a_leaf_that_requires_grad_raises_as_torch_does():
    """The reference rebinds a snapshot so a leaf that requires grad still
    gets its gradient; torch refuses in-place writes to such a leaf, and the
    port raises as torch does (ROADMAP.md, "Semantic edges")."""
    import paddle_tpu as ref

    for name in ("add_", "tanh_", "squeeze_", "scale_"):
        args, kwargs = CASES[name].make(np.random.default_rng(0))
        x = torch.from_numpy(args[0]).requires_grad_(True)
        rest = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args[1:]]
        with pytest.raises(RuntimeError, match="leaf Variable that requires grad"):
            getattr(port, name)(x, *rest, **kwargs)
    xr = ref.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    ref.sum(ref.multiply(ref.tanh_(xr), 2.0)).backward()
    assert xr.grad is not None
    # on a non-leaf the in-place function writes through and differentiates
    x = torch.ones(3, requires_grad=True)
    y = x * 1.0
    port.tanh_(y)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 1 - np.tanh(1.0) ** 2, rtol=1e-6)


def test_scalar_operands_stay_scalars():
    x = torch.ones(3, dtype=torch.bfloat16)
    assert port.add(x, 1.0).dtype == torch.bfloat16 and port.maximum(x, 0.5).dtype == torch.bfloat16
    assert port.subtract(2, torch.arange(3)).dtype == torch.int64
    assert port.divide(torch.arange(3), 2).dtype == torch.float32

"""Shared driver of the tensor API parity sweep
(``tests/test_torch_tensor_api_*.py``): one case of
``paddle_tpu_torch.testing.tensor_cases`` through ``paddle_tpu.<name>``
and ``paddle_tpu_torch.<name>`` on the same numpy inputs, on the CPU.

Values are compared after casting the port's to the reference's dtype (the
reference computes ``int64`` as ``int32`` and ``float64`` as ``float32``
with JAX's x64 off); the port's dtype is asserted apart, as the
reference's dtype with x64 on. Gradients of ``sum(out * w)`` (``w`` from
the next seed) are compared against the reference's tape.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.tensor as ref_tensor
import paddle_tpu_torch as port
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.testing.tensor_cases import CASES, GRAD_TOLERANCE, RANDOM, TOLERANCE

_X64 = {"int64": "int32", "uint64": "uint32", "float64": "float32", "complex128": "complex64"}

# the functions held by their own tests instead of by value: the packages
# draw from different generators (JAX's threefry, torch's Philox and
# mt19937), so only the distribution can agree
SKIP_VALUE = {name: "random: its own generator; held for shape, dtype, device, determinism "
                    "under paddle.seed, moments within 5 sigma and torch's global generator"
              for name in RANDOM}


def reference_names(module):
    """The reference's public functions of ``paddle_tpu.tensor.<module>``."""
    return sorted(n for n, fn in ref_tensor._public_funcs().items()
                  if fn.__module__ == f"paddle_tpu.tensor.{module}")


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = port_device._DEVICE[0]
    port.set_device("cpu")
    yield
    port_device._DEVICE[0] = prev


def _convert(obj, make):
    if isinstance(obj, np.ndarray):
        return make(obj)
    if isinstance(obj, list):
        return [_convert(o, make) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_convert(o, make) for o in obj)
    if isinstance(obj, dict):  # the keyword arguments
        return {k: _convert(v, make) for k, v in obj.items()}
    return obj


def _has_tensor(obj):
    if isinstance(obj, (list, tuple)):
        return any(_has_tensor(o) for o in obj)
    return isinstance(obj, (ref.Tensor, torch.Tensor))


def _leaves(obj):
    """The outputs one by one; a list of Python values (``tolist``) is one."""
    if isinstance(obj, (list, tuple)) and _has_tensor(obj):
        return [x for o in obj for x in _leaves(o)]
    return [obj]


def _arrays(obj):
    if isinstance(obj, dict):
        return [x for o in obj.values() for x in _arrays(o)]
    if isinstance(obj, (list, tuple)):
        return [x for o in obj for x in _arrays(o)]
    return [obj] if isinstance(obj, np.ndarray) else []


def _ref_numpy(o):
    if isinstance(o, ref.Tensor):
        return np.asarray(o._value)
    return np.asarray(o)


def _port_numpy(o):
    if isinstance(o, torch.Tensor):
        return o.detach().resolve_conj().cpu().numpy()
    return np.asarray(o)


def _compare(name, got, want, family, what):
    rtol, atol = TOLERANCE[family]
    assert got.shape == want.shape, (name, what, got.shape, want.shape)
    got = got.astype(want.dtype) if want.dtype != got.dtype else got
    if family == "exact":
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {what}")
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True,
                                   err_msg=f"{name} {what}")


def run_case(name, seed=0):
    """Run case ``name`` through both packages and hold the port to the
    reference: values, dtypes and, where the case says, gradients."""
    case = CASES[name]
    assert case.family != "random", name
    args, kwargs = case.make(np.random.default_rng(seed))
    grad = case.grad
    ref_ins, port_ins = [], []

    def to_ref(a):
        t = ref.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
        if grad and a.dtype.kind == "f":
            ref_ins.append(t)
        return t

    def to_port(a):
        t = torch.from_numpy(np.array(a, copy=True))
        if grad and a.dtype.kind == "f":
            t.requires_grad_(True)
            port_ins.append(t)
        return t

    if case.raw:
        r_args, r_kwargs, p_args, p_kwargs = args, kwargs, args, kwargs
    else:
        r_args, r_kwargs = _convert(args, to_ref), _convert(kwargs, to_ref)
        p_args, p_kwargs = _convert(args, to_port), _convert(kwargs, to_port)
    r_out = getattr(ref, case.name)(*r_args, **r_kwargs)
    p_out = getattr(port, case.name)(*p_args, **p_kwargs)
    r_leaves, p_leaves = _leaves(r_out), _leaves(p_out)
    assert len(r_leaves) == len(p_leaves), (name, len(r_leaves), len(p_leaves))
    for o in p_leaves:
        if isinstance(o, torch.Tensor):
            assert o.device.type == "cpu", name
    r_np, p_np = [_ref_numpy(o) for o in r_leaves], [_port_numpy(o) for o in p_leaves]
    for i, (g, w) in enumerate(zip(p_np, r_np)):
        if isinstance(p_leaves[i], torch.Tensor):
            pd = str(g.dtype)
            assert _X64.get(pd, pd) == str(w.dtype), (name, i, pd, str(w.dtype))
    if case.family == "invariant":
        inputs = [a for a in _arrays(args)]
        r_u = case.unique(r_np if len(r_np) > 1 else r_np[0], inputs)
        p_u = case.unique(p_np if len(p_np) > 1 else p_np[0], inputs)
        for k in r_u:
            _compare(name, np.asarray(p_u[k]), np.asarray(r_u[k]), "invariant", k)
    else:
        for i, (g, w) in enumerate(zip(p_np, r_np)):
            _compare(name, g, w, case.family, f"output {i}")
    if not grad or not ref_ins:
        return
    rng = np.random.default_rng(seed + 1)
    weights = [rng.standard_normal(w.shape).astype(np.float32)
               if w.dtype.kind == "f" and isinstance(o, ref.Tensor) else None
               for w, o in zip(r_np, r_leaves)]
    if all(w is None for w in weights):
        return
    r_loss = None
    p_loss = None
    for ro, po, w in zip(r_leaves, p_leaves, weights):
        if w is None:
            continue
        rl = ref.sum(ref.multiply(ro, ref.to_tensor(w)))
        r_loss = rl if r_loss is None else ref.add(r_loss, rl)
        pl = torch.sum(po * torch.from_numpy(w).to(po.dtype))
        p_loss = pl if p_loss is None else p_loss + pl
    r_loss.backward()
    r_grads = [np.zeros(t.shape, np.float32) if t.grad is None else np.asarray(t.grad._value)
               for t in ref_ins]
    if p_loss.requires_grad:
        p_grads = torch.autograd.grad(p_loss, port_ins, allow_unused=True)
    else:
        p_grads = [None] * len(port_ins)
    p_grads = [np.zeros(tuple(t.shape), np.float32) if g is None else g.float().numpy()
               for g, t in zip(p_grads, port_ins)]
    for i, (g, w) in enumerate(zip(p_grads, r_grads)):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOLERANCE[0], atol=GRAD_TOLERANCE[1],
                                   err_msg=f"{name} gradient of input {i}")

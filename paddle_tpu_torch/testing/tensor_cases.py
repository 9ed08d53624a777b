"""The case table of the tensor API sweep: one call of each of the
reference's 281 public tensor functions, with its inputs made by numpy from
a seed.

The CPU parity tests (``tests/test_torch_tensor_api_*.py``) run each case
through ``paddle_tpu.<name>`` and ``paddle_tpu_torch.<name>``;
``chip_smoke.py``'s ``tensor_api`` phase runs it on card tensors against the
CPU. A case is ``make(rng) -> (args, kwargs)``: every numpy array in
``args``, in ``kwargs`` and in a list or tuple among them becomes a tensor
of the package under test. Its ``family`` names the tolerance
(:data:`TOLERANCE`):

- ``exact``: manipulation, logic, search, integer and creation functions;
- ``elementwise``: transcendental and other elementwise arithmetic;
- ``reduction``: sums, products and statistics;
- ``linalg``: linear algebra;
- ``invariant``: a factorisation that is not unique; its ``unique`` maps the
  outputs (numpy) to what is (singular values, a reconstruction, moduli);
- ``random``: the random functions, held by their own tests (shape, dtype,
  device, determinism under ``paddle.seed``, moments) and not by value.

``grad`` says whether the gradients of ``sum(out * w)`` are compared (the
default, where an output is floating and an input is a float array);
``inplace`` marks a function that writes its first argument; ``raw``, one
whose arrays are passed as they are (``to_tensor``). A function's further
cases, each a branch that its main case does not reach (duplicate indices,
an absolute ``tol``, edges wider than one), are keyed ``"name[branch]"``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Case", "CASES", "TOLERANCE", "GRAD_TOLERANCE", "RANDOM"]

# (rtol, atol) by family, for the reference against the port on the CPU and
# for the card against the CPU
TOLERANCE = {"exact": (0.0, 0.0), "elementwise": (1e-5, 1e-6), "reduction": (1e-5, 1e-5),
             "linalg": (1e-4, 1e-4), "invariant": (1e-4, 1e-4)}
GRAD_TOLERANCE = (1e-5, 1e-5)


class Case:
    __slots__ = ("name", "family", "make", "grad", "unique", "inplace", "raw")

    def __init__(self, name, family, make, grad=True, unique=None, inplace=False, raw=False):
        self.name, self.family, self.make = name, family, make
        self.grad = grad and family not in ("random", "invariant") and not inplace
        self.unique, self.inplace, self.raw = unique, inplace, raw

    def __repr__(self):
        return f"Case({self.name!r}, {self.family!r})"


CASES = {}


def _case(name, family, make, branch=None, **kw):
    """A case of ``name``; a ``branch`` case (a non-default argument of a
    function that has its main case) is keyed ``"name[branch]"``."""
    CASES[f"{name}[{branch}]" if branch else name] = Case(name, family, make, **kw)


# ---- inputs ---------------------------------------------------------------

def f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def pos(rng, *shape):
    return rng.uniform(0.5, 2.0, shape).astype(np.float32)


def unit(rng, *shape):
    return rng.uniform(-0.9, 0.9, shape).astype(np.float32)


def ints(rng, lo, hi, *shape):
    return rng.integers(lo, hi, shape).astype(np.int64)


def with_nans(rng, *shape):
    x = f(rng, *shape)
    x.reshape(-1)[::5] = np.nan
    return x


def well(rng, n):
    """A well-conditioned square matrix."""
    return (3 * np.eye(n) + 0.5 * rng.standard_normal((n, n))).astype(np.float32)


def spd(rng, n):
    a = rng.standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def upper(rng, n):
    return np.triu(well(rng, n)).astype(np.float32)


def ties(rng, *shape):
    return rng.integers(0, 4, shape).astype(np.float32)


# ---- creation --------------------------------------------------------------

_case("to_tensor", "exact", lambda r: ([f(r, 3, 4)], {}), raw=True)
_case("zeros", "exact", lambda r: ([[2, 3]], {}))
_case("ones", "exact", lambda r: ([[2, 3]], {"dtype": "int32"}))
_case("full", "exact", lambda r: ([[2, 3], 1.5], {}))
_case("empty", "exact", lambda r: ([[2, 3]], {}))
_case("zeros_like", "exact", lambda r: ([f(r, 3, 4)], {}))
_case("ones_like", "exact", lambda r: ([f(r, 3, 4)], {}))
_case("full_like", "exact", lambda r: ([f(r, 3, 4), 2.5], {}))
_case("empty_like", "exact", lambda r: ([f(r, 3, 4)], {}))
_case("arange", "exact", lambda r: ([1, 11, 3], {}))
_case("linspace", "elementwise", lambda r: ([0.0, 1.0, 7], {}))
_case("logspace", "elementwise", lambda r: ([0.0, 2.0, 5], {}))
_case("eye", "exact", lambda r: ([3, 4], {}))
_case("diag", "elementwise", lambda r: ([f(r, 4)], {"offset": 1, "padding_value": 2.0}))
_case("diagflat", "exact", lambda r: ([f(r, 2, 2)], {"offset": -1}))
_case("tril", "exact", lambda r: ([f(r, 4, 4), 1], {}))
_case("triu", "exact", lambda r: ([f(r, 4, 4), -1], {}))
# the reference's meshgrid detaches its outputs (ROADMAP.md, "Faults in the reference")
_case("meshgrid", "exact", lambda r: ([[f(r, 3), f(r, 4)]], {}), grad=False)
_case("clone", "exact", lambda r: ([f(r, 3, 4)], {}))
_case("assign", "exact", lambda r: ([f(r, 3, 4)], {}), grad=False)
_case("tril_indices", "exact", lambda r: ([4, 5, 1], {}))
_case("triu_indices", "exact", lambda r: ([4, None, 0], {}))
_case("complex", "exact", lambda r: ([f(r, 3), f(r, 3)], {}))
RANDOM = {
    "rand": lambda r: ([[64, 64]], {}),
    "randn": lambda r: ([[64, 64]], {}),
    "standard_normal": lambda r: ([[64, 64]], {}),
    "normal": lambda r: ([], {"mean": 1.0, "std": 2.0, "shape": [64, 64]}),
    "uniform": lambda r: ([[64, 64]], {"min": -2.0, "max": 2.0}),
    "randint": lambda r: ([0, 10, [64, 64]], {}),
    "randint_like": lambda r: ([np.zeros((64, 64), np.float32), 0, 10], {}),
    "randperm": lambda r: ([4096], {}),
    "bernoulli": lambda r: ([np.full((64, 64), 0.3, np.float32)], {}),
    "poisson": lambda r: ([np.full((64, 64), 3.0, np.float32)], {}),
    "multinomial": lambda r: ([np.array([0.1, 0.2, 0.3, 0.4], np.float32), 4096, True], {}),
    "uniform_": lambda r: ([np.zeros((64, 64), np.float32)], {"min": 0.0, "max": 1.0}),
    "exponential_": lambda r: ([np.zeros((64, 64), np.float32)], {"lam": 2.0}),
}
for _name, _make in RANDOM.items():
    _case(_name, "random", _make, inplace=_name.endswith("_"))

# ---- math ------------------------------------------------------------------

for _name in ("add", "subtract", "multiply", "divide", "maximum", "minimum", "fmax", "fmin",
              "atan2", "logaddexp", "copysign", "hypot"):
    _case(_name, "elementwise", lambda r: ([f(r, 3, 4), f(r, 3, 4)], {}))
_case("multiply", "elementwise", lambda r: ([f(r, 3, 4), 2.5], {}))
_case("subtract", "elementwise", lambda r: ([2.0, f(r, 3, 4)], {}))
_case("floor_divide", "exact", lambda r: ([ints(r, -20, 20, 3, 4), ints(r, 1, 5, 3, 4)], {}))
for _name in ("remainder", "mod", "floor_mod"):
    _case(_name, "exact", lambda r: ([ints(r, -20, 20, 3, 4), ints(r, 1, 5, 3, 4)], {}))
_case("pow", "elementwise", lambda r: ([pos(r, 3, 4), 2.5], {}))
_case("kron", "elementwise", lambda r: ([f(r, 2, 3), f(r, 3, 2)], {}))
_case("inner", "reduction", lambda r: ([f(r, 3, 4), f(r, 5, 4)], {}))
_case("outer", "elementwise", lambda r: ([f(r, 3), f(r, 4)], {}))
_case("heaviside", "exact", lambda r: ([f(r, 3, 4), f(r, 3, 4)], {}), grad=False)
_case("nextafter", "exact", lambda r: ([f(r, 3, 4), f(r, 3, 4)], {}), grad=False)
_case("gcd", "exact", lambda r: ([ints(r, 1, 50, 3, 4), ints(r, 1, 50, 3, 4)], {}))
_case("lcm", "exact", lambda r: ([ints(r, 1, 20, 3, 4), ints(r, 1, 20, 3, 4)], {}))
for _name, _gen in (("sqrt", pos), ("rsqrt", pos), ("exp", f), ("expm1", f), ("log", pos),
                    ("log2", pos), ("log10", pos), ("log1p", pos), ("sin", f), ("cos", f),
                    ("tan", unit), ("asin", unit), ("acos", unit), ("atan", f), ("sinh", f),
                    ("cosh", f), ("tanh", f), ("asinh", f), ("atanh", unit), ("reciprocal", pos),
                    ("square", f), ("erf", f), ("erfinv", unit), ("lgamma", pos),
                    ("digamma", pos), ("sigmoid", f), ("stanh", f), ("deg2rad", f),
                    ("rad2deg", f), ("frac", f), ("abs", f), ("neg", f)):
    _case(_name, "elementwise", lambda r, g=_gen: ([g(r, 3, 4)], {}))
_case("acosh", "elementwise", lambda r: ([1.0 + pos(r, 3, 4)], {}))
for _name in ("sign", "floor", "ceil", "round", "trunc"):
    _case(_name, "exact", lambda r: ([3 * f(r, 3, 4)], {}))
_case("logit", "elementwise", lambda r: ([r.uniform(0.05, 0.95, (3, 4)).astype(np.float32)], {}))
for _name in ("isnan", "isinf", "isfinite"):
    _case(_name, "exact", lambda r: ([np.array([[1.0, np.nan, np.inf], [-np.inf, 0.0, 2.0]],
                                               np.float32)], {}))
_case("nan_to_num", "exact", lambda r: ([np.array([[1.0, np.nan, np.inf], [-np.inf, 0.0, 2.0]],
                                                  np.float32)], {}), grad=False)
_case("clip", "elementwise", lambda r: ([f(r, 3, 4), -0.5, 0.5], {}))
_case("scale", "elementwise", lambda r: ([f(r, 3, 4), 2.0, 1.0], {}))
_case("increment", "elementwise", lambda r: ([f(r, 3, 4), 2.0], {}), inplace=True)
_case("softplus_op", "elementwise", lambda r: ([f(r, 3, 4), 2.0], {}))
_case("angle", "elementwise", lambda r: ([f(r, 3, 4)], {}))
for _name in ("conj", "real", "imag"):
    _case(_name, "exact", lambda r: ([f(r, 3, 4)], {}))
_case("lerp", "elementwise", lambda r: ([f(r, 3, 4), f(r, 3, 4), 0.3], {}))
_case("sum", "reduction", lambda r: ([f(r, 3, 4)], {"axis": 1, "keepdim": True}))
_case("mean", "reduction", lambda r: ([f(r, 3, 4)], {"axis": [0, 1]}))
_case("max", "exact", lambda r: ([f(r, 3, 4)], {"axis": 0}))
_case("min", "exact", lambda r: ([f(r, 3, 4)], {}))
_case("amax", "exact", lambda r: ([f(r, 3, 4)], {"axis": 1, "keepdim": True}))
_case("amin", "exact", lambda r: ([f(r, 3, 4)], {"axis": [0, 1]}))
_case("prod", "reduction", lambda r: ([f(r, 3, 4)], {"axis": 1}))
_case("nansum", "reduction", lambda r: ([with_nans(r, 3, 4)], {"axis": 0}), grad=False)
_case("nanmean", "reduction", lambda r: ([with_nans(r, 3, 4)], {"axis": 1}), grad=False)
_case("logsumexp", "reduction", lambda r: ([f(r, 3, 4)], {"axis": 1}))
_case("all", "exact", lambda r: ([r.random((3, 4)) > 0.2], {"axis": 1}))
_case("any", "exact", lambda r: ([r.random((3, 4)) > 0.8], {"axis": 0}))
_case("count_nonzero", "exact", lambda r: ([ints(r, 0, 3, 3, 4)], {"axis": 0}))
_case("cumsum", "reduction", lambda r: ([f(r, 3, 4)], {"axis": 1}))
_case("cumprod", "reduction", lambda r: ([f(r, 3, 4)], {"dim": 1}))
_case("cummax", "exact", lambda r: ([f(r, 3, 6)], {"axis": 1}))
_case("cummin", "exact", lambda r: ([f(r, 3, 6)], {"axis": 1}))
_case("trace", "reduction", lambda r: ([f(r, 4, 4)], {"offset": 1}))
_case("diff", "elementwise", lambda r: ([f(r, 3, 5)], {"axis": 1, "prepend": f(r, 3, 1)}))
_case("add_n", "elementwise", lambda r: ([[f(r, 3, 4), f(r, 3, 4), f(r, 3, 4)]], {}))
_case("matmul", "reduction", lambda r: ([f(r, 3, 4), f(r, 5, 4)], {"transpose_y": True}))
_case("dot", "reduction", lambda r: ([f(r, 3, 4), f(r, 3, 4)], {}))
_case("bmm", "reduction", lambda r: ([f(r, 2, 3, 4), f(r, 2, 4, 5)], {}))
_case("mv", "reduction", lambda r: ([f(r, 3, 4), f(r, 4)], {}))
_case("mm", "reduction", lambda r: ([f(r, 3, 4), f(r, 4, 5)], {}))
_case("addmm", "reduction", lambda r: ([f(r, 3, 5), f(r, 3, 4), f(r, 4, 5)],
                                       {"beta": 0.5, "alpha": 2.0}))
_case("einsum", "reduction", lambda r: (["ij,jk->ik", f(r, 3, 4), f(r, 4, 5)], {}))
_case("renorm", "elementwise", lambda r: ([f(r, 3, 4), 2, 0, 1.0], {}))
for _name, _gen, _extra in (("tanh_", f, ()), ("ceil_", f, ()), ("floor_", f, ()),
                            ("exp_", f, ()), ("sqrt_", pos, ()), ("rsqrt_", pos, ()),
                            ("reciprocal_", pos, ()), ("round_", f, ()), ("erfinv_", unit, ()),
                            ("clip_", f, (-0.5, 0.5)), ("scale_", f, (2.0, 1.0))):
    _case(_name, "elementwise", lambda r, g=_gen, e=_extra: ([g(r, 3, 4), *e], {}), inplace=True)
for _name in ("add_", "subtract_"):
    _case(_name, "elementwise", lambda r: ([f(r, 3, 4), f(r, 3, 4)], {}), inplace=True)
_case("lerp_", "elementwise", lambda r: ([f(r, 3, 4), f(r, 3, 4), 0.3], {}), inplace=True)

# ---- manipulation ------------------------------------------------------------

_case("cast", "exact", lambda r: ([f(r, 3, 4), "float64"], {}))
_case("reshape", "exact", lambda r: ([f(r, 3, 4), [2, -1]], {}))
_case("reshape_", "exact", lambda r: ([f(r, 3, 4), [4, 3]], {}), inplace=True)
_case("flatten", "exact", lambda r: ([f(r, 2, 3, 4)], {"start_axis": 1, "stop_axis": 2}))
_case("flatten_", "exact", lambda r: ([f(r, 2, 3, 4)], {"start_axis": 0, "stop_axis": 1}),
      inplace=True)
_case("transpose", "exact", lambda r: ([f(r, 2, 3, 4), [2, 0, 1]], {}))
_case("t", "exact", lambda r: ([f(r, 3, 4)], {}))
_case("moveaxis", "exact", lambda r: ([f(r, 2, 3, 4), 0, 2], {}))
_case("swapaxes", "exact", lambda r: ([f(r, 2, 3, 4), 0, 2], {}))
_case("squeeze", "exact", lambda r: ([f(r, 3, 1, 4, 1)], {"axis": [1, 2]}))
_case("squeeze_", "exact", lambda r: ([f(r, 3, 1, 4, 1)], {"axis": [1]}), inplace=True)
_case("unsqueeze", "exact", lambda r: ([f(r, 3, 4), [0, 2]], {}))
_case("unsqueeze_", "exact", lambda r: ([f(r, 3, 4), [0, -1]], {}), inplace=True)
_case("concat", "exact", lambda r: ([[f(r, 2, 3), f(r, 4, 3)]], {"axis": 0}))
_case("stack", "exact", lambda r: ([[f(r, 3, 4), f(r, 3, 4)]], {"axis": 1}))
_case("split", "exact", lambda r: ([f(r, 6, 4), [2, -1, 1]], {"axis": 0}))
_case("chunk", "exact", lambda r: ([f(r, 6, 4), 3], {}))
_case("unbind", "exact", lambda r: ([f(r, 3, 4)], {"axis": 1}))
_case("unstack", "exact", lambda r: ([f(r, 3, 4)], {"axis": 1}))
_case("tile", "exact", lambda r: ([f(r, 2, 3), [2, 1]], {}))
_case("expand", "exact", lambda r: ([f(r, 3, 1), [2, -1, 4]], {}))
_case("expand_as", "exact", lambda r: ([f(r, 3, 1), f(r, 2, 3, 4)], {}))
_case("broadcast_to", "exact", lambda r: ([f(r, 1, 4), [3, 4]], {}))
_case("broadcast_tensors", "exact", lambda r: ([[f(r, 3, 1), f(r, 1, 4)]], {}))
_case("gather", "exact", lambda r: ([f(r, 5, 3), np.array([4, 0, 2, 2])], {"axis": 0}))
_case("index_select", "exact", lambda r: ([f(r, 3, 5), np.array([4, 1, 1])], {"axis": 1}))
_case("gather_nd", "exact", lambda r: ([f(r, 3, 4, 5), np.array([[0, 1], [2, 3], [1, 0]])], {}))
_case("take_along_axis", "exact", lambda r: ([f(r, 3, 4), ints(r, 0, 4, 3, 2), 1], {}))
_case("put_along_axis", "exact", lambda r: ([f(r, 3, 4), ints(r, 0, 4, 3, 1), f(r, 3, 1), 1], {}))
_case("put_along_axis_", "exact", lambda r: ([f(r, 3, 4), ints(r, 0, 4, 3, 1), f(r, 3, 1), 1],
                                             {}), inplace=True)
_case("scatter", "exact", lambda r: ([f(r, 5, 3), np.array([2, 0, 4]), f(r, 3, 3)], {}))
_case("scatter_", "exact", lambda r: ([f(r, 5, 3), np.array([2, 0, 4]), f(r, 3, 3)],
                                      {"overwrite": False}), inplace=True)
_case("scatter_nd_add", "elementwise", lambda r: ([f(r, 4, 3), np.array([[1], [3], [1]]),
                                                   f(r, 3, 3)], {}))
_case("scatter_nd", "elementwise", lambda r: ([np.array([[1], [3], [1]]), f(r, 3, 4), [5, 4]], {}))
_case("index_sample", "exact", lambda r: ([f(r, 3, 5), ints(r, 0, 5, 3, 2)], {}))
_case("masked_select", "exact", lambda r: ([f(r, 3, 4), r.random((3, 4)) > 0.5], {}))
_case("masked_fill", "exact", lambda r: ([f(r, 3, 4), r.random((3, 4)) > 0.5, 2.0], {}))
_case("where", "exact", lambda r: ([r.random((3, 4)) > 0.5, f(r, 3, 4), f(r, 3, 4)], {}))
_case("roll", "exact", lambda r: ([f(r, 3, 4), 1], {"axis": 0}))
_case("flip", "exact", lambda r: ([f(r, 3, 4), [0, 1]], {}))
_case("reverse", "exact", lambda r: ([f(r, 3, 4), [1]], {}))
_case("rot90", "exact", lambda r: ([f(r, 3, 4)], {"k": 1, "axes": [0, 1]}))
_case("repeat_interleave", "exact", lambda r: ([f(r, 3, 4), 2], {"axis": 1}))
_case("unique", "exact", lambda r: ([ints(r, 0, 5, 12)], {"return_index": True,
                                                          "return_counts": True}))
_case("unique_consecutive", "exact", lambda r: ([np.sort(ints(r, 0, 5, 12))],
                                                {"return_inverse": True, "return_counts": True}))
_case("slice", "exact", lambda r: ([f(r, 4, 5), [0, 1], [1, -3], [3, 10]], {}))
_case("strided_slice", "exact", lambda r: ([f(r, 6, 5), [0, 1], [5, 0], [0, 5], [-2, 2]], {}))
_case("shard_index", "exact", lambda r: ([ints(r, 0, 20, 6, 1), 20, 4, 1], {}))
_case("crop", "exact", lambda r: ([f(r, 4, 5)], {"shape": [2, 3], "offsets": [1, 1]}))
_case("as_complex", "exact", lambda r: ([f(r, 3, 2)], {}))
_case("as_real", "exact", lambda r: ([(f(r, 3) + 1j * f(r, 3)).astype(np.complex64)], {}))
_case("tensordot", "reduction", lambda r: ([f(r, 3, 4, 5), f(r, 4, 5, 2), 2], {}))
_case("numel", "exact", lambda r: ([f(r, 3, 4)], {}))
_case("rank", "exact", lambda r: ([f(r, 3, 4)], {}))
_case("shape", "exact", lambda r: ([f(r, 3, 4)], {}))
_case("diagonal", "exact", lambda r: ([f(r, 3, 4, 4)], {"offset": 0, "axis1": 1, "axis2": 2}))
_case("multiplex", "exact", lambda r: ([[f(r, 3, 2), f(r, 3, 2)], ints(r, 0, 2, 3, 1)], {}))
_case("tolist", "exact", lambda r: ([f(r, 3, 4)], {}))
_case("broadcast_shape", "exact", lambda r: ([[3, 1], [1, 4]], {}))

# ---- logic -------------------------------------------------------------------

for _name in ("equal", "not_equal"):
    _case(_name, "exact", lambda r: ([ints(r, 0, 3, 3, 4), ints(r, 0, 3, 3, 4)], {}))
for _name in ("less_than", "less_equal", "greater_than", "greater_equal"):
    _case(_name, "exact", lambda r: ([ties(r, 3, 4), ties(r, 3, 4)], {}))
for _name in ("logical_and", "logical_or", "logical_xor"):
    _case(_name, "exact", lambda r: ([r.random((3, 4)) > 0.5, r.random((3, 4)) > 0.5], {}))
_case("logical_not", "exact", lambda r: ([r.random((3, 4)) > 0.5], {}))
for _name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    _case(_name, "exact", lambda r: ([ints(r, 0, 64, 3, 4), ints(r, 0, 64, 3, 4)], {}))
_case("bitwise_not", "exact", lambda r: ([ints(r, -64, 64, 3, 4)], {}))
_case("equal_all", "exact", lambda r: ([np.arange(6.0, dtype=np.float32)] * 2, {}))
_case("allclose", "exact", lambda r: ([np.ones(6, np.float32), np.ones(6, np.float32) + 1e-7], {}))
_case("isclose", "exact", lambda r: ([np.ones(4, np.float32),
                                      np.array([1.0, 1.0 + 1e-6, 1.1, np.nan], np.float32)], {}))
_case("is_empty", "exact", lambda r: ([np.zeros((0, 3), np.float32)], {}))
_case("is_tensor", "exact", lambda r: ([f(r, 3)], {}))
_case("is_floating_point", "exact", lambda r: ([f(r, 3)], {}))
_case("is_integer", "exact", lambda r: ([ints(r, 0, 3, 3)], {}))
_case("is_complex", "exact", lambda r: ([f(r, 3)], {}))

# ---- search ------------------------------------------------------------------

_case("argmax", "exact", lambda r: ([ties(r, 3, 6)], {"axis": 1}))
_case("argmin", "exact", lambda r: ([ties(r, 3, 6)], {}))
_case("argsort", "exact", lambda r: ([ties(r, 3, 8)], {"axis": 1, "descending": True}))
_case("sort", "exact", lambda r: ([f(r, 4, 3)], {"axis": 0, "descending": True}))
_case("topk", "exact", lambda r: ([ties(r, 3, 8), 3], {"axis": 1}))
_case("kthvalue", "exact", lambda r: ([ties(r, 3, 8), 3], {"axis": 1}))
_case("mode", "exact", lambda r: ([ints(r, 0, 3, 3, 8).astype(np.float32)], {"axis": 1}),
      grad=False)
_case("nonzero", "exact", lambda r: ([ties(r, 3, 4)], {}))
_case("searchsorted", "exact", lambda r: ([np.sort(f(r, 6)), f(r, 4)], {}))
_case("bucketize", "exact", lambda r: ([f(r, 4), np.sort(f(r, 6))], {"right": True}))
_case("index_put", "exact", lambda r: ([f(r, 4, 3), (np.array([0, 2]),), f(r, 2, 3)], {}))

# ---- stat --------------------------------------------------------------------

_case("std", "reduction", lambda r: ([f(r, 3, 4)], {"axis": 1}))
_case("var", "reduction", lambda r: ([f(r, 3, 4)], {"axis": [0, 1], "unbiased": False}))
_case("median", "reduction", lambda r: ([f(r, 3, 4)], {"axis": 1}))
_case("nanmedian", "reduction", lambda r: ([with_nans(r, 3, 5)], {"axis": 1}), grad=False)
_case("quantile", "reduction", lambda r: ([f(r, 3, 5), [0.25, 0.5]], {"axis": 1}))
_case("nanquantile", "reduction", lambda r: ([with_nans(r, 3, 6), 0.3], {"axis": 1}),
      grad=False)
_case("histogram", "exact", lambda r: ([f(r, 40)], {"bins": 5, "min": -2, "max": 2}))
_case("bincount", "reduction", lambda r: ([ints(r, 0, 6, 10)], {"weights": f(r, 10)}),
      grad=False)
_case("corrcoef", "reduction", lambda r: ([f(r, 3, 6)], {}))
_case("cov", "reduction", lambda r: ([f(r, 3, 6)], {}))

# ---- linalg ------------------------------------------------------------------


def _svd_unique(outs, ins):
    u, s, vh = outs
    return {"s": s, "recon": (u * s[..., None, :]) @ vh, "abs_u": np.abs(u), "abs_vh": np.abs(vh)}


def _qr_unique(outs, ins):
    q, r = outs
    return {"recon": q @ r, "abs_q": np.abs(q), "abs_r": np.abs(r)}


def _eig_unique(outs, ins):
    w, v = outs
    order = np.lexsort((np.round(w.imag, 4), np.round(w.real, 4)))
    return {"w": w[order], "abs_v": np.abs(v[:, order]),
            "residual": np.abs(ins[0] @ v - v * w[None, :]).max(keepdims=True)}


def _eigh_unique(outs, ins):
    w, v = outs
    return {"w": w, "abs_v": np.abs(v), "recon": (v * w[None, :]) @ v.T}


def _eigvals_unique(outs, ins):
    w = outs
    return {"w": w[np.lexsort((np.round(w.imag, 4), np.round(w.real, 4)))]}


def _lu_parts(r):
    n = 4
    low = np.tril(0.3 * r.standard_normal((n, n)), -1) + np.eye(n)
    up = np.triu(well(r, n))
    return (np.tril(low, -1) + up).astype(np.float32), np.array([2, 2, 3, 3], np.int32)


_case("norm", "reduction", lambda r: ([f(r, 3, 4)], {"p": "fro", "axis": [0, 1]}))
_case("dist", "reduction", lambda r: ([f(r, 3, 4), f(r, 3, 4)], {"p": 2}))
_case("cross", "elementwise", lambda r: ([f(r, 3, 3), f(r, 3, 3)], {"axis": 1}))
_case("cholesky", "linalg", lambda r: ([spd(r, 3)], {}))
_case("cholesky_solve", "linalg",
      lambda r: ([f(r, 3, 2), np.linalg.cholesky(spd(r, 3)).astype(np.float32)], {}))
_case("inverse", "linalg", lambda r: ([well(r, 3)], {}))
_case("inv", "linalg", lambda r: ([well(r, 3)], {}))
_case("det", "linalg", lambda r: ([well(r, 3)], {}))
_case("slogdet", "linalg", lambda r: ([well(r, 3)], {}))
_case("svd", "invariant", lambda r: ([f(r, 4, 3)], {}), unique=_svd_unique)
_case("qr", "invariant", lambda r: ([f(r, 4, 3)], {}), unique=_qr_unique)
_case("eig", "invariant", lambda r: ([well(r, 3)], {}), unique=_eig_unique)
_case("eigh", "invariant", lambda r: ([spd(r, 3)], {}), unique=_eigh_unique)
_case("eigvals", "invariant", lambda r: ([well(r, 3)], {}), unique=_eigvals_unique)
_case("eigvalsh", "linalg", lambda r: ([spd(r, 3)], {}))
_case("solve", "linalg", lambda r: ([well(r, 3), f(r, 3, 2)], {}))
_case("triangular_solve", "linalg", lambda r: ([upper(r, 3), f(r, 3, 2)], {"upper": True}))
_case("lstsq", "linalg", lambda r: ([f(r, 5, 3), f(r, 5, 2)], {}))
_case("pinv", "linalg", lambda r: ([f(r, 4, 3)], {}))
_case("matrix_power", "linalg", lambda r: ([0.5 * f(r, 3, 3), 3], {}))
_case("matrix_rank", "exact", lambda r: ([f(r, 4, 3)], {}))
_case("multi_dot", "linalg", lambda r: ([[f(r, 3, 4), f(r, 4, 5), f(r, 5, 2)]], {}))
_case("lu", "linalg", lambda r: ([well(r, 4)], {"get_infos": True}), grad=False)
_case("lu_unpack", "linalg", lambda r: (list(_lu_parts(r)), {}), grad=False)
_case("cond", "linalg", lambda r: ([well(r, 3)], {}))


# ---- branches ----------------------------------------------------------------


def _ranked(rng):
    """A 4 x 3 matrix of singular values 3, 1 and 0.2."""
    u, _ = np.linalg.qr(rng.standard_normal((4, 3)))
    v, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return (u @ np.diag([3.0, 1.0, 0.2]) @ v.T).astype(np.float32)


# Paddle's tol is absolute: 2 singular values above 0.5 (a relative tol, 1)
_case("matrix_rank", "exact", lambda r: ([_ranked(r)], {"tol": 0.5}), branch="tol")
_case("diff", "elementwise",
      lambda r: ([f(r, 3, 5)], {"axis": 1, "prepend": f(r, 3, 2), "append": f(r, 3, 3)}),
      branch="wide_edges")
# duplicate indices: the last write lands and alone takes a gradient
_case("scatter", "exact", lambda r: ([f(r, 5, 3), np.array([2, 0, 2]), f(r, 3, 3)], {}),
      branch="duplicates")
_case("put_along_axis", "exact",
      lambda r: ([f(r, 3, 4), np.array([[1, 1], [0, 3], [2, 2]]), f(r, 3, 2), 1], {}),
      branch="duplicates")
_case("index_put", "exact", lambda r: ([f(r, 4, 3), (np.array([0, 2, 0]),), f(r, 3, 3)], {}),
      branch="duplicates")

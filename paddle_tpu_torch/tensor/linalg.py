"""Linear algebra (``paddle_tpu/tensor/linalg.py``; parity:
python/paddle/tensor/linalg.py). The matmul family lives in
:mod:`.math` and is re-exported here, as in the reference.

``norm`` over two axes is the matrix norm for every ``p`` (1, 2, inf,
-inf, ``"fro"``, ``"nuc"``), over one axis or ``None`` the vector norm.
``lstsq`` is the reference's SVD solve (``jnp.linalg.lstsq``: the
solution, the squared residual norms, the rank, the singular values), so
it runs alike on the card (whose torch ``lstsq`` has only the ``gels``
driver). ``eig`` and ``eigvals`` are not differentiable, as in the
reference; on CUDA they copy to the host.
"""
from __future__ import annotations

import torch

from ._helpers import axis as _axis, cast, ensure_tensor
from .math import addmm, bmm, dot, einsum, matmul, mm, mv  # noqa: F401  (re-export)

__all__ = ["norm", "dist", "cross", "cholesky", "cholesky_solve", "inverse", "inv", "det", "slogdet",
           "svd", "qr", "eig", "eigh", "eigvals", "eigvalsh", "solve", "triangular_solve", "lstsq",
           "pinv", "matrix_power", "matrix_rank", "multi_dot", "lu", "cond", "lu_unpack"]


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """The Frobenius norm of every entry (``p="fro"``, ``axis=None``;
    ``keepdim`` is not applied there, as in the reference), the vector
    ``p``-norm of the flattened tensor (``axis=None``) or over one axis, or
    the matrix ``p``-norm over two axes."""
    (x,) = cast("norm", ensure_tensor(x))
    if axis is None:
        flat = x.reshape(-1)
        if p == "fro":
            return torch.sqrt(torch.sum(flat * flat))
        return torch.linalg.vector_norm(flat, ord=p)
    ax = _axis(axis)
    if isinstance(ax, tuple) and len(ax) == 2:
        if x.dtype in (torch.float16, torch.bfloat16):  # torch's matrix norms take f32 and up
            return torch.linalg.matrix_norm(x.float(), ord=p, dim=ax, keepdim=keepdim).to(x.dtype)
        return torch.linalg.matrix_norm(x, ord=p, dim=ax, keepdim=keepdim)
    return torch.linalg.vector_norm(x, ord=2 if p == "fro" else p, dim=ax, keepdim=keepdim)


def dist(x, y, p=2, name=None):
    x, y = cast("dist", ensure_tensor(x), ensure_tensor(y))
    return torch.linalg.vector_norm((x - y).reshape(-1), ord=p)


def cross(x, y, axis=9, name=None):
    x, y = cast("cross", ensure_tensor(x), ensure_tensor(y))
    ax = axis if axis != 9 else next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=ax)


def cholesky(x, upper=False, name=None):
    (x,) = cast("cholesky", ensure_tensor(x))
    low = torch.linalg.cholesky(x)
    return low.transpose(-1, -2) if upper else low


def cholesky_solve(x, y, upper=False, name=None):
    """``A z = x`` for the Cholesky factor ``y`` of ``A``."""
    b, factor = cast("cholesky_solve", ensure_tensor(x), ensure_tensor(y))
    low = factor.transpose(-1, -2) if upper else factor
    z = torch.linalg.solve_triangular(low, b, upper=False)
    return torch.linalg.solve_triangular(low.transpose(-1, -2), z, upper=True)


def inverse(x, name=None):
    return torch.linalg.inv(*cast("inverse", ensure_tensor(x)))


inv = inverse


def det(x, name=None):
    return torch.linalg.det(*cast("det", ensure_tensor(x)))


def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(*cast("slogdet", ensure_tensor(x)))
    return torch.stack([sign, logdet])


def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(*cast("svd", ensure_tensor(x)), full_matrices=full_matrices))


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(*cast("qr", ensure_tensor(x)), mode=mode)
    return r if mode == "r" else (q, r)


def eig(x, name=None):
    return tuple(torch.linalg.eig(*cast("eig", ensure_tensor(x).detach())))


def eigh(x, UPLO="L", name=None):  # noqa: N803
    return tuple(torch.linalg.eigh(*cast("eigh", ensure_tensor(x)), UPLO=UPLO))


def eigvals(x, name=None):
    return torch.linalg.eigvals(*cast("eigvals", ensure_tensor(x).detach()))


def eigvalsh(x, UPLO="L", name=None):  # noqa: N803
    return torch.linalg.eigvalsh(*cast("eigvalsh", ensure_tensor(x)), UPLO=UPLO)


def solve(x, y, name=None):
    return torch.linalg.solve(*cast("solve", ensure_tensor(x), ensure_tensor(y)))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False, name=None):
    a, b = cast("triangular_solve", ensure_tensor(x), ensure_tensor(y))
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    vec = b.ndim == 1
    out = torch.linalg.solve_triangular(a, b.unsqueeze(-1) if vec else b, upper=upper,
                                        unitriangular=unitriangular)
    return out.squeeze(-1) if vec else out


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, squared residual norms, rank, singular values) of
    ``min |x s - y|`` by the SVD, as the reference's ``jnp.linalg.lstsq``
    (``driver`` is accepted and not read)."""
    a, b = cast("lstsq", ensure_tensor(x), ensure_tensor(y))
    vec = b.ndim == 1
    b2 = b.unsqueeze(-1) if vec else b
    m, n = a.shape[-2:]
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    mask = s >= rcond * s[..., :1]
    rank = mask.sum(-1)
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s)).unsqueeze(-1)
    sol = vh.transpose(-1, -2) @ (s_inv * (u.transpose(-1, -2) @ b2))
    resid = torch.linalg.vector_norm(b2 - a @ sol, dim=-2) ** 2
    if vec:
        sol = sol.reshape(-1)
    return sol, resid, rank, s


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(*cast("pinv", ensure_tensor(x)), rtol=rcond, hermitian=hermitian)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(*cast("matrix_power", ensure_tensor(x)), n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The count of singular values above ``tol``, an absolute tolerance as
    in Paddle and the reference (whose ``jnp.linalg.matrix_rank(x, tol)``
    counts ``S > tol`` unscaled); without ``tol``, torch's default relative
    one."""
    return torch.linalg.matrix_rank(*cast("matrix_rank", ensure_tensor(x)), atol=tol,
                                    hermitian=hermitian)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(cast("multi_dot", *[ensure_tensor(t) for t in x])))


def lu(x, pivot=True, get_infos=False, name=None):
    """The packed LU factor and 0-based sequential row swaps (int32), as the
    reference's ``jax.scipy.linalg.lu_factor`` gives them; ``get_infos``
    adds LAPACK's info (0 for a factor without a zero pivot)."""
    lu_, piv, info = torch.linalg.lu_factor_ex(*cast("lu", ensure_tensor(x)), pivot=pivot)
    outs = (lu_, (piv - 1).to(torch.int32))
    return outs + (info.to(torch.int32),) if get_infos else outs


def cond(x, p=None, name=None):
    """The condition number ``norm(x) norm(x^-1)`` for ``p`` in {None,
    ``"fro"``, 2, -2, 1, -1, inf, -inf, ``"nuc"``}, in f32 as the
    reference computes it."""
    (x,) = cast("cond", ensure_tensor(x))
    a = x.to(torch.float32)
    if p in (None, 2, -2, "nuc"):
        s = torch.linalg.svdvals(a)
        if p == "nuc":
            return torch.sum(s, -1) * torch.sum(1.0 / s, -1)
        return s[..., 0] / s[..., -1] if p != -2 else s[..., -1] / s[..., 0]
    inv_a = torch.linalg.inv(a)
    if p == "fro":
        def nrm(m):
            return torch.sqrt(torch.sum(m * m, dim=(-2, -1)))
    elif p in (1, -1):
        def nrm(m):
            red = torch.amax if p == 1 else torch.amin
            return red(torch.sum(torch.abs(m), dim=-2), dim=-1)
    elif p in (float("inf"), float("-inf")):
        def nrm(m):
            red = torch.amax if p == float("inf") else torch.amin
            return red(torch.sum(torch.abs(m), dim=-1), dim=-1)
    else:
        raise ValueError(f"unsupported p={p!r}")
    return nrm(a) * nrm(inv_a)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) with ``A = P L U`` from :func:`lu`'s packed factor and
    0-based pivots."""
    (lu_,) = cast("lu_unpack", ensure_tensor(x))
    piv = ensure_tensor(y, device=lu_.device)
    return tuple(torch.lu_unpack(lu_, (piv + 1).to(torch.int32), unpack_ludata, unpack_pivots))

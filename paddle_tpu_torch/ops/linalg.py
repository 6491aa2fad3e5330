"""Linear algebra ops (a port of ``paddle_tpu/ops/linalg.py``).

The reference computes these in XLA, outside Pallas; here they are
``torch.linalg`` (LAPACK on the CPU, cuSOLVER / cuBLAS on the card).
The dtype contract is the reference's: f64 in, f64 out, f32 in, f32
out. The reference's ``_f32_on_tpu`` (linalg.py:12-52) demotes f64 to
f32 on the TPU, which has no f64 linear algebra; the card has f64, so
nothing is demoted and that wrapper has no counterpart.

Decompositions (``svd``, ``qr``, ``eigh``, ``eig``, ``lu``) are unique
only up to the sign or order of their factors, so their values can
differ from the reference's while both reconstruct the input. ``lu``'s
pivots are 1-based, as Paddle's (and LAPACK's, which ``lu_factor``
returns as they are); its ``get_infos`` are LAPACK's (0 for every
nonsingular matrix, as the reference's are always 0). ``lstsq`` goes
through the SVD, as ``jnp.linalg.lstsq`` does, so it returns the
residuals, rank and singular values on either device.
"""
import torch

from ..core.dispatch import register_op
from .math import bmm, dot, matmul, mv  # noqa: F401  re-export
from .reduction import dist, norm  # noqa: F401


@register_op("cholesky")
def _cholesky(x, *, upper):
    L = torch.linalg.cholesky(x)
    return L.transpose(-1, -2) if upper else L


def cholesky(x, upper=False, name=None):
    return _cholesky(x, upper=bool(upper))


@register_op("inverse")
def _inv(x):
    return torch.linalg.inv(x)


def inv(x, name=None):
    return _inv(x)


inverse = inv


@register_op("matrix_power")
def _matrix_power(x, *, n):
    return torch.linalg.matrix_power(x, n)


def matrix_power(x, n, name=None):
    return _matrix_power(x, n=int(n))


@register_op("det")
def _det(x):
    return torch.linalg.det(x)


def det(x, name=None):
    return _det(x)


@register_op("slogdet")
def _slogdet(x):
    sign, logdet = torch.linalg.slogdet(x)
    return sign, logdet


def slogdet(x, name=None):
    return _slogdet(x)


@register_op("solve")
def _solve(a, b):
    return torch.linalg.solve(a, b)


def solve(x, y, name=None):
    return _solve(x, y)


@register_op("triangular_solve")
def _triangular_solve(a, b, *, upper, transpose, unitriangular):
    if transpose:     # A^T X = B: A^T is triangular the other way
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return _triangular_solve(x, y, upper=bool(upper),
                             transpose=bool(transpose),
                             unitriangular=bool(unitriangular))


@register_op("svd", differentiable=False)
def _svd(x, *, full_matrices):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh


def svd(x, full_matrices=False, name=None):
    """``(U, S, Vh)``, as ``jnp.linalg.svd``."""
    return _svd(x, full_matrices=bool(full_matrices))


@register_op("qr", differentiable=False)
def _qr(x, *, mode):
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


def qr(x, mode="reduced", name=None):
    """``(Q, R)``; ``mode="r"`` gives R alone, as the reference."""
    return _qr(x, mode=mode)


@register_op("eigh", differentiable=False)
def _eigh(x, *, uplo):
    w, v = torch.linalg.eigh(x, UPLO=uplo)
    return w, v


def eigh(x, UPLO="L", name=None):
    return _eigh(x, uplo=UPLO)


@register_op("eigvalsh", differentiable=False)
def _eigvalsh(x, *, uplo):
    return torch.linalg.eigvalsh(x, UPLO=uplo)


def eigvalsh(x, UPLO="L", name=None):
    return _eigvalsh(x, uplo=UPLO)


@register_op("pinv", differentiable=False)
def _pinv(x, *, rcond):
    return torch.linalg.pinv(x, rtol=rcond)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    """``hermitian`` is taken and, as in the reference, not read."""
    return _pinv(x, rcond=float(rcond))


@register_op("matrix_rank", differentiable=False)
def _matrix_rank(x, *, tol):
    if tol is None:   # eps * max(m, n) * the largest singular value
        return torch.linalg.matrix_rank(x)
    return torch.linalg.matrix_rank(x, atol=tol, rtol=0.0)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """int64, as the reference's. A given ``tol`` is absolute: singular
    values at or below it count as zero, as in the reference (its
    ``jnp.linalg.matrix_rank(rtol=tol)`` compares ``S > tol``)."""
    return _matrix_rank(x, tol=tol)


@register_op("lstsq", differentiable=False)
def _lstsq(a, b):
    """``jnp.linalg.lstsq``'s algorithm: the SVD of ``a``, singular
    values below ``eps * max(m, n) * s_max`` dropped, and the squared
    residual norm of each column of ``b`` always returned (the
    reference's default, ``numpy_resid=False``)."""
    m, n = a.shape[-2], a.shape[-1]
    vec = b.dim() == 1
    bb = b[:, None] if vec else b
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cut = torch.finfo(a.dtype).eps * max(m, n) * s[..., :1]
    keep = (s > 0) & (s >= cut)
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0),
                        torch.zeros_like(s))
    sol = vh.transpose(-1, -2) @ (s_inv[..., None]
                                  * (u.transpose(-1, -2) @ bb))
    resid = (bb - a @ sol).square().sum(-2)
    if vec:
        sol, resid = sol[..., 0], resid[..., 0]
    return sol, resid, keep.sum(-1), s


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular values)``; ``rcond`` and
    the LAPACK routine's name are taken and, as in the reference, not
    read."""
    return _lstsq(x, y)


@register_op("multi_dot")
def _multi_dot(*xs):
    return torch.linalg.multi_dot(list(xs))


def multi_dot(x, name=None):
    return _multi_dot(*x)


@register_op("cond_number", differentiable=False)
def _cond(x, *, p):
    return torch.linalg.cond(x, p=p)


def cond(x, p=None, name=None):
    return _cond(x, p=p)


@register_op("lu", differentiable=False)
def _lu(x):
    lu_, piv, info = torch.linalg.lu_factor_ex(x)
    return lu_, piv, info


def lu(x, pivot=True, get_infos=False, name=None):
    """Reference ``paddle.linalg.lu`` (linalg.py:224-240): ``(LU,
    pivots[, infos])``, the unit-lower L below the diagonal of LU and U
    on and above it, int32 pivots 1-based, infos int32 of the batch
    shape (``[1]`` for one matrix)."""
    res, piv, info = _lu(x)
    if get_infos:
        from .manipulation import reshape
        batch = list(res.shape[:-2]) or [1]
        return res, piv, reshape(info, batch)
    return res, piv


@register_op("cholesky_solve")
def _cholesky_solve(y, x, *, upper):
    return torch.cholesky_solve(y, x, upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """Solves ``A @ out = x`` given the Cholesky factor ``y`` of A
    (reference operators/cholesky_solve_op)."""
    return _cholesky_solve(x, y, upper=bool(upper))


@register_op("householder_product", differentiable=False)
def _householder_product(x, tau):
    return torch.linalg.householder_product(x, tau)


def householder_product(x, tau, name=None):
    return _householder_product(x, tau)


@register_op("eig", differentiable=False)
def _eig(x):
    w, v = torch.linalg.eig(x)
    return w, v


def eig(x, name=None):
    """Complex eigenvalues and eigenvectors (complex64 for f32 input)."""
    return _eig(x)


@register_op("corrcoef", differentiable=False)
def _corrcoef(x, *, rowvar):
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


def corrcoef(x, rowvar=True, name=None):
    return _corrcoef(x, rowvar=bool(rowvar))


@register_op("cov", differentiable=False)
def _cov(x, fweights, aweights, *, rowvar, ddof):
    return torch.cov(x if rowvar or x.dim() < 2 else x.transpose(-1, -2),
                     correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return _cov(x, fweights, aweights, rowvar=bool(rowvar), ddof=bool(ddof))

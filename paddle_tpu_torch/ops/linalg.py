"""Linear algebra (counterpart of ``paddle_tpu/ops/linalg.py``):
functions on torch tensors, registered as ``Tensor``-level ops by
``_primitive.primitive``.  ``torch.linalg`` where it computes the same
function, the JAX formula otherwise (``norm``, ``dist``, ``cdist``,
``vector_norm``, ``dot``), so values and gradients agree.  Decompositions
defined up to sign or order (``svd``, ``eig``, ``eigh``, ``qr``) are
LAPACK's / cuSOLVER's choice in the port and XLA's in the JAX package:
compare them by reconstruction."""

from __future__ import annotations

import torch

from ..framework import random as _random
from ._primitive import primitive


def _dims(x, axis):
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _keep(out, x, axis, keepdim):
    if axis is None and keepdim:
        return out.reshape((1,) * x.ndim)
    return out


@primitive
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@primitive
def bmm(x, y, name=None):
    return torch.matmul(x, y)


@primitive
def mm(x, y, name=None):
    return torch.matmul(x, y)


@primitive
def dot(x, y, name=None):
    return torch.sum(x * y, dim=-1)


@primitive
def mv(x, vec, name=None):
    return torch.matmul(x, vec)


@primitive
def cross(x, y, axis=9, name=None):
    if axis == 9:
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


@primitive
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def _pnorm(x, p, axis, keepdim):
    dims = _dims(x, axis)
    if p == float("inf"):
        out = torch.amax(torch.abs(x), dim=dims, keepdim=keepdim)
    elif p == float("-inf"):
        out = torch.amin(torch.abs(x), dim=dims, keepdim=keepdim)
    elif p == 0:
        out = torch.sum((x != 0).to(x.dtype), dim=dims, keepdim=keepdim)
    else:
        out = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=dims,
                                  keepdim=keepdim), 1.0 / p)
    return out


@primitive
def norm(x, p="fro", axis=None, keepdim=False, name=None):
    if p == "fro" or (p == 2 and axis is None):
        return torch.sqrt(torch.sum(torch.square(x), dim=_dims(x, axis),
                                    keepdim=keepdim))
    if p == "nuc":
        s = torch.linalg.svdvals(x)
        return torch.sum(s, dim=-1, keepdim=keepdim)
    return _pnorm(x, p, axis, keepdim)


@primitive
def dist(x, y, p=2.0, name=None):
    d = x - y
    if p == float("inf"):
        return torch.amax(torch.abs(d))
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    return torch.pow(torch.sum(torch.pow(torch.abs(d), p)), 1.0 / p)


@primitive
def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return _pnorm(x, p, axis, keepdim)


@primitive
def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                    keepdim=keepdim)


@primitive
def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(x, upper=upper)


@primitive
def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(x, y, upper=upper)


@primitive
def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(x, mode=mode)
    return q, r


@primitive
def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.transpose(-1, -2)


@primitive
def svdvals(x, name=None):
    return torch.linalg.svdvals(x)


@primitive
def eig(x, name=None):
    w, v = torch.linalg.eig(x)
    return w, v


@primitive
def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


@primitive
def eigh(x, UPLO="L", name=None):
    w, v = torch.linalg.eigh(x, UPLO=UPLO)
    return w, v


@primitive
def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@primitive
def inverse(x, name=None):
    return torch.linalg.inv(x)


primitive(inverse, name="inv")
inv = inverse


@primitive
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@primitive
def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


@primitive
def triangular_solve(x, y, upper=True, transpose=False,
                     unitriangular=False, name=None):
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(
        a, y, upper=upper != bool(transpose), left=True,
        unitriangular=unitriangular)


@primitive
def lstsq(x, y, rcond=None, name=None):
    """Least squares: (solution, residuals, rank, singular values), the
    rank and the singular values computed apart where torch's routine
    for the device leaves them empty.  The JAX function's LAPACK-routine
    argument, which it never reads, is not taken."""
    sol, res, rank, sv = torch.linalg.lstsq(x, y, rcond=rcond)
    if rank.numel() == 0:
        rank = torch.linalg.matrix_rank(x)
    if sv.numel() == 0:
        sv = torch.linalg.svdvals(x)
    m, n = x.shape[-2], x.shape[-1]
    if res.numel() == 0 and m > n and bool((rank == n).all()):
        # numpy's residuals: the squared 2-norm of each column's error
        res = ((x @ sol - y) ** 2).sum(-2)
    return sol, res, rank, sv


@primitive
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, int(n))


@primitive
def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(x, rtol=tol, hermitian=hermitian).to(
        torch.int64)


@primitive
def det(x, name=None):
    """The determinant; a 16-bit input (``auto_cast`` O2 casts one) in
    fp32, rounded back, as torch has no 16-bit LU."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return torch.linalg.det(x.float()).to(x.dtype)
    return torch.linalg.det(x)


@primitive
def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


@primitive
def cond(x, p=None, name=None):
    return torch.linalg.cond(x, p)


@primitive
def lu(x, pivot=True, name=None):
    lu_, piv = torch.linalg.lu_factor(x, pivot=pivot)
    return lu_, piv.to(torch.int32)


@primitive
def lu_unpack(lu_data, pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    P, L, U = torch.lu_unpack(lu_data, pivots.to(torch.int32))
    if not unpack_ludata:
        L = U = None
    if not unpack_pivots:
        P = None
    return P, L, U


@primitive
def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(x, tau)


@primitive
def ormqr(x, tau, y, left=True, transpose=False, name=None):
    return torch.ormqr(x, tau, y, left=left, transpose=transpose)


@primitive
def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return torch.einsum(equation, *operands)


@primitive
def multi_dot(xs, name=None):
    return torch.linalg.multi_dot(list(xs))


@primitive
def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar else x.T)


@primitive
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


@primitive
def histogram(x, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    xf = x.reshape(-1)
    if min == 0 and max == 0:
        lo, hi = xf.min(), xf.max()
    else:
        lo = torch.tensor(float(min), dtype=xf.dtype, device=x.device)
        hi = torch.tensor(float(max), dtype=xf.dtype, device=x.device)
    width = (hi - lo) / bins
    idx = torch.floor((xf - lo) / torch.where(width > 0, width,
                                              torch.ones_like(width)))
    idx = torch.where(xf == hi, torch.full_like(idx, bins - 1), idx).long()
    inside = (xf >= lo) & (xf <= hi)
    w = (torch.ones_like(xf) if weight is None else
         weight.reshape(-1).to(xf.dtype)) * inside
    h = torch.zeros(bins, dtype=xf.dtype, device=x.device).index_add(
        0, idx.clamp(0, bins - 1), w)
    if density:
        return h / (h.sum() * width)
    return h.to(torch.int64) if weight is None else h


@primitive
def cdist(x, y, p=2.0, name=None):
    diff = torch.abs(x[..., :, None, :] - y[..., None, :, :])
    if p == 2.0:
        return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-30)
    if p == float("inf"):
        return torch.amax(diff, dim=-1)
    if p == 0.0:
        return torch.sum((diff != 0).to(x.dtype), dim=-1)
    return torch.sum(diff ** p, dim=-1) ** (1.0 / p)


@primitive
def matrix_exp(x, name=None):
    return torch.linalg.matrix_exp(x)


def _lowrank_svd(x, q, niter=2):
    n = x.shape[-1]
    omega = torch.randn(tuple(x.shape[:-2]) + (n, q), dtype=x.dtype,
                        device=x.device,
                        generator=_random.default_generator(x.device))
    qmat, _ = torch.linalg.qr(x @ omega)
    for _ in range(niter):
        qz, _ = torch.linalg.qr(x.transpose(-1, -2) @ qmat)
        qmat, _ = torch.linalg.qr(x @ qz)
    b = qmat.transpose(-1, -2) @ x
    u_b, s, vh = torch.linalg.svd(b, full_matrices=False)
    return qmat @ u_b, s, vh.transpose(-1, -2)


@primitive
def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    return _lowrank_svd(x if M is None else x - M, int(q), int(niter))


@primitive
def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    m, n = x.shape[-2], x.shape[-1]
    q = min(6, m, n) if q is None else int(q)
    xc = x - torch.mean(x, dim=-2, keepdim=True) if center else x
    return _lowrank_svd(xc, q, int(niter))

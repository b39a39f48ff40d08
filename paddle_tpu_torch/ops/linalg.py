"""Linear algebra — port of ``paddle_tpu/ops/linalg.py`` on
``torch.linalg`` (cuSOLVER/MAGMA on the card, LAPACK on the CPU)."""
from __future__ import annotations

import torch

from ..framework.tensor import wrap
from . import math as _math
from .dispatch import op, plain

matmul = _math.matmul
dot = _math.dot

_INF = float("inf")


@op("norm_op")
def _norm_raw(x, p=2.0, axis=None, keepdim=False):
    if p == "fro" or p is None:
        p = 2.0
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    if isinstance(axis, tuple) and len(axis) == 2:
        return torch.linalg.matrix_norm(x, ord="fro" if p == 2.0 else p,
                                        dim=axis, keepdim=keepdim)
    if p == _INF:
        return torch.amax(torch.abs(x), dim=axis, keepdim=keepdim)
    if p == -_INF:
        return torch.amin(torch.abs(x), dim=axis, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=axis, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=axis, keepdim=keepdim) ** (1.0 / p)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    p = 2.0 if p is None or p == "fro" else p
    return _norm_raw(x, p=p, axis=axis, keepdim=keepdim)


@op("dist")
def dist(x, y, p=2.0):
    d = (x - y).reshape(-1)
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    if p == _INF:
        return torch.amax(torch.abs(d))
    if p == -_INF:
        return torch.amin(torch.abs(d))
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


@op("cond_op")
def _cond_raw(x, p=None):
    if p is None or p == 2:
        s = torch.linalg.svdvals(x)
        return s[..., 0] / s[..., -1]
    return torch.linalg.cond(x, p)


def cond(x, p=None, name=None):
    return _cond_raw(x, p=p)


@op("inverse")
def inverse(x):
    return torch.linalg.inv(x)


inv = inverse


@op("pinv")
def _pinv_raw(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return _pinv_raw(x, rcond=rcond, hermitian=hermitian)


@op("det")
def det(x):
    return torch.linalg.det(x)


@op("slogdet")
def slogdet(x):
    s, logabs = torch.linalg.slogdet(x)
    return torch.stack([s, logabs])


@op("cholesky")
def _cholesky_raw(x, upper=False):
    return torch.linalg.cholesky(x, upper=upper)


def cholesky(x, upper=False, name=None):
    return _cholesky_raw(x, upper=upper)


@op("cholesky_solve")
def _cholesky_solve_raw(x, y, upper=False):
    # two triangular solves on the factor's own triangle, as JAX's
    # cho_solve: its gradient stays in that triangle
    if upper:
        u = torch.triu(y)
        w = torch.linalg.solve_triangular(u.mT, x, upper=False)
        return torch.linalg.solve_triangular(u, w, upper=True)
    lo = torch.tril(y)
    w = torch.linalg.solve_triangular(lo, x, upper=False)
    return torch.linalg.solve_triangular(lo.mT, w, upper=True)


def cholesky_solve(x, y, upper=False, name=None):
    return _cholesky_solve_raw(x, y, upper=upper)


@op("solve")
def solve(x, y):
    return torch.linalg.solve(x, y)


@op("triangular_solve")
def _triangular_solve_raw(x, y, upper=True, transpose=False,
                          unitriangular=False):
    if transpose:
        x, upper = x.mT, not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return _triangular_solve_raw(x, y, upper=upper, transpose=transpose,
                                 unitriangular=unitriangular)


@op("lstsq_sol")
def _lstsq_raw(x, y, rcond=None):
    return torch.linalg.lstsq(x, y, rcond=rcond).solution


def lstsq(x, y, rcond=None, driver=None, name=None):
    sol = _lstsq_raw(x, y, rcond=rcond)
    xv, yv, sv_ = plain(x), plain(y), plain(sol)
    res = torch.sum((xv @ sv_ - yv) ** 2, dim=-2)
    rank = torch.linalg.matrix_rank(xv)
    sv = torch.linalg.svdvals(xv)
    return sol, wrap(res), wrap(rank), wrap(sv)


@op("qr_op")
def _qr_raw(x, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    return q, r


def qr(x, mode="reduced", name=None):
    if mode == "r":
        return wrap(torch.linalg.qr(plain(x), mode="r").R)
    return _qr_raw(x, mode=mode)


@op("svd_op")
def _svd_raw(x, full_matrices=False):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.mT.conj()


def svd(x, full_matrices=False, name=None):
    return _svd_raw(x, full_matrices=full_matrices)


def eig(x, name=None):
    w, v = torch.linalg.eig(plain(x))
    return wrap(w), wrap(v)


@op("eigh_op")
def _eigh_raw(x, UPLO="L"):
    w, v = torch.linalg.eigh(x, UPLO=UPLO)
    return w, v


def eigh(x, UPLO="L", name=None):
    return _eigh_raw(x, UPLO=UPLO)


def eigvals(x, name=None):
    return wrap(torch.linalg.eigvals(plain(x)))


@op("eigvalsh_op")
def _eigvalsh_raw(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def eigvalsh(x, UPLO="L", name=None):
    return _eigvalsh_raw(x, UPLO=UPLO)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return wrap(torch.linalg.matrix_rank(plain(x), rtol=tol,
                                         hermitian=hermitian))


@op("matrix_power")
def _matrix_power_raw(x, n=1):
    return torch.linalg.matrix_power(x, n)


def matrix_power(x, n, name=None):
    return _matrix_power_raw(x, n=int(n))


@op("multi_dot")
def _multi_dot_raw(*xs):
    return torch.linalg.multi_dot(xs)


def multi_dot(x, name=None):
    return _multi_dot_raw(*x)


def lu(x, pivot=True, get_infos=False, name=None):
    lu_, piv = torch.linalg.lu_factor(plain(x))
    piv_t = wrap(piv.to(torch.int32))
    if get_infos:
        info = torch.zeros(tuple(x.shape[:-2]), dtype=torch.int32,
                           device=piv.device)
        return wrap(lu_), piv_t, wrap(info)
    return wrap(lu_), piv_t


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    """``lu``'s packed factors as (P, L, U) with ``A = P @ L @ U``."""
    P, L, U = torch.lu_unpack(plain(lu_data), plain(lu_pivots),
                              unpack_data=unpack_ludata,
                              unpack_pivots=unpack_pivots)
    return (wrap(P) if unpack_pivots else None,
            wrap(L) if unpack_ludata else None,
            wrap(U) if unpack_ludata else None)


def corrcoef(x, rowvar=True, name=None):
    v = plain(x)
    return wrap(torch.corrcoef(v if rowvar else v.T))


@op("cov_op")
def _cov_raw(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return _cov_raw(x, rowvar=rowvar, ddof=ddof, fweights=fweights,
                    aweights=aweights)


@op("histogram_op")
def _histogram_raw(x, bins=100, min=0, max=0):
    return torch.histc(x.float(), bins=bins, min=min, max=max)


def histogram(input, bins=100, min=0, max=0, name=None):
    return wrap(plain(_histogram_raw(input, bins=bins, min=min,
                                     max=max)).long())


def bincount(x, weights=None, minlength=0, name=None):
    return wrap(torch.bincount(plain(x), plain(weights),
                               minlength=minlength))

"""``mx.np.linalg`` (counterpart of ``mxnet_tpu/numpy/linalg.py``,
reference ``python/mxnet/numpy/linalg.py``): dense linear algebra over
``torch.linalg``, as the reference's is over XLA's (library calls in both;
no hand-written kernel is involved).  Each name is an ``np_linalg_<name>``
op through ``apply_op``, with numpy's argument conventions and results
(``slogdet`` and ``eigh`` return tuples, ``svd`` returns U, S, Vh,
``lstsq`` returns (x, residuals, rank, s)).  Eigen- and singular vectors
are unique only up to sign (a phase), as everywhere.
"""
from __future__ import annotations

import torch as _torch

from . import _fl, _t, _wrap


def _norm(x, ord=None, axis=None, keepdims=False):
    x = _fl(x)
    if axis is None and ord is None:
        return _torch.linalg.vector_norm(x.reshape(-1), keepdim=False) \
            .reshape((1,) * x.ndim if keepdims else ())
    if isinstance(axis, int) or (axis is None and x.ndim == 1):
        return _torch.linalg.vector_norm(
            x, ord=2 if ord is None else ord,
            dim=0 if axis is None else axis, keepdim=keepdims)
    return _torch.linalg.matrix_norm(
        x, ord="fro" if ord is None else ord,
        dim=(-2, -1) if axis is None else tuple(axis), keepdim=keepdims)


def _slogdet(a):
    r = _torch.linalg.slogdet(_fl(a))
    return r.sign, r.logabsdet


def _eigh(a, UPLO="L"):
    r = _torch.linalg.eigh(_fl(a), UPLO=UPLO)
    return r.eigenvalues, r.eigenvectors


def _eig(a):
    r = _torch.linalg.eig(_fl(a))
    return r.eigenvalues, r.eigenvectors


def _svd(a, full_matrices=True, compute_uv=True, hermitian=False):
    a = _fl(a)
    if not compute_uv:
        return _torch.linalg.svdvals(a)
    u, s, vh = _torch.linalg.svd(a, full_matrices=full_matrices)
    return u, s, vh


def _qr(a, mode="reduced"):
    q, r = _torch.linalg.qr(_fl(a), mode=mode)
    return r if mode == "r" else (q, r)


def _solve(a, b):
    a = _fl(a)
    b = _t(b, a).to(a.dtype)
    if b.ndim == 1:
        return _torch.linalg.solve(a, b.unsqueeze(-1)).squeeze(-1)
    return _torch.linalg.solve(a, b)


def _lstsq(a, b, rcond=None):
    """numpy's (x, residuals, rank, s) by the pseudo-inverse: the same
    minimum-norm solution on every device (CUDA's own driver assumes
    full rank)."""
    a = _fl(a)
    b = _t(b, a).to(a.dtype)
    s = _torch.linalg.svdvals(a)
    m, n = a.shape
    tol = (s.max() * max(m, n) * _torch.finfo(a.dtype).eps
           if rcond is None else s.max() * rcond)
    rank = (s > tol).sum()
    x = _torch.linalg.pinv(a, rtol=tol / s.max()) @ b
    r = a @ x - b
    if int(rank) == n and m > n:
        res = (r * r).sum(dim=0).reshape(-1)
    else:
        res = _torch.zeros((0,), dtype=a.dtype, device=a.device)
    return x, res, rank, s


def _matrix_rank(A, tol=None, hermitian=False, rtol=None):
    A = _fl(A)
    if tol is not None:
        return _torch.linalg.matrix_rank(A, atol=tol, rtol=0.0)
    return _torch.linalg.matrix_rank(A, rtol=rtol, hermitian=hermitian)


def _multi_dot(arrays):
    return _torch.linalg.multi_dot([_fl(x) for x in arrays])


def _tensorsolve(a, b, axes=None):
    a = _fl(a)
    return _torch.linalg.tensorsolve(a, _t(b, a).to(a.dtype), dims=axes)


_IMPL = {
    "norm": _norm,
    "inv": lambda a: _torch.linalg.inv(_fl(a)),
    "pinv": lambda a, rcond=None, hermitian=False, rtol=None:
        _torch.linalg.pinv(_fl(a), rtol=rtol if rcond is None else rcond,
                           hermitian=hermitian),
    "det": lambda a: _torch.linalg.det(_fl(a)),
    "slogdet": _slogdet, "eig": _eig, "eigh": _eigh,
    "eigvals": lambda a: _torch.linalg.eigvals(_fl(a)),
    "eigvalsh": lambda a, UPLO="L": _torch.linalg.eigvalsh(_fl(a),
                                                          UPLO=UPLO),
    "svd": _svd,
    "cholesky": lambda a, upper=False: _torch.linalg.cholesky(_fl(a),
                                                             upper=upper),
    "qr": _qr, "solve": _solve, "lstsq": _lstsq,
    "matrix_rank": _matrix_rank,
    "matrix_power": lambda a, n: _torch.linalg.matrix_power(a, n),
    "multi_dot": _multi_dot,
    "tensorinv": lambda a, ind=2: _torch.linalg.tensorinv(_fl(a), ind=ind),
    "tensorsolve": _tensorsolve,
    "cond": lambda x, p=None: _torch.linalg.cond(_fl(x), p=p),
}

__all__ = list(_IMPL)
for _nm, _fn in _IMPL.items():
    globals()[_nm] = _wrap(_fn, f"linalg_{_nm}")
del _nm, _fn

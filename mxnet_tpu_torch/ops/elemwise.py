"""Elementwise ops: the unary and binary families and ``add_n``.

Counterpart of ``mxnet_tpu/ops/elemwise.py``: the same names, aliases and
non-differentiable set.  As there, the ``elemwise_*`` names broadcast
(numpy semantics) and the ``broadcast_*`` aliases are the same ops.  Each
op is one torch call on the operands.  A comparison or logical op returns
0/1 in its left operand's dtype (float32 for a bool operand), as MXNet's
do; ``isnan``/``isinf``/``isfinite`` return bools, as the reference's do.
A python scalar operand takes the dtype torch's scalar promotion gives it
against the array (``torch.result_type``).  A sparse operand
(``ndarray/sparse.py``) dispatches on its storage type, as the
reference's FComputeEx ops do; ``out=`` is refused there.
"""
from __future__ import annotations

import math

import torch

from .registry import apply_op, exporter
from .registry import commit_out, make_exporter  # noqa: F401

__all__ = []
_export = exporter(__all__)

# rounding, predicates and comparisons: registered without a gradient
_NO_GRAD = frozenset([
    "sign", "ceil", "floor", "rint", "round", "trunc", "fix",
    "logical_not", "isnan", "isinf", "isfinite",
    "equal", "not_equal", "greater", "greater_equal", "lesser",
    "lesser_equal", "logical_and", "logical_or", "logical_xor",
])


def _refuse_out(name, out):
    if out is not None:
        from ..base import MXNetError

        raise MXNetError(f"{name}: out= is not supported with sparse "
                         "operands")


def _make_unary(name, tf, aliases=()):
    def fn(data, out=None, **kwargs):
        from ..ndarray import sparse as sp

        if isinstance(data, sp.BaseSparseNDArray):
            # stype dispatch: zero-preserving ops keep the structure
            _refuse_out(name, out)
            return sp.dispatch_unary(name, tf, data)
        return apply_op(tf, data, name=name, no_grad=name in _NO_GRAD)

    fn.__name__ = name
    fn.__doc__ = f"Elementwise ``{name}`` (one torch call)."
    _export(fn, name, aliases, no_grad=name in _NO_GRAD)


def _scalar(c, like):
    """A python scalar as a 0-d tensor of the dtype torch's scalar
    promotion gives it against ``like``, on ``like``'s device (a fill,
    no host copy: it may run inside a CUDA graph capture)."""
    return torch.full((), c, dtype=torch.result_type(like, c),
                      device=like.device)


def _make_binary(name, tf, aliases=()):
    def fn(lhs, rhs, out=None, **kwargs):
        from ..ndarray import sparse as sp
        from ..ndarray.ndarray import NDArray

        if isinstance(lhs, sp.BaseSparseNDArray) or \
                isinstance(rhs, sp.BaseSparseNDArray):
            _refuse_out(name, out)
            return sp.dispatch_binary(name, tf, lhs, rhs)
        ng = name in _NO_GRAD
        if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
            return apply_op(tf, lhs, rhs, name=name, no_grad=ng)
        if isinstance(lhs, NDArray):
            return apply_op(lambda a: tf(a, _scalar(rhs, a)), lhs,
                            name=name, no_grad=ng)
        if isinstance(rhs, NDArray):
            return apply_op(lambda b: tf(_scalar(lhs, b), b), rhs,
                            name=name, no_grad=ng)
        return NDArray(tf(torch.tensor(lhs), torch.tensor(rhs)))

    fn.__name__ = name
    fn.__doc__ = (f"Elementwise/broadcast ``{name}`` (numpy broadcasting; "
                  "the broadcast_* aliases are the same op).")
    _export(fn, name, aliases, no_grad=name in _NO_GRAD)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _gamma(x):
    """Γ(x): exp(lgamma) on the positive domain, the reflection formula
    π / (sin(πx)·Γ(1−x)) on the negative one (keeps the sign)."""
    pos = torch.exp(torch.lgamma(x))
    neg = math.pi / (torch.sin(math.pi * x) * torch.exp(torch.lgamma(1.0 - x)))
    return torch.where(x > 0, pos, neg)


def _logical_not(x):
    if x.is_floating_point():
        return (x == 0).to(x.dtype)
    return torch.logical_not(x)


def _cmp_dtype(a):
    return torch.float32 if a.dtype == torch.bool else a.dtype


def _cmp(op):
    return lambda a, b: op(a, b).to(_cmp_dtype(a))


def _logical(op):
    return lambda a, b: op(a != 0, b != 0).to(_cmp_dtype(a))


_UNARY = [
    ("abs", torch.abs),
    ("sign", torch.sign),
    ("ceil", torch.ceil),
    ("floor", torch.floor),
    ("rint", torch.round),
    ("round", torch.round),
    ("trunc", torch.trunc),
    ("fix", torch.trunc),
    ("exp", torch.exp),
    ("expm1", torch.expm1),
    ("log", torch.log),
    ("log10", torch.log10),
    ("log2", torch.log2),
    ("log1p", torch.log1p),
    ("sqrt", torch.sqrt),
    ("rsqrt", torch.rsqrt),
    ("cbrt", _cbrt),
    ("rcbrt", lambda x: 1.0 / _cbrt(x)),
    ("square", torch.square),
    ("reciprocal", lambda x: 1.0 / x),
    ("negative", torch.neg),
    ("relu", torch.relu),
    ("sigmoid", torch.sigmoid),
    ("softsign", lambda x: x / (1.0 + torch.abs(x))),
    ("softrelu", lambda x: torch.logaddexp(x, torch.zeros_like(x))),
    ("tanh", torch.tanh),
    ("sin", torch.sin),
    ("cos", torch.cos),
    ("tan", torch.tan),
    ("arcsin", torch.asin),
    ("arccos", torch.acos),
    ("arctan", torch.atan),
    ("sinh", torch.sinh),
    ("cosh", torch.cosh),
    ("arcsinh", torch.asinh),
    ("arccosh", torch.acosh),
    ("arctanh", torch.atanh),
    ("erf", torch.erf),
    ("erfinv", torch.erfinv),
    ("gamma", _gamma),
    ("gammaln", torch.lgamma),
    ("logical_not", _logical_not),
    ("degrees", torch.rad2deg),
    ("radians", torch.deg2rad),
    ("identity", lambda x: x + 0, ("copy", "stop_gradient_off")),
    ("isnan", torch.isnan),
    ("isinf", torch.isinf),
    ("isfinite", torch.isfinite),
]

for _row in _UNARY:
    _make_unary(*_row)

_BINARY = [
    ("add", torch.add, ("elemwise_add", "broadcast_add", "broadcast_plus")),
    ("subtract", torch.sub,
     ("elemwise_sub", "broadcast_sub", "broadcast_minus")),
    ("multiply", torch.mul, ("elemwise_mul", "broadcast_mul")),
    ("divide", torch.true_divide, ("elemwise_div", "broadcast_div")),
    ("mod", torch.remainder, ("broadcast_mod",)),
    ("power", torch.pow, ("broadcast_power", "pow")),
    ("maximum", torch.maximum, ("broadcast_maximum",)),
    ("minimum", torch.minimum, ("broadcast_minimum",)),
    ("hypot", torch.hypot, ("broadcast_hypot",)),
    ("arctan2", torch.atan2),
    ("equal", _cmp(torch.eq), ("broadcast_equal",)),
    ("not_equal", _cmp(torch.ne), ("broadcast_not_equal",)),
    ("greater", _cmp(torch.gt), ("broadcast_greater",)),
    ("greater_equal", _cmp(torch.ge), ("broadcast_greater_equal",)),
    ("lesser", _cmp(torch.lt), ("broadcast_lesser",)),
    ("lesser_equal", _cmp(torch.le), ("broadcast_lesser_equal",)),
    ("logical_and", _logical(torch.logical_and), ("broadcast_logical_and",)),
    ("logical_or", _logical(torch.logical_or), ("broadcast_logical_or",)),
    ("logical_xor", _logical(torch.logical_xor), ("broadcast_logical_xor",)),
]

for _row in _BINARY:
    _make_binary(*_row)


def add_n(*args, out=None, **kwargs):
    """Sum of N arrays in one op (reference ``add_n``/``ElementWiseSum``)."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])

    def f(*raws):
        acc = raws[0]
        for r in raws[1:]:
            acc = acc + r
        return acc

    return apply_op(f, *args, name="add_n")


_export(add_n, "add_n", ("ElementWiseSum",))

"""Shape and comparison ops: ``slice_axis``, ``expand_dims``, ``squeeze``,
``broadcast_lesser`` and ``identity``.

Counterpart of the parts of ``mxnet_tpu/ops/tensor.py`` and
``ops/elemwise.py`` that the BERT and Transformer slice calls; the rest
ports with the op library (ROADMAP Queue 1 item 1).  A comparison
returns 0/1 in its left operand's dtype (float32 for bool operands), as
MXNet's do, not a bool tensor.
"""
from __future__ import annotations

import torch

from .registry import apply_op

__all__ = ["slice_axis", "expand_dims", "squeeze", "broadcast_lesser",
           "identity"]


def slice_axis(data, axis=0, begin=0, end=None, **kwargs):
    """Reference ``slice_axis``: ``[begin, end)`` along one axis."""
    key = [slice(None)] * data.ndim
    key[axis] = slice(begin, end)
    key = tuple(key)
    return apply_op(lambda a: a[key], data, name="slice_axis")


def expand_dims(data, axis, **kwargs):
    """Reference ``expand_dims``: a length-1 axis inserted at ``axis``."""
    return apply_op(lambda a: a.unsqueeze(axis), data, name="expand_dims")


def squeeze(data, axis=None, **kwargs):
    """Reference ``squeeze``: drop the length-1 axes (all, or those of
    ``axis``, an int or a tuple)."""
    def f(a):
        if axis is None:
            return a.squeeze()
        return a.squeeze(axis if isinstance(axis, int) else tuple(axis))

    return apply_op(f, data, name="squeeze")


def _cmp_dtype(a):
    return torch.float32 if a.dtype == torch.bool else a.dtype


def broadcast_lesser(lhs, rhs, **kwargs):
    """Reference ``broadcast_lesser``: ``lhs < rhs`` with broadcasting,
    as 0/1 in lhs's dtype."""
    return apply_op(lambda a, b: (a < b).to(_cmp_dtype(a)), lhs, rhs,
                    name="lesser")


def identity(data, **kwargs):
    """Reference ``identity``: a copy of ``data``."""
    return apply_op(lambda a: a + 0, data, name="identity")

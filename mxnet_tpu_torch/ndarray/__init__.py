"""The ``mx.nd`` namespace: NDArray, creation and the ops the Llama
inference slice uses.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``.  The rest of the op
library (``ops/tensor.py``, ``ops/nn_ops.py``, ...) ports with later
slices (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from ..base import resolve_dtype as _resolve_dtype
from ..context import current_context
from ..ops.registry import apply_op as _apply_op
from .ndarray import NDArray


def array(source_array, ctx=None, dtype=None):
    """Create an NDArray from any array-like (reference ``mx.nd.array``)
    on ``ctx`` (default: the current context)."""
    if isinstance(source_array, NDArray):
        out = source_array.astype(dtype) if dtype else source_array.copy()
        return out.as_in_context(ctx) if ctx else out
    return NDArray(source_array, ctx=ctx or current_context(),
                   dtype=_resolve_dtype(dtype))


def argmax(data, axis=None, keepdims=False):
    """Reference ``argmax``: index of the maximum, as float32 (the
    reference returns float indices)."""
    def f(a):
        if axis is None:
            return a.argmax().float()
        return a.argmax(dim=axis, keepdim=keepdims).float()

    return _apply_op(f, data, name="argmax")


def concat(*args, dim=1):
    """Reference ``Concat``: join arrays along existing axis ``dim``."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return _apply_op(lambda *raws: torch.cat(raws, dim=dim), *args,
                     name="concat")


def sigmoid(data):
    return _apply_op(torch.sigmoid, data, name="sigmoid")

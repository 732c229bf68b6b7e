"""The ``mx.nd`` namespace: NDArray, creation and the ops the Llama
and ResNet slices use (the ``F`` of ``HybridBlock.hybrid_forward``),
``save``/``load`` of ``.params`` files and ``waitall``.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``.  The rest of the op
library (``ops/tensor.py``, ``ops/nn_ops.py``, ...) ports with later
slices (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from ..base import resolve_dtype as _resolve_dtype
from ..context import current_context
from ..base import MXNetError as _MXNetError
from ..ops.nn_ops import (activation, batch_norm, convolution,  # noqa: F401
                          flatten, fully_connected, log_softmax, pooling,
                          relu, softmax_cross_entropy)
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


def zeros(shape, ctx=None, dtype=None, **kwargs):
    """Reference ``zeros``: float32 unless ``dtype`` says otherwise."""
    return _full(shape, 0.0, ctx, dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    """Reference ``ones``: float32 unless ``dtype`` says otherwise."""
    return _full(shape, 1.0, ctx, dtype)


def _full(shape, value, ctx, dtype):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.full(shape, value,
                              dtype=_resolve_dtype(dtype) or torch.float32,
                              device=(ctx or current_context()).device))


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


def _reshape_target(in_shape, spec):
    """The reference's reshape codes 0 (keep this input dim) and -1
    (infer one dim); -2/-3/-4 port with the op library."""
    out, infer_at = [], None
    for i, s in enumerate(spec):
        if s == 0:
            if i >= len(in_shape):
                raise _MXNetError(f"reshape code 0 at {i} has no input dim")
            out.append(in_shape[i])
        elif s == -1:
            if infer_at is not None:
                raise _MXNetError("reshape: more than one -1")
            infer_at = len(out)
            out.append(-1)
        elif s > 0:
            out.append(s)
        else:
            raise _MXNetError(f"reshape code {s} is not ported yet "
                              "(ROADMAP.md, Queue 1 item 1)")
    return tuple(out)


def reshape(data, shape=None, **kwargs):
    """Reference ``reshape`` with the 0 and -1 codes."""
    if shape is None:
        raise _MXNetError("reshape needs target shape")
    tgt = _reshape_target(data.shape, tuple(shape))
    return _apply_op(lambda a: a.reshape(tgt), data, name="reshape")


def _axes(axis, ndim, exclude):
    if axis is None:
        return None
    ax = (axis,) if isinstance(axis, int) else tuple(int(a) for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def sum(data, axis=None, keepdims=False, exclude=False):  # noqa: A001
    """Reference ``sum`` over ``axis`` (every other axis if
    ``exclude``)."""
    ax = _axes(axis, data.ndim, exclude)
    return _apply_op(lambda a: a.sum() if ax is None else
                     a.sum(dim=ax, keepdim=keepdims), data, name="sum")


def mean(data, axis=None, keepdims=False, exclude=False):
    """Reference ``mean`` over ``axis`` (every other axis if
    ``exclude``)."""
    ax = _axes(axis, data.ndim, exclude)
    return _apply_op(lambda a: a.mean() if ax is None else
                     a.mean(dim=ax, keepdim=keepdims), data, name="mean")


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """Reference ``pick``: one element per row along ``axis`` by an index
    array (clipped into range)."""
    def f(a, idx):
        ii = idx.long().clamp(0, a.shape[axis] - 1).unsqueeze(axis)
        out = torch.gather(a, axis, ii)
        return out if keepdims else out.squeeze(axis)

    return _apply_op(f, data, index, name="pick")


def square(data):
    return _apply_op(torch.square, data, name="square")


def abs(data):  # noqa: A001
    return _apply_op(torch.abs, data, name="abs")


def broadcast_mul(lhs, rhs):
    return _apply_op(torch.mul, lhs, rhs, name="broadcast_mul")


# the reference's operator-style names
Activation = activation
BatchNorm = batch_norm
Convolution = convolution
Flatten = flatten
FullyConnected = fully_connected
Pooling = pooling


def waitall():
    """Block until all enqueued device work completes (reference
    ``mx.nd.waitall``): every CUDA stream of every device is drained."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def load(fname):
    """Load NDArrays (a dict or a list) from an MXNet ``.params`` file
    (reference ``mx.nd.load``; the layout is in ``serialization.py``),
    on the CPU."""
    from .. import serialization

    return serialization.load_ndarrays(fname)


def save(fname, data):
    """Save a list or dict of NDArrays in the MXNet binary container
    (reference ``mx.nd.save``); files interchange with the reference."""
    from .. import serialization

    serialization.save_ndarrays(fname, data)

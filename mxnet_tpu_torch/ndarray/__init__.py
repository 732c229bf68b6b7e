"""The ``mx.nd`` namespace: NDArray, creation, the op library (the
``F`` of ``HybridBlock.hybrid_forward``), ``random``, ``save``/``load`` of
``.params`` files and ``waitall``.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: the ops of
``ops/elemwise.py``, ``ops/tensor.py``, ``ops/nn_ops.py``,
``ops/output_ops.py``, ``ops/contrib.py``, ``ops/quantization.py``,
``ops/rnn_ops.py`` and ``ops/attention.py`` under the reference's names
and aliases, the ``contrib`` namespace (``ndarray/contrib.py``), and the
sparse storage types (``nd.sparse``, ``nd.cast_storage``;
``ndarray/sparse.py``).
"""
from __future__ import annotations

import torch
import torch.utils.dlpack

from ..base import resolve_dtype as _resolve_dtype
from ..context import current_context
from ..ops.elemwise import *  # noqa: F401,F403
from ..ops.tensor import *  # noqa: F401,F403
from ..ops.nn_ops import *  # noqa: F401,F403
from ..ops.output_ops import *  # noqa: F401,F403
from ..ops.contrib import *  # noqa: F401,F403  (legacy top-level names)
from ..ops.quantization import *  # noqa: F401,F403
from ..ops.rnn_ops import *  # noqa: F401,F403
from ..ops.attention import (div_sqrt_dim,  # noqa: F401
                             dot_product_attention,
                             interleaved_matmul_selfatt_qk,
                             interleaved_matmul_selfatt_valatt)
from ..ops.registry import apply_op as _apply_op
from ..ops.registry import defop as _defop
from .. import random  # noqa: F401
from ..random import uniform as random_uniform  # noqa: F401
from ..random import normal as random_normal  # noqa: F401
from ..random import shuffle, multinomial, sample_multinomial  # noqa: F401
from .ndarray import NDArray
from . import contrib  # noqa: F401  (mx.nd.contrib namespace)
from . import sparse  # noqa: F401  (mx.nd.sparse namespace)
from .sparse import cast_storage  # noqa: F401
from ..operator import custom as Custom  # noqa: F401  (mx.nd.Custom)


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


@_defop()
def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None,
           **kwargs):
    """Reference ``arange``: evenly spaced values in ``[start, stop)``,
    each repeated ``repeat`` times, float32 unless ``dtype`` says
    otherwise, on ``ctx`` (default: the current context)."""
    if stop is None:
        start, stop = 0, start
    r = torch.arange(start, stop, step,
                     dtype=_resolve_dtype(dtype) or torch.float32,
                     device=(ctx or current_context()).device)
    if repeat > 1:
        r = r.repeat_interleave(repeat)
    return NDArray(r)


def full(shape, val, ctx=None, dtype=None, **kwargs):
    """Reference ``full``: ``val`` everywhere, float32 unless ``dtype``
    says otherwise."""
    return _full(shape, val, ctx, dtype)


def empty(shape, ctx=None, dtype=None):
    """Reference ``empty`` (zeros, as in the reference)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def linspace(start, stop, num, endpoint=True, ctx=None, dtype=None):
    """Reference ``linspace``: ``num`` evenly spaced values."""
    dt = _resolve_dtype(dtype) or torch.float32
    dev = (ctx or current_context()).device
    if endpoint:
        r = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        r = torch.arange(num, dtype=torch.float64) * \
            ((stop - start) / num) + start
    return NDArray(r.to(dtype=dt, device=dev))


def eye(N, M=0, k=0, ctx=None, dtype=None, **kwargs):
    """Reference ``eye``: ones on the k-th diagonal of an N×M matrix."""
    m = M or N
    dt = _resolve_dtype(dtype) or torch.float32
    dev = (ctx or current_context()).device
    out = torch.zeros((N, m), dtype=dt, device=dev)
    out.diagonal(k).fill_(1)
    return NDArray(out)


def full_like(data, fill_value, **kwargs):
    """Reference ``full_like``: ``fill_value`` in ``data``'s shape and
    dtype."""
    return _apply_op(lambda a: torch.full_like(a, fill_value), data,
                     name="full_like")


def concat_dim0(arrays):
    return concat(*arrays, dim=0)  # noqa: F405  (from ops.tensor)


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


def to_dlpack_for_read(data):
    """Zero-copy DLPack export (reference ``nd.to_dlpack_for_read``): the
    array's tensor, which implements ``__dlpack__``/``__dlpack_device__``
    (any consumer's ``from_dlpack`` takes it)."""
    return data._data.detach()


def to_dlpack_for_write(data):
    """Zero-copy DLPack export whose consumer writes land in the array
    (reference ``nd.to_dlpack_for_write``): torch tensors are mutable,
    so this is the same shared buffer as ``to_dlpack_for_read``."""
    return data._data.detach()


def from_dlpack(capsule):
    """An NDArray over a DLPack capsule or any ``__dlpack__`` object,
    sharing its memory (reference ``nd.from_dlpack``)."""
    return NDArray(torch.utils.dlpack.from_dlpack(capsule))

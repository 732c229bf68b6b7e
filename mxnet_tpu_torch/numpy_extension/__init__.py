"""``mx.npx`` — the numpy-extension namespace.

Counterpart of ``mxnet_tpu/numpy_extension/__init__.py`` (reference
``python/mxnet/numpy_extension/``): the MXNet ops with no numpy
equivalent (activations, the softmax family, ``batch_dot``, ``pick``,
``topk``, the sequence ops, embedding, the special reshape) returning
``mx.np.ndarray``, ``set_np``/``reset_np``, ``waitall``, ``seed`` and
``save``/``load`` in the byte format of ``nd.save`` (files interchange
with the reference).
"""
from __future__ import annotations

from ..base import MXNetError  # noqa: F401
from ..ndarray import NDArray  # noqa: F401
from ..numpy import _np
from ..util import (set_np, reset_np, is_np_array, is_np_shape,  # noqa:F401
                    set_np_shape, use_np, use_np_array, use_np_shape)

__all__ = ["set_np", "reset_np", "is_np_array", "is_np_shape", "waitall",
           "seed", "save", "load"]


def _reexport(names):
    from .. import ndarray as nd

    g = globals()
    for name in names:
        fn = getattr(nd, name)

        def mk(f):
            def wrapped(*args, **kwargs):
                return _np(f(*args, **kwargs))
            wrapped.__name__ = f.__name__
            wrapped.__doc__ = f.__doc__
            return wrapped

        g[name] = mk(fn)
        __all__.append(name)


_reexport("""relu sigmoid softmax log_softmax activation leaky_relu
    batch_dot pick topk one_hot gather_nd scatter_nd sequence_mask
    broadcast_like arange_like embedding Embedding batch_norm layer_norm
    fully_connected convolution pooling dropout reshape reshape_like
    slice slice_axis slice_like smooth_l1 erf erfinv gamma gammaln
    clip""".split())


def waitall():
    from .. import ndarray as nd

    nd.waitall()


def seed(seed_state):
    from .. import random

    random.seed(seed_state)


def save(file, arr):
    """Save np arrays (a dict or a list) in ``nd.save``'s container."""
    from ..serialization import save_ndarrays

    save_ndarrays(file, arr)


def load(file):
    """Load ``save``'s (or ``nd.save``'s) file as np arrays."""
    from ..serialization import load_ndarrays

    out = load_ndarrays(file)
    if isinstance(out, dict):
        return {k: _np(v) for k, v in out.items()}
    return [_np(v) for v in out]

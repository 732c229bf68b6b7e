"""Utility flags and helpers.

Counterpart of ``mxnet_tpu/util.py`` (reference ``python/mxnet/util.py``):
the numpy-semantics switches (``set_np``/``is_np_array``/``is_np_shape``,
the ``np_shape``/``np_array`` scopes and the ``use_np*`` decorators),
``set_np_default_dtype``, ``getenv``/``setenv``, ``makedirs``,
``get_gpu_count``/``get_gpu_memory`` (from ``torch.cuda``) and
``default_array``.  The flags are thread-local, as in the reference: a
serving thread's mode is its own.
"""
from __future__ import annotations

import functools
import os
import threading

from .base import MXNetError

_np_state = threading.local()


def _flags():
    if not hasattr(_np_state, "shape"):
        _np_state.shape = False
        _np_state.array = False
        _np_state.default_dtype = False
    return _np_state


def set_np_shape(active):
    """Turn zero-dim/zero-size shape semantics on or off (reference
    ``mx.util.set_np_shape``); returns the previous state."""
    st = _flags()
    prev = st.shape
    st.shape = bool(active)
    return prev


def is_np_shape():
    return _flags().shape


def set_np_array(active):
    """Turn np array semantics on or off; returns the previous state."""
    st = _flags()
    prev = st.array
    st.array = bool(active)
    return prev


def is_np_array():
    return _flags().array


def set_np(shape=True, array=True, dtype=False):
    """NumPy semantics for shapes and arrays (reference ``mx.util.set_np``
    and ``mx.npx.set_np``); ``dtype=True`` also makes float64 the default
    float type of creation."""
    if array and not shape:
        raise MXNetError("np array semantics require np shape semantics")
    set_np_shape(shape)
    set_np_array(array)
    _flags().default_dtype = bool(dtype)


def reset_np():
    """Back to classic MXNet semantics (reference ``mx.util.reset_np``)."""
    set_np(shape=False, array=False, dtype=False)


def set_np_default_dtype(is_np_default_dtype=True):
    """float64 as the default float type of ``mx.np`` creation (numpy's)
    instead of float32; returns the previous state."""
    st = _flags()
    prev = st.default_dtype
    st.default_dtype = bool(is_np_default_dtype)
    return prev


def is_np_default_dtype():
    return _flags().default_dtype


class _Scope:
    """Context manager and decorator setting one flag for its extent."""

    _setter = None

    def __init__(self, active=True):
        self._active = active
        self._prev = None

    def __enter__(self):
        self._prev = type(self)._setter(self._active)
        return self

    def __exit__(self, *exc):
        type(self)._setter(self._prev)

    def __call__(self, func):
        @functools.wraps(func)
        def wrapped(*args, **kwargs):
            with type(self)(self._active):
                return func(*args, **kwargs)
        return wrapped


class np_shape(_Scope):
    """Scope of np-shape semantics (reference ``mx.util.np_shape``)."""

    _setter = staticmethod(set_np_shape)


class np_array(_Scope):
    """Scope of np-array semantics (reference ``mx.util.np_array``)."""

    _setter = staticmethod(set_np_array)


def use_np_shape(func):
    return np_shape(True)(func)


def use_np_array(func):
    return np_array(True)(func)


def use_np(func):
    """Decorator: full np semantics inside ``func`` (reference
    ``mx.util.use_np``)."""
    return use_np_shape(use_np_array(func))


def getenv(name):
    """Reference ``mx.util.getenv``."""
    return os.environ.get(name)


def setenv(name, value):
    os.environ[name] = str(value)


def makedirs(d):
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def get_gpu_count():
    """The number of CUDA cards torch sees."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def get_gpu_memory(dev_id=0):
    """``(free, total)`` bytes of card ``dev_id`` (reference
    ``mx.util.get_gpu_memory``)."""
    import torch

    if dev_id >= get_gpu_count():
        raise MXNetError(f"no CUDA card {dev_id} (found {get_gpu_count()})")
    return torch.cuda.mem_get_info(dev_id)


def default_array(source_array, ctx=None, dtype=None):
    """An array in the active semantics: ``mx.np.array`` in np mode, else
    ``mx.nd.array`` (reference ``mx.util.default_array``)."""
    if is_np_array():
        from . import numpy as _mx_np

        return _mx_np.array(source_array, ctx=ctx, dtype=dtype)
    from . import ndarray as nd

    return nd.array(source_array, ctx=ctx, dtype=dtype)

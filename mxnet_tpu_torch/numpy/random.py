"""``mx.np.random`` (counterpart of ``mxnet_tpu/numpy/random.py``,
reference ``python/mxnet/numpy/random.py``): numpy-style sampling on the
port's per-device torch generators (``mx.random.generator(device)``,
seeded by ``seed``/``mx.random.seed``), never torch's global one.  The
streams are torch's, not the reference's JAX keys: the same seed gives
the same draws here, not the reference's values, so draws are held by
their distributions, never value by value.  ``size`` is numpy's (None: a
0-d array); floats default to float32."""
from __future__ import annotations

import numpy as _onp
import torch as _torch

from .. import random as _random
from ..base import resolve_dtype as _resolve_dtype
from ..context import current_context
from ..ndarray import NDArray
from . import _np

__all__ = ["uniform", "normal", "randint", "rand", "randn", "choice",
           "shuffle", "exponential", "gamma", "beta", "chisquare",
           "multinomial", "seed"]


def seed(seed_state):
    """Re-seed every device's generator (``mx.random.seed``)."""
    _random.seed(seed_state)


def _size_to_shape(size):
    if size is None:
        return ()
    return (size,) if isinstance(size, int) else tuple(size)


def _dev(ctx, device):
    return (ctx or device or current_context()).device


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None, device=None,
            out=None):
    return _np(_random.uniform(low, high, shape=_size_to_shape(size),
                               dtype=dtype, ctx=ctx or device, out=out))


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, device=None,
           out=None):
    return _np(_random.normal(loc, scale, shape=_size_to_shape(size),
                              dtype=dtype, ctx=ctx or device, out=out))


def randint(low, high=None, size=None, dtype=None, ctx=None, device=None,
            out=None):
    if high is None:
        low, high = 0, low
    return _np(_random.randint(low, high, shape=_size_to_shape(size),
                               dtype=dtype or "int64", ctx=ctx or device,
                               out=out))


def rand(*size):
    return uniform(0.0, 1.0, size=size or None)


def randn(*size):
    return normal(0.0, 1.0, size=size or None)


def exponential(scale=1.0, size=None, ctx=None, device=None, out=None):
    return _np(_random.exponential(scale, shape=_size_to_shape(size),
                                   ctx=ctx or device, out=out))


def _standard_gamma(alpha, shape, dev, dtype):
    a = _torch.full(shape, float(alpha), dtype=_torch.float32, device=dev)
    g = _torch._standard_gamma(a, generator=_random.generator(dev))
    return g.to(_resolve_dtype(dtype) or _torch.float32)


def gamma(shape, scale=1.0, size=None, dtype=None, ctx=None, device=None,
          out=None):
    """Gamma with shape ``shape`` and scale ``scale`` (numpy's order)."""
    dev = _dev(ctx, device)
    return _np(NDArray(_standard_gamma(shape, _size_to_shape(size), dev,
                                        dtype) * scale))


def beta(a, b, size=None, dtype=None, ctx=None, device=None):
    """Beta(a, b) as Ga/(Ga + Gb) of two gamma draws, as the reference
    draws it."""
    dev = _dev(ctx, device)
    shp = _size_to_shape(size)
    ga = _standard_gamma(a, shp, dev, _torch.float32)
    gb = _standard_gamma(b, shp, dev, _torch.float32)
    return _np(NDArray((ga / (ga + gb)).to(
        _resolve_dtype(dtype) or _torch.float32)))


def chisquare(df, size=None, dtype=None, ctx=None, device=None):
    """Chi-square with ``df`` degrees: Gamma(df/2, scale 2)."""
    return gamma(df / 2.0, 2.0, size, dtype, ctx, device)


def choice(a, size=None, replace=True, p=None, ctx=None, device=None,
           out=None):
    """Draws from ``a`` (an array's first axis, or ``arange(a)``), with or
    without replacement, uniform or with probabilities ``p``."""
    if isinstance(a, NDArray):
        pool, dev = a._data, a._data.device
        n = pool.shape[0]
    else:
        pool, n, dev = None, int(a), _dev(ctx, device)
    shp = _size_to_shape(size)
    k = int(_onp.prod(shp)) if shp else 1
    gen = _random.generator(dev)
    if p is not None:
        w = p._data if isinstance(p, NDArray) else \
            _torch.as_tensor(_onp.asarray(p, dtype=_onp.float64))
        idx = _torch.multinomial(w.to(dev, _torch.float64), k,
                                 replacement=replace, generator=gen)
    elif replace:
        idx = _torch.randint(0, n, (k,), generator=gen, device=dev)
    else:
        idx = _torch.randperm(n, generator=gen, device=dev)[:k]
    idx = idx.reshape(shp)
    raw = idx if pool is None else pool[idx]
    return _np(NDArray(raw))


def shuffle(x):
    """Permute ``x`` along its first axis in place (numpy's contract:
    returns None)."""
    dev = x._data.device
    perm = _torch.randperm(x.shape[0], generator=_random.generator(dev),
                           device=dev)
    x._data = x._data[perm]


def multinomial(n, pvals, size=None):
    """Counts of ``n`` draws over the categories ``pvals``, one row of
    counts a draw of ``size`` (int64)."""
    pv = pvals._data if isinstance(pvals, NDArray) else \
        _torch.as_tensor(_onp.asarray(pvals, dtype=_onp.float64))
    dev = pv.device if isinstance(pvals, NDArray) else \
        current_context().device
    pv = pv.to(dev, _torch.float64)
    shp = _size_to_shape(size)
    rows = int(_onp.prod(shp)) if shp else 1
    idx = _torch.multinomial(pv.expand(rows, -1), n, replacement=True,
                             generator=_random.generator(dev))
    counts = _torch.zeros((rows, pv.shape[-1]), dtype=_torch.int64,
                          device=dev)
    counts.scatter_add_(1, idx, _torch.ones_like(idx))
    return _np(NDArray(counts.reshape(*shp, pv.shape[-1])))

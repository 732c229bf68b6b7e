"""NDArray: the imperative tensor.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py`` (reference
``include/mxnet/ndarray.h``).  An NDArray is a handle to one
``torch.Tensor`` (``_data``) on an explicit device; every op unwraps the
operands, calls torch and wraps the result (``ops.registry.apply_op``).
Device work is asynchronous on the CUDA stream; ``asnumpy``
synchronises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import resolve_dtype
from ..context import Context, context_of, current_context


def _to_tensor(value, dtype=None, ctx=None) -> torch.Tensor:
    """Coerce a tensor, NDArray, numpy array or python payload to a tensor
    on ``ctx`` (default: the current context) in ``dtype``."""
    if isinstance(value, NDArray):
        value = value._data
    if isinstance(value, torch.Tensor):
        device = ctx.device if ctx is not None else value.device
        return value.to(device=device, dtype=dtype)
    if dtype is None and isinstance(value, (list, tuple, float, int)):
        dtype = torch.float32  # MXNet: python payloads become float32
    device = (ctx or current_context()).device
    return torch.as_tensor(np.asarray(value), device=device).to(dtype=dtype)


class NDArray:
    """A tensor handle with MXNet NDArray semantics over ``torch.Tensor``."""

    __slots__ = ("_data", "__weakref__")

    __array_priority__ = 100.0

    def __init__(self, data, ctx=None, dtype=None):
        self._data = _to_tensor(data, resolve_dtype(dtype), ctx)

    # -- basic properties ----------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    # -- host sync -----------------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        """Blocking device→host copy.  numpy has no bfloat16, so a bf16
        array comes back as float32 (exact)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    # -- conversion / movement ----------------------------------------------
    def astype(self, dtype, copy=True):
        dt = resolve_dtype(dtype)
        if not copy and self.dtype == dt:
            return self
        return NDArray(self._data.to(dt, copy=True))

    def copy(self):
        return NDArray(self._data.clone())

    def as_in_context(self, ctx: Context):
        if ctx == self.context:
            return self
        return NDArray(self._data.to(ctx.device))

    # -- arithmetic ----------------------------------------------------------
    def _binary(self, other, fn, name, reflected=False):
        from ..ops.registry import apply_op

        if isinstance(other, NDArray):
            if reflected:
                return apply_op(lambda a, b: fn(b, a), self, other, name=name)
            return apply_op(fn, self, other, name=name)
        if reflected:
            return apply_op(lambda a: fn(other, a), self, name=name)
        return apply_op(lambda a: fn(a, other), self, name=name)

    def __add__(self, o):
        return self._binary(o, torch.add, "add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, torch.sub, "sub")

    def __rsub__(self, o):
        return self._binary(o, torch.sub, "rsub", reflected=True)

    def __mul__(self, o):
        return self._binary(o, torch.mul, "mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, torch.true_divide, "div")

    def __rtruediv__(self, o):
        return self._binary(o, torch.true_divide, "rdiv", reflected=True)

    def __neg__(self):
        return NDArray(-self._data)

    # -- indexing ------------------------------------------------------------
    @staticmethod
    def _raw_key(key):
        """Unwrap NDArray keys; float index arrays (argmax returns float32
        indices, as in the reference) are cast to int64."""
        def one(k):
            if isinstance(k, NDArray):
                k = k._data
            if isinstance(k, torch.Tensor) and k.is_floating_point():
                k = k.long()
            return k

        if isinstance(key, tuple):
            return tuple(one(k) for k in key)
        return one(key)

    def __getitem__(self, key):
        return NDArray(self._data[NDArray._raw_key(key)])

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

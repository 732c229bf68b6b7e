"""NDArray: the imperative tensor.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py`` (reference
``include/mxnet/ndarray.h``).  An NDArray is a handle to one
``torch.Tensor`` (``_data``) on an explicit device; every op unwraps the
operands, calls torch and wraps the result (``ops.registry.apply_op``).
Device work is asynchronous on the CUDA stream; ``asnumpy``,
``asscalar`` and ``wait_to_read`` synchronise, each counted as a
``host_sync`` by telemetry, and each array made registers its storage
with ``telemetry.memwatch`` while that is on.  ``attach_grad`` makes the
array a variable of the autograd tape (``autograd.py``); its gradient
buffer has the array's dtype and device and is allocated at the first
read or backward.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, resolve_dtype
from ..context import Context, context_of, current_context
from ..parallel.local import is_dtensor as _is_dtensor
from .. import telemetry
from ..telemetry import memwatch as _mw


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
    # np.array copies, as MXNet's nd.array does: on the host the tensor
    # must not share memory with the caller's array
    return torch.as_tensor(np.array(value), device=device).to(dtype=dtype)


def creation_place(raw, ctx=None):
    """``raw`` placed for a newly created array: on ``ctx``, else the
    current context (the reference's placement helper; under an active
    mesh the port's ops replicate plain operands themselves,
    ``parallel.local.replicate_plain``)."""
    return raw.to((ctx or current_context()).device)


class NDArray:
    """A tensor handle with MXNet NDArray semantics over ``torch.Tensor``."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    __array_priority__ = 100.0

    def __init__(self, data, ctx=None, dtype=None):
        self._data = _to_tensor(data, resolve_dtype(dtype), ctx)
        self._grad = None
        self._grad_req = "null"
        if _mw._enabled:
            _mw.track(self._data)

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

    ctx = context

    @property
    def stype(self):
        """Storage type: ``"default"`` (dense); the sparse types are
        ``ndarray/sparse.py``'s."""
        return "default"

    def tostype(self, stype):
        """This array in storage ``stype``: ``"default"`` is itself,
        ``"row_sparse"`` and ``"csr"`` a cast (``sparse.cast_storage``)."""
        if stype == "default":
            return self
        from . import sparse

        return sparse.cast_storage(self, stype)

    # -- host sync -----------------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        """Blocking device→host copy, a new array on every device (a CPU
        tensor's own memory is never shared: the optimizers and BatchNorm
        update in place).  numpy has no bfloat16, so a bf16 array comes
        back as float32 (exact).  An array over a mesh (a DTensor) comes
        back whole: every rank gets the global value (a collective)."""
        telemetry.count("host_sync")
        t = self._data.detach()
        if _is_dtensor(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        try:
            return t.to("cpu", copy=True).numpy()
        except Exception as exc:
            if _mw._enabled:
                _mw.annotate_oom(exc, context="asnumpy")
            raise

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def wait_to_read(self):
        """Block until the value is computed."""
        telemetry.count("host_sync")
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def wait_to_write(self):
        """Block until pending writes to the array have run (reference
        ``wait_to_write``): the card's queue is in order, so this is
        ``wait_to_read``."""
        return self.wait_to_read()

    # -- conversion / movement ----------------------------------------------
    def astype(self, dtype, copy=True):
        dt = resolve_dtype(dtype)
        if not copy and self.dtype == dt:
            return self
        return NDArray(self._data.to(dt, copy=True))

    def copy(self):
        return NDArray(self._data.clone())

    def as_nd_ndarray(self):
        return self

    def asnative(self):
        """The ``torch.Tensor`` (reference ``asnative``: the backend's own
        array)."""
        return self._data

    def as_in_context(self, ctx: Context):
        """This array on ``ctx`` (itself if it is there).  A copy from
        page-locked host memory to a card does not block the host (as
        MXNet's copies do not); torch's pinned allocator keeps the source
        until the copy has run."""
        if ctx == self.context:
            return self
        t = self._data
        async_ok = ctx.device.type == "cuda" and not t.is_cuda and \
            t.is_pinned()
        return NDArray(t.to(ctx.device, non_blocking=async_ok))

    as_in_ctx = as_in_context

    # -- arithmetic ----------------------------------------------------------
    def _binary(self, other, fn, name, reflected=False):
        from ..ops.registry import apply_op
        from . import sparse

        if isinstance(other, sparse.BaseSparseNDArray):
            canon = {"add": "add", "sub": "subtract", "mul": "multiply",
                     "div": "divide"}.get(name, name)
            if reflected:
                return sparse.dispatch_binary(canon, fn, other, self)
            return sparse.dispatch_binary(canon, fn, self, other)
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

    def __floordiv__(self, o):
        return self._binary(o, torch.floor_divide, "floor_divide")

    def __mod__(self, o):
        return self._binary(o, torch.remainder, "mod")

    def __rmod__(self, o):
        return self._binary(o, torch.remainder, "rmod", reflected=True)

    def __pow__(self, o):
        return self._binary(o, torch.pow, "power")

    def __rpow__(self, o):
        return self._binary(o, torch.pow, "rpower", reflected=True)

    def __matmul__(self, o):
        from .. import ndarray as nd

        return nd.dot(self, o)

    def __neg__(self):
        from ..ops.registry import apply_op

        return apply_op(torch.neg, self, name="negative")

    def __abs__(self):
        from .. import ndarray as nd

        return nd.abs(self)

    # in-place forms rebind the handle to the result (a recorded result
    # stays on the tape), as the reference's do
    def __iadd__(self, o):
        self._data = (self + o)._data
        return self

    def __isub__(self, o):
        self._data = (self - o)._data
        return self

    def __imul__(self, o):
        self._data = (self * o)._data
        return self

    def __itruediv__(self, o):
        self._data = (self / o)._data
        return self

    # comparisons: 0/1 in the left operand's dtype (``ops/elemwise.py``)
    def _cmp(self, o, name):
        from .. import ndarray as nd

        if not isinstance(o, (NDArray, int, float, bool)):
            return NotImplemented
        return getattr(nd, name)(self, o)

    def __eq__(self, o):
        return self._cmp(o, "equal")

    def __ne__(self, o):
        return self._cmp(o, "not_equal")

    def __gt__(self, o):
        return self._cmp(o, "greater")

    def __ge__(self, o):
        return self._cmp(o, "greater_equal")

    def __lt__(self, o):
        return self._cmp(o, "lesser")

    def __le__(self, o):
        return self._cmp(o, "lesser_equal")

    __hash__ = object.__hash__  # identity hash despite elementwise __eq__

    def __bool__(self):
        if self.size != 1:
            raise MXNetError("the truth value of an NDArray with more than "
                             "one element is ambiguous")
        return bool(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    @property
    def T(self):
        return self.transpose()

    def item(self):
        return self.asscalar()

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, whose handle takes a copy) or
        onto a context (a new NDArray)."""
        if isinstance(other, Context):
            return NDArray(self._data.to(other.device, copy=True))
        other._data = self._data.to(other._data.device, dtype=other.dtype,
                                    copy=True)
        return other

    # -- method forms of ops (delegate to the nd namespace) ------------------
    def reshape(self, *shape, **kwargs):
        """Reshape with the reference's codes (0, -1, -2, -3, -4)."""
        from .. import ndarray as nd

        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return nd.reshape(self, shape=shape, **kwargs)

    def sum(self, axis=None, keepdims=False, **kwargs):
        from .. import ndarray as nd

        return nd.sum(self, axis=axis, keepdims=keepdims, **kwargs)

    def mean(self, axis=None, keepdims=False, **kwargs):
        from .. import ndarray as nd

        return nd.mean(self, axis=axis, keepdims=keepdims, **kwargs)

    # -- autograd ------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable with a gradient buffer of its dtype
        on its device; detaches it from any recorded graph (reference
        ``attach_grad``)."""
        from .. import autograd

        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        autograd._mark(self, grad_req)

    @property
    def grad(self):
        """The gradient buffer (zeros until a backward writes it), or None
        when no gradient is attached."""
        if self._grad is None and self._grad_req != "null":
            self._grad = NDArray(torch.zeros_like(self._data))
        return self._grad

    def zero_grad(self):
        if self._grad is not None:
            self._grad._data = torch.zeros_like(self._grad._data)
            if _mw._enabled:
                _mw.track(self._grad._data)

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], [out_grad], retain_graph=retain_graph,
                          train_mode=train_mode)

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
        from ..ops.registry import apply_op

        key = NDArray._raw_key(key)
        return apply_op(lambda a: a[key], self, name="slice")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")


def _method(op, doc=None):
    def m(self, *args, **kwargs):
        from .. import ndarray as nd

        return getattr(nd, op)(self, *args, **kwargs)

    m.__name__ = op
    m.__doc__ = doc or f"``nd.{op}(self, ...)``."
    return m


for _op in ("reshape_like", "transpose", "swapaxes", "flatten",
            "expand_dims", "squeeze", "broadcast_to", "broadcast_like",
            "tile", "repeat", "flip", "nansum", "prod", "max", "min",
            "norm", "argmax", "argmin", "argsort", "sort", "topk", "clip",
            "abs", "sign", "exp", "log", "sqrt", "square", "sigmoid", "tanh",
            "relu", "softmax", "log_softmax", "dot", "one_hot", "take",
            "pick", "slice_axis", "split", "zeros_like", "ones_like"):
    setattr(NDArray, _op, _method(_op))


"""Gluon Parameter / ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference
``python/mxnet/gluon/parameter.py``).  A Parameter owns one NDArray whose
tensor is a ``torch.nn.Parameter`` on the first context it was
initialized on; unless ``grad_req`` is ``"null"`` that NDArray is an
autograd variable whose gradient buffer has the parameter's dtype and
device (allocated by the first backward or read).  Deferred
initialization (shape resolved at the first forward) is kept.
``set_data`` copies into the parameter's own tensor, so a CUDA graph
that captured it reads the new values; ``cast`` and a forced
re-initialization replace the tensor (a graph keyed on its address is
captured again).  Multi-device copies port with multi-GPU (ROADMAP
Queue 1 item 5).
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ..base import MXNetError, resolve_dtype
from ..context import Context, current_context
from ..ndarray import NDArray
from .. import initializer as init_mod


class DeferredInitializationError(MXNetError):
    """Raised when a deferred-init parameter's data is read before shape
    inference (reference: same name)."""


def _shape_known(shape):
    return shape is not None and all(s > 0 for s in shape)


class Parameter:
    """A trainable parameter (reference ``gluon.Parameter``)."""

    def __init__(self, name, grad_req="write", shape=None,
                 dtype=torch.float32, lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        # a non-differentiable parameter (BatchNorm's moving statistics)
        # never has a gradient: its grad_req is "null" whatever is asked
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = resolve_dtype(dtype)
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._data = None          # NDArray over a torch.nn.Parameter
        self._ctx_list = None
        self._deferred_init = None  # (init, ctx_list) pending shape

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req!r}")
        if not self._differentiable:
            req = "null"
        if self._grad_req != req:
            self._grad_req = req
            if self._data is not None:
                self._data.attach_grad(req)

    # -- initialization ------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate and initialize (reference ``Parameter.initialize``);
        deferred while the shape is unknown."""
        if self._data is not None and not force_reinit:
            return
        if default_init is None:
            default_init = init_mod.Uniform()
        if ctx is None:
            ctx = [current_context()]
        elif isinstance(ctx, Context):
            ctx = [ctx]
        self._ctx_list = list(ctx)
        chosen = init if init is not None else (self.init or default_init)
        chosen = init_mod.create(chosen)
        if not _shape_known(self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (chosen, list(ctx))
                return
            raise MXNetError(
                f"cannot initialize parameter {self.name!r}: shape "
                f"{self.shape} unknown and allow_deferred_init is False")
        self._init_impl(chosen, ctx)

    def _init_impl(self, initializer, ctx_list):
        tensor = torch.empty(self.shape, dtype=self.dtype,
                             device=ctx_list[0].device)
        self._data = NDArray(torch.nn.Parameter(
            tensor, requires_grad=self._grad_req != "null"))
        initializer(self.name, self._data)
        self._deferred_init = None
        if self._grad_req != "null":
            self._data.attach_grad(self._grad_req)

    def _finish_deferred_init(self, shape):
        """Complete a deferred init once the shape is known."""
        if self._deferred_init is None:
            return
        shape = tuple(int(s) for s in shape)
        if self.shape is not None and len(self.shape) == len(shape):
            for have, got in zip(self.shape, shape):
                if have > 0 and have != got:
                    raise MXNetError(
                        f"inferred shape {shape} incompatible with declared "
                        f"{self.shape} for parameter {self.name!r}")
        self.shape = shape
        initializer, ctx = self._deferred_init
        self._init_impl(initializer, ctx)

    def set_data(self, data):
        """Copy ``data`` (NDArray, tensor or array-like) into the
        parameter, in its dtype and on its device; a deferred
        initialization is finished first with ``data``'s shape."""
        src = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(data)
        if self._data is None and self._deferred_init is not None:
            self._finish_deferred_init(src.shape)
        self._check_initialized()
        if tuple(src.shape) != self.shape:
            raise MXNetError(
                f"set_data shape mismatch for {self.name!r}: "
                f"{tuple(src.shape)} vs {self.shape}")
        with torch.no_grad():
            self._data._data.copy_(src)

    # -- access --------------------------------------------------------------
    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"parameter {self.name!r} has deferred initialization "
                "pending shape inference; run a forward pass first")
        raise MXNetError(
            f"parameter {self.name!r} has not been initialized; call "
            ".initialize() (e.g. net.initialize())")

    def data(self, ctx=None):
        self._check_initialized()
        return self._data

    def grad(self, ctx=None):
        """The gradient buffer (reference ``Parameter.grad``)."""
        self._check_initialized()
        if self._grad_req == "null":
            raise MXNetError(f"cannot get gradient of {self.name!r}: "
                             "grad_req is 'null'")
        return self._data.grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._data is None and self._deferred_init is not None:
            return list(self._deferred_init[1])
        self._check_initialized()
        return list(self._ctx_list or [current_context()])

    def zero_grad(self):
        if self._data is not None:
            self._data.zero_grad()

    def cast(self, dtype):
        """Change the dtype; an initialized value is converted (the old
        tensor is released, so a model can be cast in place) and its
        gradient buffer starts again as zeros of the new dtype."""
        self.dtype = resolve_dtype(dtype)
        if self._data is not None:
            old = self._data._data
            self._data._data = torch.nn.Parameter(
                old.detach().to(self.dtype),
                requires_grad=old.requires_grad)
            if self._grad_req != "null":
                self._data.attach_grad(self._grad_req)

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")


class ParameterDict:
    """Prefix-namespaced parameter registry (reference
    ``gluon.ParameterDict``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def get(self, name, **kwargs):
        """Create-or-fetch ``prefix+name`` (shared dict consulted
        first)."""
        name = self._prefix + name
        param = self._params.get(name)
        if param is None and self._shared is not None:
            param = self._shared._params.get(name)
            if param is not None:
                self._params[name] = param
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k!r}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, force_reinit=False):
        if init is None:
            init = init_mod.Uniform()
        for p in self._params.values():
            p.initialize(None, ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

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
captured again).  Over a mesh the tensor is a ``DTensor`` leaf
(``parallel.place_params``); one process holds one device, so a
Parameter has one copy.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..base import MXNetError, resolve_dtype
from ..context import Context, current_context
from ..ndarray import NDArray
from ..parallel.local import is_dtensor
from ..telemetry import memwatch as _mw
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
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
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
        # storage types, validated as the reference does; the data stays
        # dense, and a "row_sparse" grad_stype (Embedding(sparse_grad=
        # True)) keeps the parameter out of step fusion's graph
        if stype not in ("default", "row_sparse", "csr"):
            raise MXNetError(f"invalid stype {stype!r}")
        self._stype = stype
        self._grad_stype = grad_stype
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
        self._adopt()

    def _adopt(self):
        """Label the data holder in memwatch's ledger, so its post-mortem
        names the storages of the value and the gradient (``<name>.grad``)
        by parameter across rebinds (``cast``, the gradient buffers
        backward binds)."""
        if not _mw._enabled:
            return
        _mw.track(self._data._data, owner=self.name)
        _mw.adopt(self._data, self.name)

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
        parameter, in its dtype and on its device (over a mesh: in its
        placement, each rank taking its piece of ``data``); a deferred
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
        dst = self._data._data
        if is_dtensor(dst):  # over a mesh: keep the placement
            from torch.distributed.tensor import distribute_tensor

            src = distribute_tensor(
                src.detach().to(dst.device_mesh.device_type),
                dst.device_mesh, dst.placements, src_data_rank=None)
        with torch.no_grad():
            dst.copy_(src)

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

    def list_data(self):
        """The value on each context: one (one device a process)."""
        self._check_initialized()
        return [self._data]

    def reset_ctx(self, ctx):
        """Move the value to ``ctx`` (a Context or a one-element list);
        its gradient buffer starts again."""
        if isinstance(ctx, Context):
            ctx = [ctx]
        self._ctx_list = list(ctx)
        if self._data is not None:
            old = self._data._data
            self._data._data = torch.nn.Parameter(
                old.detach().to(ctx[0].device),
                requires_grad=old.requires_grad)
            if self._grad_req != "null":
                self._data.attach_grad(self._grad_req)
            self._adopt()
        elif self._deferred_init is not None:
            self._deferred_init = (self._deferred_init[0], list(ctx))

    @property
    def dtype_np(self):
        """The dtype (reference ``dtype_np``)."""
        return self.dtype

    @property
    def stype(self):
        """The storage type given at construction (the data is dense)."""
        return self._stype

    def var(self):
        """The parameter as a symbol variable (MXNet's ``Parameter.var``:
        its name, shape, dtype and multipliers; the JAX package's raises
        ``NotImplementedError``)."""
        from .. import symbol

        shape = self.shape if _shape_known(self.shape) else None
        return symbol.var(self.name, shape=shape, dtype=self.dtype,
                          lr_mult=self.lr_mult, wd_mult=self.wd_mult)

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
            self._adopt()

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")


class Constant(Parameter):
    """A non-trainable parameter holding ``value`` (reference
    ``gluon.Constant``)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = NDArray(torch.as_tensor(np.asarray(value,
                                                       dtype=np.float32)))
        self.value = value

        class _ConstInit(init_mod.Initializer):
            def _init_weight(self, _name, arr):
                with torch.no_grad():
                    arr._data.copy_(value._data)

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_ConstInit(),
                         differentiable=False)


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

    def get_constant(self, name, value=None):
        """Create-or-fetch the constant ``prefix+name`` (reference
        ``get_constant``)."""
        name = self._prefix + name
        param = self._params.get(name)
        if param is None and self._shared is not None:
            param = self._shared._params.get(name)
            if param is not None:
                self._params[name] = param
        if param is None:
            if value is None:
                raise MXNetError(
                    f"no constant named {name!r}; provide a value")
            param = self._params[name] = Constant(name, value)
        return param

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = init_mod.Uniform()
        for p in self._params.values():
            p.initialize(None, ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set attribute ``name`` of every parameter (e.g. ``grad_req``,
        ``lr_mult``)."""
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Write the values to an MXNet ``.params`` file, by name (with
        ``strip_prefix`` taken off)."""
        from .. import ndarray as nd

        arrays = {}
        for name, p in self._params.items():
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arrays[name] = p.data()
        nd.save(filename, arrays)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Read a ``.params`` file into the parameters by name
        (``arg:``/``aux:`` prefixes dropped, ``restore_prefix`` put
        before each name); an uninitialized parameter takes the file's
        shape."""
        from .. import ndarray as nd

        loaded = nd.load(filename)
        if isinstance(loaded, list):
            raise MXNetError("parameter file must contain a dict of arrays")
        loaded = {restore_prefix + k.removeprefix("arg:").removeprefix(
            "aux:"): v for k, v in loaded.items()}
        if not allow_missing:
            for name in self._params:
                if name not in loaded:
                    raise MXNetError(
                        f"parameter {name!r} missing from file {filename!r}")
        for name, value in loaded.items():
            if name not in self._params:
                if ignore_extra:
                    continue
                raise MXNetError(
                    f"file {filename!r} has parameter {name!r} not present "
                    "in this ParameterDict (set ignore_extra=True to skip)")
            p = self._params[name]
            if p._data is None and p._deferred_init is None:
                p.shape = value.shape
                p.initialize(ctx=ctx or [current_context()],
                             default_init=init_mod.Zero())
            p.set_data(value)

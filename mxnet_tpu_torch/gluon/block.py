"""Gluon Block / HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference
``python/mxnet/gluon/block.py``): name scopes and prefixes, parameter
collection by prefix and by structure, ``initialize`` and ``cast``.

``hybridize()`` is accepted and the block runs eagerly: a compiled graph
per input signature (a CUDA graph here) is later work (ROADMAP Queue 1);
``hybridize(remat=...)`` raises until rematerialization ports.  A forward
runs with torch's gradient mode set to ``autograd.is_recording()``, so
inference builds no autograd graph.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

from ..base import MXNetError
from .. import autograd as ag
from .parameter import (Parameter, ParameterDict,
                        DeferredInitializationError)


class _NameManager:
    _lock = threading.Lock()
    _counters = {}

    @staticmethod
    def get(hint):
        with _NameManager._lock:
            n = _NameManager._counters.get(hint, 0)
            _NameManager._counters[hint] = n + 1
        return f"{hint}{n}"


class _BlockScope:
    """Per-block naming scope; ``with self.name_scope():`` prefixes
    children and parameters (reference ``_BlockScope``)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _NameManager.get(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block._params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block:
    """Base class of all layers and models (reference ``gluon.Block``)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return self._scope

    def collect_params(self, select=None):
        """All parameters of this block and its children, optionally
        filtered by regex (reference ``Block.collect_params``)."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self.params.items()
                        if pattern.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """Parameters keyed by structural name (``model.layers.0....``),
        independent of the counter-based prefixes."""
        if prefix:
            prefix += "."
        ret = {prefix + n: p for n, p in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context, which is ``gpu(0)`` unless a ``with mx.cpu():`` is
        active)."""
        self.collect_params().initialize(init, ctx, force_reinit)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)
        return self

    def hybridize(self, active=True, **kwargs):
        """Accepted for the reference API; the block runs eagerly (a
        compiled graph per signature is later work, ROADMAP Queue 1).
        ``remat`` raises: activation rematerialization is not ported."""
        if kwargs.get("remat"):
            raise MXNetError(
                "hybridize(remat=...) (activation rematerialization) is not "
                "ported yet (ROADMAP.md, Queue 1, \"Left out of slice 2\")")

    def __call__(self, *args):
        with ag.grad_mode():
            return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError(
            f"{type(self).__name__} must implement forward")


class HybridBlock(Block):
    """A block whose forward is ``hybrid_forward(F, ...)`` with ``F`` the
    ``mxnet_tpu_torch.ndarray`` namespace (reference
    ``gluon.HybridBlock``)."""

    def infer_shape(self, *args):
        raise MXNetError(
            f"{type(self).__name__} has deferred-init parameters but does "
            "not implement infer_shape(); declare in_units or override "
            "infer_shape")

    def _param_data(self, *args):
        """This block's parameter values by attribute name, finishing a
        deferred initialization from the inputs ``args`` first."""
        try:
            return {k: p.data() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init(p.shape or ())
            return {k: p.data() for k, p in self._reg_params.items()}

    def forward(self, *args):
        from .. import ndarray as nd

        return self.hybrid_forward(nd, *args, **self._param_data(*args))

    def hybrid_forward(self, F, *args, **params):
        raise NotImplementedError(
            f"{type(self).__name__} must implement hybrid_forward")

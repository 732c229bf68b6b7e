"""Gluon Block / HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference
``python/mxnet/gluon/block.py``): name scopes and prefixes, parameter
collection by prefix and by structure, ``initialize``, ``cast``,
``save_parameters``/``load_parameters`` (the reference's ``.params``
files, keyed by structural name) and ``hybridize``.

``hybridize()`` gives the block a ``CachedOp`` (reference ``CachedOp``
and ``_CachedGraph``): outside ``autograd.record()`` and on a CUDA card,
the first call of each input signature (shapes, dtypes, device, training
mode, parameter shapes and dtypes) runs the forward eagerly and captures
it into a CUDA graph (``cuda_graph.py``), and every later call of that
signature copies its inputs into the graph's and replays it.  A graph is
keyed on the parameters' addresses too: after ``cast`` or a forced
re-initialization moves a parameter, the next call captures again.
Under ``autograd.record()`` the block runs eagerly (training capture is
``FusedTrainStep``'s); on the CPU it always runs eagerly.  Graphing a
recorded forward and ``hybridize(remat=...)`` are left out of slice 7
(ROADMAP).  A forward runs with torch's gradient mode set to
``autograd.is_recording()``, so inference builds no autograd graph.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

import torch

from ..base import MXNetError
from .. import autograd as ag
from .. import cuda_graph
from .. import engine
from ..context import current_context
from .parameter import (Parameter, ParameterDict,
                        DeferredInitializationError)


def _left_out(what):
    return MXNetError(f"{what} is not ported yet (ROADMAP.md, Queue 1, "
                      "\"Left out of slice 7\")")


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
        """Hybridize every HybridBlock below this one (reference
        semantics: a plain Block itself runs eagerly).  ``remat`` raises:
        activation rematerialization waits for the memory-policy tiers
        (ROADMAP "Left out of slice 7")."""
        if kwargs.get("remat"):
            raise _left_out("hybridize(remat=...) (activation "
                            "rematerialization)")
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def save_parameters(self, filename, deduplicate=False):
        """Save the parameters keyed by structural name (``"0.weight"``,
        ...), in the reference's ``.params`` format: the files
        interchange with its ``load_parameters`` (bf16 is written as
        f32, as the reference writes it)."""
        from .. import ndarray as nd

        params = self._collect_params_with_prefix()
        nd.save(filename, {key: val.data() for key, val in params.items()
                           if val._data is not None or
                           val._deferred_init is None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a ``.params`` file written by ``save_parameters`` here or
        in the reference (or a legacy ``ParameterDict.save`` file with
        full-prefix ``arg:``/``aux:`` names) into the parameters, in
        place, each in its own dtype unless ``cast_dtype`` with
        ``dtype_source="saved"`` takes the file's."""
        from .. import ndarray as nd

        loaded = nd.load(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any("." in k for k in loaded) and any(
                "." in k for k in params):
            stripped = {k.removeprefix("arg:").removeprefix("aux:"): v
                        for k, v in loaded.items()}
            pdict = self.collect_params()
            for name, value in stripped.items():
                if name in pdict:
                    pdict[name].set_data(value)
                elif not ignore_extra:
                    raise MXNetError(
                        f"parameter {name!r} from {filename!r} not found")
            return
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError(
                        f"parameter {name!r} missing in file {filename!r}")
        for name, value in loaded.items():
            if name not in params:
                if ignore_extra:
                    continue
                raise MXNetError(
                    f"file {filename!r} contains parameter {name!r} not in "
                    "this block (set ignore_extra=True to skip)")
            p = params[name]
            if cast_dtype and dtype_source == "saved" and \
                    p.dtype != value.dtype:
                p.cast(value.dtype)
            if p._data is None and p._deferred_init is None:
                p.shape = value.shape
                p.initialize(ctx=ctx or [current_context()])
            p.set_data(value)

    def __call__(self, *args):
        with ag.grad_mode():
            return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError(
            f"{type(self).__name__} must implement forward")


class CachedOp:
    """Per-signature CUDA graphs of a hybridized block (reference
    ``CachedOp``).  ``static_alloc``/``static_shape`` are accepted: a
    graph already keeps its memory and its shapes."""

    def __init__(self, block, static_alloc=False, static_shape=False,
                 **flags):
        self.block = block
        self.flags = dict(static_alloc=static_alloc,
                          static_shape=static_shape, **flags)
        self._graphs = {}
        self._pool = None
        self._hits = 0
        self._misses = 0
        self._recorded = 0

    def cache_stats(self):
        """``{"hits", "misses", "signatures"}`` as in the reference, and
        ``"recorded"``: calls under ``autograd.record()``, which ran
        eagerly."""
        return {"hits": self._hits, "misses": self._misses,
                "signatures": len(self._graphs),
                "recorded": self._recorded}

    def _inline(self, args):
        with cuda_graph.scope():
            return self.block._imperative_forward(*args)

    def __call__(self, *args):
        from ..ndarray import NDArray

        if ag.is_recording():
            self._recorded += 1
            return self._inline(args)
        for a in args:
            if not isinstance(a, NDArray):
                raise MXNetError("hybridized blocks take NDArray inputs "
                                 f"only, got {type(a)}")
        params = list(self.block.collect_params().values())
        if any(p._data is None for p in params):
            # deferred shapes: one eager pass resolves them (the reference
            # builds its graph after the same pass)
            out = self._inline(args)
            if any(p._data is None for p in params):
                return out
        sig = (tuple((a.shape, a.dtype, a._data.device) for a in args),
               ag.is_training(),
               tuple((p.shape, p.dtype) for p in params))
        entry = self._graphs.get(sig)
        if not all(a._data.is_cuda for a in args) or \
                not all(p._data._data.is_cuda for p in params):
            if entry is None:
                self._misses += 1
                self._graphs[sig] = True
            else:
                self._hits += 1
            return self._inline(args)
        # addresses within a signature, which holds shapes and dtypes
        ptrs = tuple(p._data._data.data_ptr() for p in params)
        if entry is None or entry[0] != ptrs:
            self._misses += 1
            out, self._graphs[sig] = self._capture(args, ptrs)
            return out
        self._hits += 1
        _, statics, graph = entry
        for s, a in zip(statics, args):
            s.copy_(a._data)
        graph.replay()
        return _map_out(graph.outputs, lambda t: NDArray(t.clone()))

    def _capture(self, args, ptrs):
        """Run the forward eagerly (the warm-up, whose result this call
        returns) and capture it on static copies of the inputs."""
        from ..ndarray import NDArray

        statics = [a._data.clone() for a in args]
        out = cuda_graph.warmup(lambda: self.block._imperative_forward(
            *args))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = cuda_graph.capture(
            lambda: _map_out(self.block._imperative_forward(
                *(NDArray(s) for s in statics)), lambda o: o._data),
            pool=self._pool)
        return out, (ptrs, statics, graph)


def _map_out(out, fn):
    """``fn`` over an output that is an NDArray (or tensor) or a tuple or
    list of them."""
    if isinstance(out, (tuple, list)):
        return type(out)(fn(o) for o in out)
    return fn(out)


class HybridBlock(Block):
    """A block whose forward is ``hybrid_forward(F, ...)`` with ``F`` the
    ``mxnet_tpu_torch.ndarray`` namespace (reference
    ``gluon.HybridBlock``); ``hybridize()`` runs it through a
    ``CachedOp``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Run this block (and every HybridBlock below it) through CUDA
        graphs, one per input signature; ``active=False`` turns it off."""
        if kwargs.get("remat"):
            raise _left_out("hybridize(remat=...) (activation "
                            "rematerialization)")
        self._active = bool(active)
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        self._cached_op = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def cache_stats(self):
        """The ``CachedOp``'s counters (all 0 before the first call)."""
        if self._cached_op is None:
            return {"hits": 0, "misses": 0, "signatures": 0, "recorded": 0}
        return self._cached_op.cache_stats()

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

    def _imperative_forward(self, *args):
        from .. import ndarray as nd

        return self.hybrid_forward(nd, *args, **self._param_data(*args))

    def forward(self, *args):
        if self._active and not cuda_graph.capturing() and \
                not engine.is_naive():
            if self._cached_op is None:
                self._cached_op = CachedOp(self, **self._flags)
            return self._cached_op(*args)
        return self._imperative_forward(*args)

    def hybrid_forward(self, F, *args, **params):
        raise NotImplementedError(
            f"{type(self).__name__} must implement hybrid_forward")

"""Gluon Block / HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference
``python/mxnet/gluon/block.py``): name scopes and prefixes, parameter
collection by prefix and by structure, ``initialize``, ``cast``,
``save_parameters``/``load_parameters`` (the reference's ``.params``
files, keyed by structural name) and ``hybridize``.

``hybridize()`` gives the block a ``CachedOp`` (reference ``CachedOp``
and ``_CachedGraph``): outside ``autograd.record()`` and on a CUDA card,
the first call of each input signature (shapes, dtypes, device, training
mode, amp's dtype, parameter shapes and dtypes, the numerics mode; an
input may be None)
runs the forward eagerly and captures it into a CUDA graph
(``cuda_graph.py``), and every later call of that
signature copies its inputs into the graph's and replays it.  A graph is
keyed on the parameters' addresses too: after ``cast`` or a forced
re-initialization moves a parameter, the next call captures again.
Under ``autograd.record()`` the block runs eagerly (training capture is
``FusedTrainStep``'s); on the CPU it always runs eagerly.  Over a mesh
(``DTensor`` parameters or inputs) the graph holds the forward's
collectives and is keyed on each rank's local pieces; every NCCL group
is warmed by an eager collective before the capture.  Graphing a
recorded forward is left out of slice 7 (ROADMAP).  A forward runs with
torch's gradient mode set to ``autograd.is_recording()``, so inference
builds no autograd graph.

``hybridize(remat=<tier>)`` (``"none"``, ``"dots"``, ``"layer"`` or
``"auto"``, with ``remat_margin=``; ``memory.policy``) rematerializes a
recorded forward: the block runs under ``policy.checkpoint_wrap``, so its
backward recomputes what the tier does not save.  The tier is resolved
once a signature, ``"auto"`` by the planner (the cheapest tier that fits
the device budget; ``cachedop.remat_auto.<tier>`` counts the picks).
"""
from __future__ import annotations

import math
import re
import threading
from collections import OrderedDict

import torch

from ..base import MXNetError
from .. import amp
from .. import autograd as ag
from .. import cuda_graph
from .. import engine
from .. import telemetry
from ..telemetry import costs as _costs
from ..telemetry import memwatch as _mw
from ..telemetry import numerics as _numerics
from ..telemetry import retrace as _retrace
from ..parallel.local import any_dtensor, local
from ..context import current_context
from .parameter import (Parameter, ParameterDict,
                        DeferredInitializationError)
from ..context import Context  # noqa: F401,E402
from ..ndarray import NDArray  # noqa: F401,E402
from .utils import HookHandle  # noqa: F401,E402


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
        self._forward_pre_hooks = OrderedDict()
        self._forward_hooks = OrderedDict()
        self._observers = OrderedDict()

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
        semantics: a plain Block itself runs eagerly)."""
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
        # tuple(): a hook may detach itself while they run
        for hook in tuple(self._forward_pre_hooks.values()):
            hook(self, args)
        with ag.grad_mode():
            out = self.forward(*args)
        for hook in tuple(self._forward_hooks.values()):
            hook(self, args, out)
        for obs in tuple(self._observers.values()):
            obs(self, args, out)
        return out

    def register_forward_pre_hook(self, hook):
        """Run ``hook(block, inputs)`` before each ``forward`` (reference
        ``Block.register_forward_pre_hook``); returns a ``HookHandle``."""
        from .utils import HookHandle

        handle = HookHandle()
        handle.attach(self._forward_pre_hooks, hook)
        return handle

    def register_forward_hook(self, hook):
        """Run ``hook(block, inputs, outputs)`` after each ``forward``
        (reference ``Block.register_forward_hook``)."""
        from .utils import HookHandle

        handle = HookHandle()
        handle.attach(self._forward_hooks, hook)
        return handle

    def _register_observer(self, hook):
        """Run ``hook(block, inputs, outputs)`` after each forward, like a
        forward hook, but as an observer that changes nothing: a fused
        1×1 conv + BatchNorm + ReLU run stays fused and reports each of
        its blocks' outputs (``monitor.Monitor``)."""
        from .utils import HookHandle

        handle = HookHandle()
        handle.attach(self._observers, hook)
        return handle

    def apply(self, fn):
        """``fn`` on every child, depth first, then on this block
        (reference ``Block.apply``)."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def summary(self, *inputs):
        """Print each block's type, name and parameter count, indented by
        depth, and the total (reference ``Block.summary``)."""
        rows = []

        def walk(block, depth):
            n_params = sum(
                math.prod(p.shape) for p in block._reg_params.values()
                if p.shape is not None and all(s > 0 for s in p.shape))
            rows.append(("  " * depth + type(block).__name__,
                         block.name, n_params))
            for c in block._children.values():
                walk(c, depth + 1)

        walk(self, 0)
        total = sum(r[2] for r in rows)
        lines = [f"{'Layer':<40}{'Name':<28}{'Params':>12}", "-" * 80]
        lines += [f"{r[0]:<40}{r[1]:<28}{r[2]:>12}" for r in rows]
        lines += ["-" * 80, f"Total params: {total}"]
        print("\n".join(lines))

    def forward(self, *args):
        raise NotImplementedError(
            f"{type(self).__name__} must implement forward")


class CachedOp:
    """Per-signature CUDA graphs of a hybridized block (reference
    ``CachedOp``).  ``static_alloc``/``static_shape`` are accepted: a
    graph already keeps its memory and its shapes.

    Telemetry, under the reference's names: ``cachedop.cache_hit`` and
    ``cachedop.cache_miss`` for every call (a recorded call's signature
    is kept apart from the graphs' keys), ``cachedop.compile`` for a
    signature's first call (on a card, the one that captures its graph),
    the ``cachedop.build``/``compile``/``replay`` spans, a
    ``retrace.observe`` and a ``costs.note`` on each miss.  With
    numerics on, the taps of a captured forward are graph outputs,
    queued after each replay, and a recorded call queues each
    parameter's ``grad.<name>`` statistics after its backward
    (``autograd.after_backward``) on a step whose statistics will be
    harvested."""

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
        self._recorded_sigs = set()
        self._eager = 0
        self._remat_tiers = {}  # signature -> resolved remat tier

    def cache_stats(self):
        """``{"hits", "misses", "signatures"}`` as in the reference, and
        ``"recorded"``: calls under ``autograd.record()``, which ran
        eagerly.  Once a signature's forward has reached a host-code op
        (``nd.Custom``), ``"eager"`` counts its calls, each run eagerly
        (a graph would replay the first call's result)."""
        stats = {"hits": self._hits, "misses": self._misses,
                 "signatures": len(self._graphs),
                 "recorded": self._recorded}
        if self._eager:
            stats["eager"] = self._eager
        return stats

    def _first_run(self, run):
        """``run()`` for a signature's first call; its entry is
        ``"eager"`` when the forward ran a host-code op."""
        n = cuda_graph.host_ops()
        out = run()
        if cuda_graph.host_ops() != n:
            self._eager += 1
            return out, "eager"
        return out, None

    def _inline(self, args):
        with cuda_graph.scope():
            return self.block._imperative_forward(*args)

    def _remat_tier(self, args, params):
        """The recorded forward's remat tier for this signature (resolved
        at its first call; "none" while deferred shapes are unresolved)."""
        if not self.flags.get("remat") or \
                any(p._data is None for p in params):
            return "none"
        sig = _signature(args, params)
        tier = self._remat_tiers.get(sig)
        if tier is None:
            tier = self._remat_tiers[sig] = self._resolve_remat(args, params)
        return tier

    def _resolve_remat(self, args, params):
        """The remat tier this signature runs with.  ``remat="auto"``
        asks the planner for the cheapest tier that fits the device
        budget (margin via ``remat_margin=``); a concrete tier (or the
        historical bool) passes through."""
        from .. import parallel
        from ..memory import policy as _mem_policy

        tier = _mem_policy.normalize(self.flags.get("remat", False))
        if tier != "auto":
            if tier != "none":
                _mem_policy.record_policy(tier, "forced")
            return tier
        batch_b = sum(a._data.numel() * a._data.element_size()
                      for a in args if a is not None)
        tier, _plan = _mem_policy.auto_tier(
            {f"p{i}": (p.shape, p.dtype) for i, p in enumerate(params)},
            mesh=parallel.current_mesh(), batch_bytes=batch_b,
            margin=self.flags.get("remat_margin"))
        telemetry.count(f"cachedop.remat_auto.{tier}")
        return tier

    def _forward(self, args, tier):
        """The eager forward, under the remat tier's checkpoint."""
        if tier == "none":
            return self._inline(args)
        from ..memory.policy import checkpoint_wrap

        return checkpoint_wrap(lambda *a: self._inline(a), tier)(*args)

    def __call__(self, *args):
        """The block's outputs as the classic ``NDArray``, on every route
        (the reference's compiled graph returns that type, also for a
        forward that makes ``mx.np`` arrays)."""
        return _map_out(self._call(*args), _classic)

    def _site(self):
        return f"mxnet_tpu_torch.gluon.block:CachedOp.__call__ " \
            f"({self.block.name})"

    def _miss(self, sig, args, params, ptrs=None, recorded=False):
        """A signature's first call (or a moved parameter): the counters
        (``cache_stats`` keeps recorded calls apart) and the sanitizer's
        observation."""
        if not recorded:
            self._misses += 1
        telemetry.count("cachedop.cache_miss")
        if _retrace._enabled:
            _retrace.observe("cachedop", id(self),
                             _components(sig, args, params, ptrs),
                             site=self._site())

    def _hit(self):
        self._hits += 1
        telemetry.count("cachedop.cache_hit")

    def _call(self, *args):
        from ..ndarray import NDArray

        params = list(self.block.collect_params().values())
        if ag.is_recording():
            self._recorded += 1
            tier = self._remat_tier(args, params)
            if _QUIET_STATE.depth or not (
                    telemetry._enabled or _numerics._enabled or
                    _costs._enabled or _retrace._enabled):
                return self._forward(args, tier)
            return self._recorded_call(args, params, tier)
        for a in args:
            if a is not None and not isinstance(a, NDArray):
                raise MXNetError("hybridized blocks take NDArray (or None) "
                                 f"inputs only, got {type(a)}")
        if any(p._data is None for p in params):
            # deferred shapes: one eager pass resolves them (the reference
            # builds its graph after the same pass)
            out = self._inline(args)
            if any(p._data is None for p in params):
                return out
        arrays = [a for a in args if a is not None]
        sig = _signature(args, params)
        entry = self._graphs.get(sig)
        if entry == "eager":
            self._eager += 1
            return self._inline(args)
        if not all(a._data.is_cuda for a in arrays) or \
                not all(p._data._data.is_cuda for p in params):
            if entry is None:
                with telemetry.span("cachedop.build"):
                    self._miss(sig, args, params)
                with telemetry.span("cachedop.compile"), \
                        _costs.first("cachedop", (id(self), sig, "fwd")) as c:
                    out, eager = self._first_run(lambda: self._inline(args))
                self._graphs[sig] = eager or True
                telemetry.count("cachedop.compile")
                self._note_cost(sig, c)
                return out
            self._hit()
            with telemetry.span("cachedop.replay"):
                out = self._inline(args)
            self._note_cost(sig)
            return out
        # addresses within a signature, which holds shapes and dtypes
        # (each rank's local pieces under a mesh)
        ptrs = tuple(local(p._data._data).data_ptr() for p in params)
        if entry is None or entry[0] != ptrs:
            with telemetry.span("cachedop.build"):
                self._miss(sig, args, params, ptrs)
            with telemetry.span("cachedop.compile"):
                out, self._graphs[sig] = self._guarded(
                    lambda: self._capture(args, ptrs, sig))
            telemetry.count("cachedop.compile")
            return out
        self._hit()
        _, statics, graph, stat_names = entry
        with telemetry.span("cachedop.replay"):
            for s, a in zip(statics, args):
                if s is not None:
                    local(s).copy_(local(a._data))
            self._guarded(graph.replay)
        outputs = graph.outputs
        if stat_names:
            outputs, stats = outputs
            # one copy of the static stats: the next replay overwrites them
            _numerics.record_compiled(stat_names, stats.clone())
        self._note_cost(sig)
        return _map_out(outputs, lambda t: NDArray(t.clone()))

    def _guarded(self, run):
        """``run()``, an allocation failure turned into memwatch's
        post-mortem."""
        try:
            return run()
        except Exception as exc:
            if _mw._enabled:
                _mw.annotate_oom(
                    exc, context=f"CachedOp forward ({self.block.name})")
            raise

    def _note_cost(self, sig, counted=None, mode="fwd"):
        if _costs._enabled:
            _costs.note("cachedop", (id(self), sig, mode), counted,
                        site=self._site())

    def _recorded_call(self, args, params, tier="none"):
        """A call under ``autograd.record()`` with telemetry on: the block
        runs eagerly (training capture is ``FusedTrainStep``'s), with the
        counters, the sanitizer and the cost registry of a signature's
        first call, and the numerics tier's per-parameter ``grad.``
        statistics after the backward.  A call that finishes the
        parameters' deferred shapes is counted under the resolved
        signature (as the reference builds its graph after that pass)."""
        out = None
        if any(p._data is None for p in params):
            out = self._inline(args)
            if any(p._data is None for p in params):
                return out
        sig = _signature(args, params)
        first = sig not in self._recorded_sigs
        key = (id(self), sig, "fwd_rec")
        if first:
            self._recorded_sigs.add(sig)
            with telemetry.span("cachedop.build"):
                self._miss(sig, args, params, recorded=True)
        else:
            telemetry.count("cachedop.cache_hit")
        with telemetry.span("cachedop.compile" if first
                            else "cachedop.replay"), \
                _costs.first("cachedop", key) if out is None \
                else _costs._NULL as c:
            if out is None:
                out = self._guarded(lambda: self._forward(args, tier))
        if first:
            telemetry.count("cachedop.compile")
            if _retrace._enabled:
                _retrace.observe(
                    "cachedop_bwd", id(self.block),
                    {"params": _components(sig, args, params)["params"],
                     "training": sig[1], "remat": tier,
                     "numerics": sig[4]},
                    site=f"{self._site()[:-1]}, bwd)")
        self._note_cost(sig, c, mode="fwd_rec")
        stats = _numerics.harvesting()
        if stats or _costs._enabled:
            bwd_key = (id(self), sig, "bwd")
            ag.after_backward(
                id(self), _grad_hook(params, bwd_key, self._site(), stats),
                count=_costs._enabled and _costs.get("cachedop_bwd",
                                                     bwd_key) is None)
        return out

    def _capture(self, args, ptrs, sig):
        """Run the forward eagerly (the warm-up, whose result this call
        returns) and capture it on static copies of the inputs (a None
        input stays None).  The capture is thread-local: other threads
        (another server's scheduler, a client) may use the card while it
        runs.  With numerics on, the taps of the captured forward are the
        graph's second output (their names kept in the entry); the cost
        registry counts the warm-up, never the capture."""
        from ..ndarray import NDArray

        statics = [None if a is None else a._data.clone() for a in args]
        with _costs.first("cachedop", (id(self), sig, "fwd")) as c:
            out, eager = self._first_run(lambda: cuda_graph.warmup(
                lambda: self.block._imperative_forward(*args)))
        self._note_cost(sig, c)
        if eager:
            return out, eager
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        placed = [a._data for a in args if a is not None] + \
            [p._data._data for p in self.block.collect_params().values()]
        if any_dtensor(placed):  # collectives inside the graph
            cuda_graph.warm_groups(placed)
        names = []

        def forward():
            return _map_out(self.block._imperative_forward(
                *(None if s is None else NDArray(s) for s in statics)),
                lambda o: o._data)

        def forward_with_stats():
            with _numerics.collecting() as col:
                outs = forward()
            tapped, stats = col.drain()
            names.extend(tapped)
            return (outs, stats) if tapped else outs

        graph = cuda_graph.capture(
            forward_with_stats if sig[4] else forward,
            pool=self._pool, mode="thread_local")
        return out, (ptrs, statics, graph, tuple(names))


class _Quiet(threading.local):
    depth = 0


_QUIET_STATE = _Quiet()


class _quiet:
    """Inside, a hybridized block's recorded call records no telemetry:
    ``FusedTrainStep`` runs its steps so, as the reference's fused
    program holds its net's forward without a CachedOp of its own."""

    def __enter__(self):
        _QUIET_STATE.depth += 1

    def __exit__(self, *exc):
        _QUIET_STATE.depth -= 1


def _signature(args, params):
    """A call's graph key: each input's shape, dtype and device (an input
    may be None), the training mode, amp's dtype, the parameters' shapes
    and dtypes, and the numerics mode."""
    return (tuple(None if a is None else (a.shape, a.dtype, a._data.device)
                  for a in args),
            ag.is_training(), amp.target_dtype(),
            tuple((p.shape, p.dtype) for p in params),
            _numerics.signature())


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def _components(sig, args, params, ptrs=None):
    """The named signature components the recapture sanitizer diffs: the
    reference's (``retrace.cachedop_components``), amp's dtype, and on a
    card the parameters' addresses (a graph bakes them in)."""
    from ..parallel.local import is_dtensor

    arrays = [a._data for a in args if a is not None]
    mesh = next((tuple(t.device_mesh.shape) for t in arrays +
                 [p._data._data for p in params] if is_dtensor(t)), None)
    comps = {
        "args": tuple(None if a is None else
                      (tuple(a.shape), _dtype_name(a.dtype)) for a in args),
        "training": sig[1],
        "platform": arrays[0].device.type if arrays else None,
        "params": tuple((tuple(p.shape), _dtype_name(p.dtype))
                        for p in params),
        "mesh": mesh,
        "numerics": sig[4],
        "amp": _dtype_name(sig[2]) if sig[2] is not None else None,
    }
    if ptrs is not None:
        comps["param_addresses"] = tuple(
            f"{p.name}@{ptr:#x}" for p, ptr in zip(params, ptrs))
    return comps


def _grad_hook(params, bwd_key, site, stats):
    """The recorded call's ``autograd.after_backward`` hook: each
    parameter's ``grad.<name>`` statistics (zeros for one the backward
    did not reach), and the backward's cost entry."""
    names = tuple("grad." + p.name for p in params)

    def hook(variables, grads, counted):
        if stats and _numerics._enabled:
            by_id = {id(v): g for v, g in zip(variables, grads)}
            rows = []
            for p in params:
                g = by_id.get(id(p._data))
                rows.append(_numerics.stats_of(g) if g is not None else
                            torch.zeros(5, dtype=torch.float64,
                                        device=p._data._data.device))
            _numerics.record_compiled(names, torch.stack(rows))
        if _costs._enabled:
            _costs.note("cachedop_bwd", bwd_key, counted, site=site)

    return hook


def _classic(o):
    """An ``mx.np`` array as the classic ``NDArray`` over the same tensor;
    anything else as it is."""
    from ..numpy import ndarray

    return o.as_nd_ndarray() if isinstance(o, ndarray) else o


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
        graphs, one per input signature; ``active=False`` turns it off.
        ``remat=`` picks the remat tier of its recorded forward."""
        if "remat" in kwargs:
            from ..memory import policy as _mem_policy

            _mem_policy.normalize(kwargs["remat"])  # garbage raises here
        self._active = bool(active)
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        self._cached_op = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def optimize_for(self, x, *args, backend=None, **kwargs):
        """Reference ``optimize_for`` (a subgraph backend's partitioning):
        the port has one backend, so it is ``hybridize(**kwargs)`` and one
        warm-up call on the inputs."""
        self.hybridize(True, **kwargs)
        self(x, *args)

    def export(self, path, epoch=0):
        """Write ``path-symbol.json``, ``path-%04d.params`` and the
        ``torch.export`` program ``path-%04d.pt2`` of the inference
        forward at the first cached signature (``gluon/symbol_block.py``);
        returns the symbol and params file names."""
        from . import symbol_block

        return symbol_block.export_block(self, path, epoch)

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


class SymbolBlock(HybridBlock):
    """A block over a symbol graph (reference ``gluon.SymbolBlock``):
    ``SymbolBlock(outputs, inputs, params)`` over a ``Symbol``, whose
    other arguments become the block's parameters, or
    ``SymbolBlock.imports`` of an export or an nnvm graph
    (``gluon/symbol_block.py``)."""

    def __init__(self, outputs=None, inputs=None, params=None, prefix=None):
        super().__init__(prefix=prefix,
                         params=None if outputs is not None else params)
        self._fn = None
        if outputs is not None:
            from . import symbol_block

            self._fn = symbol_block.symbol_block_fn(self, outputs, inputs,
                                                    params)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """The block of an exported program or an nnvm symbol JSON, its
        parameters read from ``param_file`` onto ``ctx`` (default: the
        current context)."""
        from . import symbol_block

        return symbol_block.import_block(symbol_file, input_names,
                                         param_file, ctx)

    def hybrid_forward(self, F, *args, **params):
        if self._fn is None:
            raise MXNetError(
                "SymbolBlock not bound; construct via SymbolBlock.imports")
        return self._fn(F, args, params)


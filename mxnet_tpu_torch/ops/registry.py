"""Op dispatch.

Counterpart of ``mxnet_tpu/ops/registry.py``.  ``apply_op`` unwraps the
NDArray operands, calls the tensor function with torch's gradient mode
set to ``autograd.is_recording()`` (torch's graph is the tape, so an op
is recorded exactly when the reference would tape it) and wraps what it
returns.  While ``amp`` is active, the operands first pass through
``amp.maybe_cast_args`` under the op's ``name`` (the key of amp's op
lists), as the reference's ``apply_op`` does; the casts are recorded, so
a gradient reaches an f32 parameter in f32.  An op the reference
registers as non-differentiable (``no_grad``: rounding, predicates,
comparisons, index outputs) runs with torch's gradient mode off, so its
result carries no graph.  Under a mesh (an operand is a ``DTensor``)
the plain operands become replicated ``DTensor``s.
``exporter`` builds a module's ``__all__`` with the reference's aliases
and registers each op in the name → op table (``defop``, ``get_op``,
``list_ops``, ``op_meta``): the reference's 342 names, each with its
aliases and ``no_grad`` flag, through which a ``Symbol`` node and an
nnvm graph's node resolve their op.  While the profiler runs
(``profiler.py``), each op's dispatch is timed and recorded under its
scope and name, as the reference's hook does; otherwise dispatch does
not look at it.  With bulking on (``engine.py``), ``maybe_defer`` may
append the op to the thread's pending segment instead of running it;
the disabled path is one flag test.  Two telemetry hooks sit here as in the reference: an
op that fails with a device allocation failure raises
``telemetry.memwatch``'s post-mortem ``OOMError`` while the ledger is
on, and ``telemetry.numerics.bisect()`` journals every op's nan/inf
verdicts.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Dict

from .. import autograd as ag
from .. import engine as _engine
from .. import sanitizer as _san
from ..base import MXNetError
from ..telemetry import memwatch as _mw

#: every registered name (canonical and aliases) -> its NDArray op
_OPS: Dict[str, Callable] = {}
#: every registered name -> {"no_grad", "canonical", "aliases"}
_OP_META: Dict[str, dict] = {}
#: (name, previous canonical, new canonical) of each registration that
#: replaced another op under a name; empty in the package
_DUPLICATE_REGISTRATIONS = []
#: per-op NaN hook ``hook(name, raws, outs)``, installed by
#: ``telemetry.numerics.bisect()`` for an eager replay
_bisect_hook = None


def _profiler():
    """The profiler module iff it is loaded and running (the reference
    engine's ``IsProfiling()`` check an op)."""
    prof = sys.modules.get("mxnet_tpu_torch.profiler")
    return prof if prof is not None and prof.is_running() else None


def apply_op(fun: Callable, *nd_args, name: str = "", no_grad=False):
    """Apply tensor function ``fun`` to NDArray operands; returns an
    NDArray, or a tuple of them when ``fun`` returns a tuple or list."""
    import torch

    from .. import amp
    from ..ndarray.ndarray import NDArray
    from ..parallel.local import replicate_plain

    if _engine._bulk_on:
        # a deferred op runs with torch's gradient mode off, as every op
        # outside record() does
        deferred = _engine.maybe_defer(fun, nd_args, name)
        if deferred is not None:
            single, vals = deferred
            outs = []
            for v in vals:
                o = NDArray.__new__(NDArray)
                o._raw, o._grad, o._grad_req = v, None, "null"
                outs.append(o)
            return outs[0] if single else tuple(outs)
    prof = _profiler()
    if prof is not None:
        t0 = time.perf_counter()
    raws = [a._data for a in nd_args]
    if _san._enabled:
        # a donated operand fails here, naming the donation site
        for r in raws:
            _san.check(r, f"operand of {name or 'op'!r}")
    try:
        with torch.no_grad() if no_grad else ag.grad_mode():
            raws = replicate_plain(raws)
            if amp.is_active():
                raws = amp.maybe_cast_args(name, raws)
            outs = fun(*raws)
    except Exception as exc:
        if _mw._enabled:
            _mw.annotate_oom(exc, context=f"op {name or '<anonymous>'}")
        raise
    if _bisect_hook is not None:
        _bisect_hook(name, raws, outs if isinstance(outs, (tuple, list))
                     else (outs,))
    if prof is not None:
        prof.record_op_event(prof.current_scope_prefix() + (name or "op"),
                             time.perf_counter() - t0)
    if isinstance(outs, (tuple, list)):
        return tuple(NDArray(o) for o in outs)
    return NDArray(outs)


def register(name, fn, aliases=(), no_grad=False):
    """Register ``fn`` under ``name`` and ``aliases`` with its ``no_grad``
    flag (the reference's ``_register``); returns ``fn``."""
    meta = {"no_grad": bool(no_grad), "canonical": name,
            "aliases": tuple(aliases)}
    for n in (name,) + tuple(aliases):
        if n in _OPS and _OPS[n] is not fn:
            _DUPLICATE_REGISTRATIONS.append(
                (n, _OP_META.get(n, {}).get("canonical", n), name))
        _OPS[n] = fn
        _OP_META[n] = meta
    return fn


def defop(name=None, aliases=(), no_grad=False):
    """Decorator: register an NDArray-level op under ``name`` (default
    the function's own) and ``aliases``; ``no_grad=True`` marks it
    non-differentiable (reference ``defop``)."""
    def deco(fn):
        return register(name or fn.__name__, fn, aliases, no_grad)

    return deco


def get_op(name):
    """The op registered under ``name``, or None."""
    return _OPS.get(name)


def list_ops():
    """Every registered name, canonical and alias, sorted."""
    return sorted(_OPS)


def op_meta(name):
    """``{"no_grad", "canonical", "aliases"}`` of ``name``; ``{}`` for a
    name that is not registered."""
    return _OP_META.get(name, {})


def duplicate_registrations():
    """(name, previous canonical, new canonical) for every registration
    that replaced another op under a name."""
    return list(_DUPLICATE_REGISTRATIONS)


def exporter(module_all, module=None):
    """``export(fn, name=None, aliases=(), no_grad=False)``: put ``fn`` in
    ``module`` (default: the module defining ``fn``) under ``name``
    (default its own) and each alias, list them in ``module_all`` (the
    module's ``__all__``) and register them as an op."""
    def export(fn, name=None, aliases=(), no_grad=False):
        mod = module or sys.modules[fn.__module__]
        name = name or fn.__name__
        for n in (name,) + tuple(aliases):
            setattr(mod, n, fn)
            module_all.append(n)
        return register(name, fn, aliases, no_grad)

    return export


def make_exporter(module):
    """The reference's per-module ``_export`` helper over a module object:
    ``exporter`` on its ``__all__`` (created when missing)."""
    if not hasattr(module, "__all__"):
        module.__all__ = []
    return exporter(module.__all__, module)


def wrap_raw(x):
    """An NDArray over the tensor ``x`` (no op, nothing recorded)."""
    from ..ndarray.ndarray import NDArray

    return NDArray(x)


def commit_out(out, result):
    """Honour an ``out=`` argument: ``out`` takes ``result``'s tensor (its
    recorded history included) and is returned; ``result`` when ``out``
    is None."""
    if out is None:
        return result
    out._data = result._data
    return out


def accum_dtype(dt):
    """float32 for bfloat16 and float16 (their products and reductions
    accumulate in f32), None for a dtype that accumulates in itself."""
    import numpy as np
    import torch

    from ..base import resolve_dtype

    t = resolve_dtype(dt)
    return np.float32 if t in (torch.bfloat16, torch.float16) else None


def _not_carried(name):
    def refuse(*args, **kwargs):
        raise MXNetError(
            f"ops.registry.{name} has no counterpart in the port "
            "(ROADMAP.md, Not carried over: the JAX package's dispatch "
            "platform of a trace; a torch op runs where its tensors lie)")

    refuse.__name__ = name
    refuse.__doc__ = ("The JAX package's dispatch-platform helper: raises "
                      "``MXNetError`` naming \"Not carried over\".")
    return refuse


current_dispatch_platform = _not_carried("current_dispatch_platform")
dispatch_platform = _not_carried("dispatch_platform")
platform_of_raw = _not_carried("platform_of_raw")
platform_of_raws = _not_carried("platform_of_raws")

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
``exporter`` builds a module's ``__all__`` with
the reference's aliases.  While the profiler runs (``profiler.py``),
each op's dispatch is timed and recorded under its scope and name, as
the reference's hook does; otherwise dispatch does not look at it.  The
reference's bulking hook has no counterpart (``engine.py``).
"""
from __future__ import annotations

import sys
import time
from typing import Callable


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
    from ..autograd import grad_mode
    from ..ndarray.ndarray import NDArray
    from ..parallel.local import replicate_plain

    prof = _profiler()
    if prof is not None:
        t0 = time.perf_counter()
    raws = [a._data for a in nd_args]
    with torch.no_grad() if no_grad else grad_mode():
        raws = replicate_plain(raws)
        if amp.is_active():
            raws = amp.maybe_cast_args(name, raws)
        outs = fun(*raws)
    if prof is not None:
        prof.record_op_event(prof.current_scope_prefix() + (name or "op"),
                             time.perf_counter() - t0)
    if isinstance(outs, (tuple, list)):
        return tuple(NDArray(o) for o in outs)
    return NDArray(outs)


def exporter(module_all):
    """``export(fn, name=None, aliases=())``: put ``fn`` in the calling
    module under ``name`` (default its own) and each alias, and list them
    in ``module_all`` (the module's ``__all__``)."""
    import sys

    def export(fn, name=None, aliases=()):
        mod = sys.modules[fn.__module__]
        name = name or fn.__name__
        for n in (name,) + tuple(aliases):
            setattr(mod, n, fn)
            module_all.append(n)
        return fn

    return export

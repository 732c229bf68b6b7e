"""Autograd: ``record()/pause()`` scopes, ``backward``, ``grad`` and
``Function`` over torch's autograd.

Counterpart of ``mxnet_tpu/autograd.py``.  The reference tapes every op
while recording; here torch's autograd graph is the tape.  Ops run with
torch's gradient mode set to ``is_recording()`` (``ops.registry.apply_op``
and ``Block.__call__``), so a graph is built only inside ``record()``.
A variable is an NDArray whose tensor is a leaf that requires grad,
marked by ``attach_grad`` (Parameters are attached at initialization);
``backward`` walks the graph from the heads to the variables it reaches
and differentiates with ``torch.autograd.grad``, then honours each
variable's ``grad_req``: ``"write"`` releases its old gradient before
the backward runs and rebinds the buffer to the new gradient (no copy,
never two gradient sets alive in a backward, and never torch's
accumulate-into-``.grad``), ``"add"`` adds to it, ``"null"`` drops it.
A variable the heads do not reach keeps its gradient, as in the
reference.

``retain_graph=False`` frees the graph after one backward; a second
backward through it raises ``MXNetError`` and leaves the reached
``"write"`` gradients zero.  ``grad(create_graph=True)`` returns
gradients that stay in torch's graph, so a later backward through them
gives higher-order gradients; an op whose backward is first-order only
(the flash kernels, the norms and the fused losses, ``first_order_only``)
raises there rather than return a wrong second derivative.  The reference's tape node (``Node``) has no counterpart here:
reading it raises ``MXNetError`` naming its ROADMAP list.
``get_symbol`` raises ``NotImplementedError`` as the reference's stub
does.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch

from .base import MXNetError
from .telemetry import memwatch as _mw


class _AGState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        self.after_backward = {}


_STATE = _AGState()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(is_record: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(is_record)
    return prev


def set_training(train_mode: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(train_mode)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._rec, self._train = is_record, train_mode
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._prev


def record(train_mode: bool = True):
    """``with autograd.record():`` — turn on recording (+training mode)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    """``with autograd.pause():`` — suspend recording."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def grad_mode():
    """A context that sets torch's gradient mode to ``is_recording()``
    (a no-op when it already is)."""
    rec = _STATE.recording
    if torch.is_grad_enabled() == rec:
        return contextlib.nullcontext()
    return torch.set_grad_enabled(rec)


# ---------------------------------------------------------------------------
# Variables and backward
# ---------------------------------------------------------------------------

def _mark(arr, grad_req, grad=None):
    """Make ``arr`` a variable with ``grad_req`` (``grad``: its gradient
    buffer, or None to allocate zeros when first read)."""
    t = arr._data
    if t.grad_fn is not None:  # a recorded result: detach it first
        t = arr._data = t.detach()
    t.requires_grad_(grad_req != "null")
    t._mx_variable = weakref.ref(arr)
    arr._grad_req = grad_req
    arr._grad = grad if grad_req != "null" else None


def _variable(t):
    """The NDArray that attached ``t`` as a variable, or None."""
    ref = getattr(t, "_mx_variable", None)
    arr = ref() if ref is not None else None
    if arr is None or arr._data is not t or arr._grad_req == "null":
        return None
    return arr


def _reached_variables(roots):
    """Variables reachable from the tensors ``roots`` in torch's graph
    (the heads themselves included), each once, in discovery order."""
    found, seen_t = [], set()

    def add(t):
        arr = _variable(t)
        if arr is not None and id(t) not in seen_t:
            seen_t.add(id(t))
            found.append(arr)

    stack, seen = [], set()
    for r in roots:
        add(r)
        if r.grad_fn is not None:
            stack.append(r.grad_fn)
    while stack:
        fn = stack.pop()
        if fn in seen:
            continue
        seen.add(fn)
        leaf = getattr(fn, "variable", None)  # AccumulateGrad
        if leaf is not None:
            add(leaf)
        stack.extend(nxt for nxt, _ in fn.next_functions if nxt is not None)
    return found


def _as_lists(heads, head_grads):
    from .ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    if len(heads) != len(head_grads):
        raise MXNetError("heads and head_grads length mismatch")
    roots = []
    for h in heads:
        if h._data.grad_fn is None and _variable(h._data) is None:
            raise MXNetError(
                "cannot differentiate a head that is not attached to the "
                "graph (call .attach_grad() or compute it inside "
                "autograd.record())")
        roots.append(h._data)
    seeds = [_ones_seed(r) if g is None else _given_seed(r, g._data)
             for r, g in zip(roots, head_grads)]
    return roots, seeds


def _ones_seed(r):
    """The head gradient of ones.  A head that is a sum over a mesh's
    ranks (``Partial``) is seeded with replicated ones: every rank's
    share gets gradient 1."""
    from .parallel.local import is_dtensor

    if is_dtensor(r) and any(p.is_partial() for p in r.placements):
        from torch.distributed.tensor import DTensor, Replicate

        return DTensor.from_local(
            torch.ones_like(r.to_local()), r.device_mesh,
            [Replicate() if p.is_partial() else p for p in r.placements],
            run_check=False)
    return torch.ones_like(r)


def _given_seed(r, g):
    """A head gradient given for ``r``; a plain one for a head on a mesh
    is the replicated global array."""
    from .parallel.local import replicate_plain

    return replicate_plain([r, g.to(r.dtype)])[1]


def _grads(roots, seeds, tensors, retain_graph, create_graph=False):
    try:
        return torch.autograd.grad(roots, tensors, seeds,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as exc:
        if "second time" not in str(exc):
            raise
        raise MXNetError(
            "graph has already been freed; pass retain_graph=True to "
            "backward() to backprop twice through the same graph") from exc


def after_backward(key, hook, count=False):
    """Run ``hook(variables, grads, counted)`` after the next ``backward``
    on this thread (``gluon.CachedOp``'s recorded calls: the numerics
    tier's per-parameter ``grad.`` statistics and the cost registry's
    backward).  One hook a ``key`` (the latest), so recorded calls that
    no backward follows keep no more than one each.  ``count=True`` runs
    that backward under ``telemetry.costs.counting()``, whose result is
    ``counted`` (else None)."""
    _STATE.after_backward[key] = (hook, count)


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True):
    """Run backward from ``heads``; fill the gradient buffers of the
    variables they reach, by each variable's ``grad_req`` (reference
    ``autograd.backward``)."""
    roots, seeds = _as_lists(heads, head_grads)
    variables = _reached_variables(roots)
    hooks = _STATE.after_backward
    if hooks:
        _STATE.after_backward = {}
        hooks = list(hooks.values())
    if not variables:
        return
    # "write" buffers are overwritten: release the old gradients before
    # the new ones are computed, so that one set is alive at a time
    dropped = [v for v in variables
               if v._grad_req == "write" and v._grad is not None]
    for v in dropped:
        v._grad._data = None
    counted = None
    try:
        if any(count for _, count in hooks):
            from .telemetry import costs

            with costs.counting() as counted:
                grads = _grads(roots, seeds, [v._data for v in variables],
                               retain_graph)
        else:
            grads = _grads(roots, seeds, [v._data for v in variables],
                           retain_graph)
    except BaseException:
        for v in dropped:  # the old values are gone: leave zeros
            v._grad._data = torch.zeros_like(v._data)
        raise
    for hook, _ in hooks:
        hook(variables, grads, counted)
    for v, g in zip(variables, grads):
        if g is None:
            if v._grad is not None and v._grad._data is None:  # released
                v._grad._data = torch.zeros_like(v._data)
            continue
        if g.dtype != v._data.dtype:
            g = g.to(v._data.dtype)
        if v._grad_req == "add" and v._grad is not None:
            v._grad._data = v._grad._data + g
        else:
            from .ndarray import NDArray

            if v._grad is None:
                v._grad = NDArray(g)
            else:
                v._grad._data = g
        if _mw._enabled:
            _mw.track(v._grad._data)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph: bool = False, train_mode: bool = True):
    """Gradients of ``heads`` with respect to ``variables`` as new
    NDArrays, leaving every gradient buffer alone (reference
    ``autograd.grad``).  A variable the heads do not reach gets zeros."""
    from .ndarray import NDArray

    if isinstance(variables, NDArray):
        variables = [variables]
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("autograd.grad: a variable was not attached "
                             "(call .attach_grad() before recording)")
    roots, seeds = _as_lists(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    grads = _grads(roots, seeds, [v._data for v in variables],
                   bool(retain_graph), create_graph)
    if create_graph:  # the gradients stay in the graph
        return [NDArray(torch.zeros_like(v._data) if g is None else g)
                for v, g in zip(variables, grads)]
    return [NDArray(torch.zeros_like(v._data) if g is None else g.detach())
            for v, g in zip(variables, grads)]


def first_order_only(what):
    """Called first in the backward of an op whose backward is not itself
    differentiable (a hand-written kernel's, or one that reuses forward
    statistics as constants): raises ``MXNetError`` when that backward
    runs under ``grad(create_graph=True)``, which torch runs with its
    gradient mode on, so a second derivative is never silently wrong."""
    if torch.is_grad_enabled():
        raise MXNetError(
            f"{what} has a first-order backward only: "
            "autograd.grad(create_graph=True) cannot differentiate it "
            "again (its second derivative would be wrong)")


def mark_variables(variables, gradients, grad_reqs="write"):
    """Reference ``autograd.mark_variables``: make each array a variable
    with the given gradient buffer and ``grad_req``."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        _mark(v, req, g)


class _FunctionBridge(torch.autograd.Function):
    """Runs an ``autograd.Function``'s NDArray forward and backward as one
    node of torch's graph."""

    @staticmethod
    def forward(ctx, fn, *raws):
        from .ndarray import NDArray

        ctx.fn = fn
        with pause():
            outs = fn.forward(*(NDArray(r) for r in raws))
        fn._single = isinstance(outs, NDArray)
        outs = (outs,) if fn._single else tuple(outs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cotangents):
        from .ndarray import NDArray

        with pause():
            grads = ctx.fn.backward(*(NDArray(c) for c in cotangents))
        if isinstance(grads, NDArray):
            grads = (grads,)
        return (None,) + tuple(None if g is None else g._data
                               for g in grads)


class Function:
    """Custom differentiable function (reference ``autograd.Function``).

    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` with NDArray math; ``backward``
    returns one gradient per input.  Gradients computed in ``backward``
    are not themselves recorded."""

    def __init__(self):
        self._saved = None
        self._single = True

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def __call__(self, *inputs):
        from .ndarray import NDArray

        if not is_recording():
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _FunctionBridge.apply(self, *(i._data for i in inputs))
        outs = tuple(NDArray(o) for o in outs)
        return outs[0] if self._single else outs

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError


from . import _left_out as _lo  # noqa: E402

def get_symbol(x):
    """The reference's compatibility stub: raises ``NotImplementedError``
    (graph capture is ``HybridBlock.export``)."""
    raise NotImplementedError(
        "autograd.get_symbol (legacy symbolic extraction) is not supported; "
        "use HybridBlock.export for graph capture")


__getattr__ = _lo.refuse(_lo.AUTOGRAD, "mxnet_tpu_torch.autograd")

"""Control-flow operators: foreach / while_loop / cond.

Counterpart of ``mxnet_tpu/ops/control_flow.py`` (reference
``src/operator/control_flow.cc`` and the ``nd.contrib`` frontends).

Imperative calls run plain Python loops (each body op lands on the
autograd tape), and ``while_loop``/``cond`` read their predicate on the
host, as the reference's eager path does.  Inside a CUDA graph capture
or its warm-up (``cuda_graph.capturing()``: a hybridized block's forward)
nothing may be read on the host, so they do what the reference's traced
path does: ``cond`` computes both branches and selects with
``torch.where``, ``while_loop`` runs ``max_iterations`` masked steps
(a step after the predicate turned false changes nothing and writes a
zero row), which gives the eager path's zero-padded buffers and final
vars.  ``foreach`` has no predicate and is a plain loop everywhere.
"""
from __future__ import annotations

import torch

from .. import cuda_graph
from ..base import MXNetError


def _aslist(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _truth(pred):
    """A predicate NDArray as a 0-d bool tensor on its device."""
    return pred._data.detach().to(torch.bool).reshape(())


def foreach(body, data, init_states, name="foreach"):
    """Reference ``mx.nd.contrib.foreach``: scan ``body(slice, states) →
    (outputs, states)`` over axis 0 of ``data``.  Returns (outputs stacked
    on axis 0, final states)."""
    from ..ndarray import stack as nd_stack

    data_list = _aslist(data)
    single_data = not isinstance(data, (list, tuple))
    n = data_list[0].shape[0]
    outputs = None
    cur = init_states
    for i in range(n):
        sl = [d[i] for d in data_list]
        out, cur = body(sl[0] if single_data else sl, cur)
        out_l = _aslist(out)
        if outputs is None:
            outputs = [[] for _ in out_l]
        for buf, o in zip(outputs, out_l):
            buf.append(o)
    stacked = [nd_stack(*buf, axis=0) for buf in (outputs or [])]
    single_out = len(stacked) == 1
    return (stacked[0] if single_out else stacked), cur


def _where(mask, a, b):
    """``torch.where`` on NDArrays (recorded like any op)."""
    from .registry import apply_op

    return apply_op(lambda x, y: torch.where(mask, x, y), a, b,
                    name="where")


def _masked_while(cond, func, lv, max_iterations, single_var):
    """``max_iterations`` masked steps of ``func``: the traced path of the
    reference (its ``lax.while_loop`` over zero-filled buffers)."""
    from ..ndarray import stack as nd_stack, zeros_like

    active = None
    rows = None
    cur = lv
    for _ in range(max_iterations):
        c = _truth(cond(*cur))
        active = c if active is None else active & c
        outs, new_vars = func(*cur)
        outs_l = _aslist(outs)
        if rows is None:
            rows = [[] for _ in outs_l]
        for buf, o in zip(rows, outs_l):
            buf.append(_where(active, o, zeros_like(o)))
        cur = [_where(active, nv, v)
               for nv, v in zip(_aslist(new_vars), cur)]
    stacked = [nd_stack(*buf, axis=0) for buf in rows]
    return (stacked[0] if len(stacked) == 1 else stacked), \
        (cur[0] if single_var else cur)


def while_loop(cond, func, loop_vars, max_iterations=None,
               name="while_loop"):
    """Reference ``mx.nd.contrib.while_loop``: iterate ``func(*loop_vars)
    → (step_outputs, new_loop_vars)`` while ``cond(*loop_vars)`` is true.
    Step outputs are stacked into ``max_iterations``-row buffers (rows
    beyond the actual iteration count are zeros — reference contract)."""
    from ..ndarray import stack as nd_stack, zeros_like

    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations")
    lv = _aslist(loop_vars)
    single_var = not isinstance(loop_vars, (list, tuple))
    if cuda_graph.capturing():
        return _masked_while(cond, func, lv, max_iterations, single_var)

    steps = []
    cur = lv
    it = 0
    while it < max_iterations and bool(cond(*cur).asscalar()):
        outs, new_vars = func(*cur)
        steps.append(_aslist(outs))
        cur = _aslist(new_vars)
        it += 1
    if not steps:
        # zero iterations: probe shapes (discarding state) so imperative
        # matches the traced path's zero-filled buffers.  Contract (as
        # the reference's): func must be safely callable on the initial
        # loop_vars even when cond is false.  The probe is not recorded.
        from .. import autograd as _ag

        with _ag.pause():
            probe_out, _ = func(*cur)
        zero_rows = [zeros_like(o) for o in _aslist(probe_out)]
        stacked = [nd_stack(*([z] * max_iterations), axis=0)
                   for z in zero_rows]
        n_out = len(stacked)
        return (stacked[0] if n_out == 1 else stacked), \
            (cur[0] if single_var else cur)
    n_out = len(steps[0])
    stacked = []
    for j in range(n_out):
        rows = [s[j] for s in steps]
        pad = [zeros_like(rows[0]) for _ in range(max_iterations - it)]
        stacked.append(nd_stack(*(rows + pad), axis=0))
    return (stacked[0] if n_out == 1 else stacked), \
        (cur[0] if single_var else cur)


def cond(pred, then_func, else_func, name="cond"):
    """Reference ``mx.nd.contrib.cond``: run one of two branches (both,
    selected by ``torch.where``, while a CUDA graph captures)."""
    if cuda_graph.capturing():
        p = _truth(pred)
        outs = [_where(p, a, b) for a, b in zip(_aslist(then_func()),
                                                _aslist(else_func()))]
        return outs[0] if len(outs) == 1 else outs
    # eager: the predicate is read on the host (the op's contract)
    branch = then_func if bool(pred.asscalar()) else else_func
    return branch()

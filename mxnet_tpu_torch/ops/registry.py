"""Op dispatch.

Counterpart of ``mxnet_tpu/ops/registry.py``.  ``apply_op`` unwraps the
NDArray operands, calls the tensor function with torch's gradient mode
set to ``autograd.is_recording()`` (torch's graph is the tape, so an op
is recorded exactly when the reference would tape it) and wraps what it
returns.  The reference's bulking, amp casting and profiler hooks port
with later slices (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Callable


def apply_op(fun: Callable, *nd_args, name: str = ""):
    """Apply tensor function ``fun`` to NDArray operands; returns an
    NDArray, or a tuple of them when ``fun`` returns a tuple or list."""
    from ..autograd import grad_mode
    from ..ndarray.ndarray import NDArray

    with grad_mode():
        outs = fun(*(a._data for a in nd_args))
    if isinstance(outs, (tuple, list)):
        return tuple(NDArray(o) for o in outs)
    return NDArray(outs)

"""Op dispatch.

Counterpart of ``mxnet_tpu/ops/registry.py``.  ``apply_op`` unwraps the
NDArray operands, calls the tensor function and wraps what it returns.
The reference's bulking, tape recording, amp casting and profiler hooks
port with later slices (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Callable


def apply_op(fun: Callable, *nd_args, name: str = ""):
    """Apply tensor function ``fun`` to NDArray operands; returns an
    NDArray, or a tuple of them when ``fun`` returns a tuple or list."""
    from ..ndarray.ndarray import NDArray

    outs = fun(*(a._data for a in nd_args))
    if isinstance(outs, (tuple, list)):
        return tuple(NDArray(o) for o in outs)
    return NDArray(outs)

"""``mx.nd.contrib`` namespace, also ``F.contrib`` inside
``hybrid_forward``.

Counterpart of ``mxnet_tpu/ndarray/contrib.py`` (reference
``python/mxnet/ndarray/contrib.py``): the ops of ``ops/contrib.py`` under
the names reference scripts use (``mx.nd.contrib.box_nms`` etc.), with
``boolean_mask``, ``div_sqrt_dim``, the interleaved attention pair and
the control-flow ops ``foreach``, ``while_loop`` and ``cond``.
"""
from __future__ import annotations

from ..ops.contrib import *  # noqa: F401,F403
from ..ops.contrib import __all__ as _contrib_all
from ..ops.tensor import boolean_mask  # noqa: F401
from ..ops.attention import (  # noqa: F401
    div_sqrt_dim, interleaved_matmul_selfatt_qk,
    interleaved_matmul_selfatt_valatt)
from ..ops.control_flow import foreach, while_loop, cond  # noqa: F401

__all__ = list(_contrib_all) + [
    "boolean_mask", "div_sqrt_dim", "interleaved_matmul_selfatt_qk",
    "interleaved_matmul_selfatt_valatt", "foreach", "while_loop", "cond"]

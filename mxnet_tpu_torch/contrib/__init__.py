"""Top-level ``mx.contrib`` namespace.

Counterpart of ``mxnet_tpu/contrib/__init__.py`` (reference
``python/mxnet/contrib/__init__.py``): ``amp``, ``quantization`` and
``ndarray`` (``nd.contrib``).  ``contrib.symbol`` and ``contrib.onnx``
(ROADMAP.md, Queue 1 item 8f) raise ``MXNetError`` naming their item.
"""
from .. import amp  # noqa: F401
from . import quantization  # noqa: F401
from ..ndarray import contrib as ndarray  # noqa: F401
from .. import _left_out as _lo

__getattr__ = _lo.refuse(_lo.CONTRIB, "mxnet_tpu_torch.contrib")

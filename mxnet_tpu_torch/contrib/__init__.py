"""Top-level ``mx.contrib`` namespace.

Counterpart of ``mxnet_tpu/contrib/__init__.py`` (reference
``python/mxnet/contrib/__init__.py``): ``amp`` and ``quantization``.
``contrib.ndarray`` (the contrib ops: ROADMAP.md, Queue 1 item 8d),
``contrib.symbol`` and ``contrib.onnx`` (item 8f) raise ``MXNetError``
naming their item.
"""
from .. import amp  # noqa: F401
from . import quantization  # noqa: F401
from .. import _left_out as _lo

__getattr__ = _lo.refuse(_lo.CONTRIB, "mxnet_tpu_torch.contrib")

"""Top-level ``mx.contrib`` namespace.

Counterpart of ``mxnet_tpu/contrib/__init__.py`` (reference
``python/mxnet/contrib/__init__.py``): ``amp``, ``quantization``,
``onnx``, ``ndarray`` (``nd.contrib``) and ``symbol`` (``sym.contrib``).
"""
from .. import amp  # noqa: F401
from . import quantization  # noqa: F401
from . import onnx  # noqa: F401
from ..ndarray import contrib as ndarray  # noqa: F401
from ..symbol import contrib as symbol  # noqa: F401

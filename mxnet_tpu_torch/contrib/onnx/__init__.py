"""``mx.contrib.onnx``: counterpart of ``mxnet_tpu/contrib/onnx``
(reference ``python/mxnet/contrib/onnx``): ONNX export (mx2onnx) and
import (onnx2mx), both over the bundled protobuf wire-format codec — no
``onnx`` package in either direction."""
from .mx2onnx import export_model  # noqa: F401
from .onnx2mx import import_model  # noqa: F401

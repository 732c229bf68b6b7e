"""gluon — the high-level API (counterpart of ``mxnet_tpu/gluon``).
``Trainer``, losses and the model zoo port with the training slices."""
from . import parameter
from .parameter import Parameter, ParameterDict
from . import block
from .block import Block, HybridBlock
from . import nn

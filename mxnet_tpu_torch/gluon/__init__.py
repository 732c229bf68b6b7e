"""gluon — the high-level API (counterpart of ``mxnet_tpu/gluon``): blocks,
parameters, layers, losses and the ``Trainer``.  The model zoo and the
data API port with later slices."""
from . import parameter
from .parameter import Parameter, ParameterDict
from . import block
from .block import Block, HybridBlock
from . import nn
from . import loss
from . import trainer
from .trainer import Trainer

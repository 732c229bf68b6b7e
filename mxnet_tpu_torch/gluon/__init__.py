"""gluon — the high-level API (counterpart of ``mxnet_tpu/gluon``): blocks,
parameters, layers, losses, the ``Trainer``, ``FusedTrainStep``,
``utils``, the vision model zoo and the data API (``gluon.data``)."""
from . import parameter
from .parameter import Parameter, ParameterDict
from . import block
from .block import Block, HybridBlock
from . import nn
from . import loss
from . import trainer
from .trainer import Trainer
from . import step_fusion
from .step_fusion import FusedTrainStep
from . import utils
from . import model_zoo
from . import data

"""gluon — the high-level API (counterpart of ``mxnet_tpu/gluon``): blocks,
parameters, layers, losses, the ``Trainer``, ``FusedTrainStep``,
``utils``, the vision model zoo, the data API (``gluon.data``) and the
recurrent layers and cells (``gluon.rnn``)."""
from . import parameter
from .parameter import Constant, Parameter, ParameterDict
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import nn
from . import loss
from . import trainer
from .trainer import Trainer
from . import step_fusion
from .step_fusion import FusedTrainStep
from . import utils
from . import model_zoo
from . import data
from . import rnn
from . import contrib

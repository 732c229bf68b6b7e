"""gluon.rnn (counterpart of ``mxnet_tpu/gluon/rnn``): the recurrent
cells and the fused layers."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403

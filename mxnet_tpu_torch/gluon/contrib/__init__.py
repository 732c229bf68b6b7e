"""gluon.contrib (counterpart of ``mxnet_tpu/gluon/contrib/__init__.py``,
reference ``python/mxnet/gluon/contrib/``): the contrib layers and the
Estimator fit loop."""
from . import nn
from . import estimator

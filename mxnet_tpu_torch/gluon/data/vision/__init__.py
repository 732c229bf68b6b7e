"""gluon.data.vision: image datasets and transforms (counterpart of
``mxnet_tpu/gluon/data/vision``)."""
from .datasets import *  # noqa: F401,F403
from . import transforms  # noqa: F401

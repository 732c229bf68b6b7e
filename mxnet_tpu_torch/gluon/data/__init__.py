"""gluon.data: datasets, samplers, the DataLoader and the vision datasets
and transforms (counterpart of ``mxnet_tpu/gluon/data``)."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision  # noqa: F401

"""gluon.model_zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the
ResNet family of ``vision``.  The other vision families and ``detection``
port later (ROADMAP.md, Queue 1 item 2 and item 8)."""
from . import vision
from .vision import get_model

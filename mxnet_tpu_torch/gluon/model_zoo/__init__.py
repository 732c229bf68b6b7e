"""gluon.model_zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the
``vision`` families.  ``detection`` ports later (ROADMAP.md, Queue 1
item 8)."""
from . import vision
from .vision import get_model

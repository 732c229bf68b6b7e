"""gluon.model_zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the
``vision`` families and the ``detection`` zoo (SSD, YOLOv3, Faster
R-CNN)."""
from . import vision
from . import detection
from .vision import get_model

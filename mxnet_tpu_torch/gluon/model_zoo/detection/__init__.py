"""gluon.model_zoo.detection: SSD, YOLOv3 and Faster R-CNN.

Counterpart of ``mxnet_tpu/gluon/model_zoo/detection/__init__.py``
(GluonCV's zoo); the ops these detectors drive are ``ops/contrib.py``'s.
"""
from .ssd import *
from .yolo import *
from .faster_rcnn import *

from ....base import MXNetError


def get_model(name, **kwargs):
    models = {
        "ssd_300_resnet18_v1": ssd_300_resnet18_v1,
        "ssd_512_resnet50_v1": ssd_512_resnet50_v1,
        "yolo3_darknet53": yolo3_darknet53,
        "darknet53": darknet53,
        "faster_rcnn_resnet50_v1": faster_rcnn_resnet50_v1,
    }
    name = name.lower()
    if name not in models:
        raise MXNetError(
            f"model {name!r} not found; available: {sorted(models)}")
    return models[name](**kwargs)

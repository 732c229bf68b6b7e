"""gluon.model_zoo.vision (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): ``get_model`` by name.
The ResNet names resolve; the other families of the reference (VGG,
AlexNet, DenseNet, SqueezeNet, Inception, MobileNet) raise ``MXNetError``
naming ROADMAP.md."""
from .resnet import *  # noqa: F401,F403
from . import resnet as _resnet

from ....base import MXNetError

_NOT_PORTED = (
    "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn",
    "vgg19_bn", "alexnet", "densenet121", "densenet161", "densenet169",
    "densenet201", "squeezenet1.0", "squeezenet1.1", "inceptionv3",
    "mobilenet1.0", "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
    "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
    "mobilenetv2_0.25")


def get_model(name, **kwargs):
    """Create a model by name (reference ``vision.get_model``)."""
    models = {f"resnet{d}_v{v}": getattr(_resnet, f"resnet{d}_v{v}")
              for d in (18, 34, 50, 101, 152) for v in (1, 2)}
    name = name.lower()
    if name in _NOT_PORTED:
        raise MXNetError(f"model {name!r} is not ported yet (ROADMAP.md, "
                         "Queue 1 item 2)")
    if name not in models:
        raise MXNetError(
            f"model {name!r} not found; available: {sorted(models)}")
    return models[name](**kwargs)

"""gluon.model_zoo.vision (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): ``get_model`` by name
over the ResNet, VGG, AlexNet, DenseNet, SqueezeNet, Inception and
MobileNet families, the reference's 36 names."""
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403

from ....base import MXNetError

_g = globals()
_MODELS = {
    **{f"resnet{d}_v{v}": _g[f"resnet{d}_v{v}"]
       for d in (18, 34, 50, 101, 152) for v in (1, 2)},
    **{f"vgg{d}{bn}": _g[f"vgg{d}{bn}"]
       for d in (11, 13, 16, 19) for bn in ("", "_bn")},
    "alexnet": alexnet,  # noqa: F405
    **{f"densenet{d}": _g[f"densenet{d}"] for d in (121, 161, 169, 201)},
    "squeezenet1.0": squeezenet1_0,  # noqa: F405
    "squeezenet1.1": squeezenet1_1,  # noqa: F405
    "inceptionv3": inception_v3,  # noqa: F405
    **{f"mobilenet{m}": _g[f"mobilenet{m.replace('.', '_')}"]
       for m in ("1.0", "0.75", "0.5", "0.25")},
    **{f"mobilenetv2_{m}": _g[f"mobilenet_v2_{m.replace('.', '_')}"]
       for m in ("1.0", "0.75", "0.5", "0.25")},
}


def get_model(name, **kwargs):
    """Create a model by name (reference ``vision.get_model``)."""
    name = name.lower()
    if name not in _MODELS:
        raise MXNetError(
            f"model {name!r} not found; available: {sorted(_MODELS)}")
    return _MODELS[name](**kwargs)

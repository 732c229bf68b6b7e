"""VGG 11/13/16/19, with and without BatchNorm.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py`` (3×3
convolutions only: no fused 1×1 run).  ``pretrained=True`` loads
``<root>/<name>.params`` from a local file.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from .resnet import _finish
from ....base import MXNetError  # noqa: F401

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn", "get_vgg"]


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       bias_initializer="zeros"))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       bias_initializer="zeros"))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal",
                                   bias_initializer="zeros")

    def _make_features(self, layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3,
                                         padding=1))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    layers, filters = vgg_spec[num_layers]
    bn = "_bn" if kwargs.get("batch_norm") else ""
    net = VGG(layers, filters, **kwargs)
    return _finish(net, f"vgg{num_layers}{bn}", pretrained, ctx, root)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(19, **kwargs)

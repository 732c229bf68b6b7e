"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (reference
``python/mxnet/initializer.py``): the registry, the name-pattern dispatch
(weight→init, bias→zero, gamma→one, ...) and Zero/One/Constant/Uniform/
Normal.

Values are drawn in place, on the parameter's device and in its dtype,
from that device's generator (``random.generator``): drawing an 8B-value
model in host numpy and copying it over would take minutes and tens of
GB of host memory.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from . import random as _random

_INIT_REGISTRY = {}


def register(klass):
    """Register an initializer under its lowercased class name
    (reference ``mx.init.register``)."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs):
    if init is None:
        return None
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        name = init.lower()
        if name not in _INIT_REGISTRY:
            raise MXNetError(f"unknown initializer {init!r}; registered: "
                             f"{sorted(_INIT_REGISTRY)}")
        return _INIT_REGISTRY[name](**kwargs)
    raise MXNetError(f"cannot create initializer from {init!r}")


class Initializer:
    """Base initializer; ``__call__(name, arr)`` fills the NDArray ``arr``
    in place, dispatching on the parameter name's suffix as the reference
    does: biases, betas and running means get zeros, gammas and running
    variances ones, everything else ``_init_weight``."""

    def __call__(self, name, arr):
        name = str(name).lower()
        with torch.no_grad():
            if name.endswith(("bias", "beta", "running_mean",
                              "moving_mean")):
                self._init_zero(name, arr)
            elif name.endswith(("gamma", "running_var", "moving_var")):
                self._init_one(name, arr)
            else:
                self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    @staticmethod
    def _init_zero(name, arr):
        arr._data.zero_()

    @staticmethod
    def _init_one(name, arr):
        arr._data.fill_(1.0)

    @staticmethod
    def _generator(arr):
        return _random.generator(arr._data.device)


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        self._init_zero(name, arr)


_INIT_REGISTRY["zeros"] = Zero


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(name, arr)


_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init_weight(self, name, arr):
        arr._data.fill_(self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale) — reference default scale 0.07."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, name, arr):
        arr._data.uniform_(-self.scale, self.scale,
                           generator=self._generator(arr))


@register
class Normal(Initializer):
    """N(0, sigma) — reference default sigma 0.01."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr._data.normal_(0.0, self.sigma, generator=self._generator(arr))

"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (reference
``python/mxnet/initializer.py``): the registry, the name-pattern dispatch
(weight→init, bias→zero, gamma→one, ...) and Zero/One/Constant/Uniform/
Normal/Orthogonal/Xavier/MSRAPrelu/Bilinear/LSTMBias/Mixed.

Values are drawn in place, on the parameter's device and in its dtype,
from that device's generator (``random.generator``): drawing an 8B-value
model in host numpy and copying it over would take minutes and tens of
GB of host memory.
"""
from __future__ import annotations

import math
import re

import numpy as np
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


class InitDesc(str):
    """A parameter name carrying init attributes (reference
    ``InitDesc``); initializers take it where they take a name."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer; ``__call__(name, arr)`` fills the NDArray ``arr``
    in place, dispatching on the parameter name's suffix as the reference
    does: biases, betas and running means get zeros, gammas and running
    variances ones, everything else ``_init_weight``."""

    def __call__(self, name, arr):
        name = str(name).lower()
        with torch.no_grad():
            if name.endswith("bias"):
                self._init_bias(name, arr)
            elif name.endswith(("beta", "running_mean", "moving_mean")):
                self._init_zero(name, arr)
            elif name.endswith(("gamma", "running_var", "moving_var")):
                self._init_one(name, arr)
            else:
                self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_bias(self, name, arr):
        self._init_zero(name, arr)

    @staticmethod
    def _set(arr, value):
        """Copy a host array into ``arr`` (its dtype and device)."""
        arr._data.copy_(torch.as_tensor(np.asarray(value, dtype=np.float32)))

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


Zeros = Zero


_INIT_REGISTRY["zeros"] = Zero


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(name, arr)


Ones = One


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


@register
class Xavier(Initializer):
    """Glorot init (reference ``mx.init.Xavier``): U(-s, s) or N(0, s) with
    s = sqrt(magnitude / factor), factor the average of fan-in and
    fan-out (or either alone)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        if rnd_type not in ("uniform", "gaussian"):
            raise MXNetError(f"bad rnd_type {rnd_type!r}")
        if factor_type not in ("avg", "in", "out"):
            raise MXNetError(f"bad factor_type {factor_type!r}")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            fan_in = fan_out = float(shape[0]) if shape else 1.0
        else:
            hw_scale = float(math.prod(shape[2:]))
            fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / max(factor, 1.0))
        if self.rnd_type == "uniform":
            arr._data.uniform_(-scale, scale,
                               generator=self._generator(arr))
        else:
            arr._data.normal_(0.0, scale, generator=self._generator(arr))


@register
class Orthogonal(Initializer):
    """A (scaled) orthonormal matrix of the weight's (out, in) shape, from
    the SVD of a U(-1, 1) or N(0, 1) draw (reference ``Orthogonal``)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        gen = self._generator(arr)
        dev = arr._data.device
        if self.rand_type == "uniform":
            tmp = torch.rand((nout, nin), generator=gen, device=dev) * 2 - 1
        else:
            tmp = torch.randn((nout, nin), generator=gen, device=dev)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        arr._data.copy_((self.scale * q).reshape(arr.shape))


@register
class MSRAPrelu(Xavier):
    """He initialization (reference ``MSRAPrelu``): gaussian Xavier with
    magnitude 2 / (1 + slope²)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a deconvolution weight
    (reference ``Bilinear``)."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(math.prod(shape))
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        w = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        self._set(arr, w.reshape(shape))


@register
class LSTMBias(Initializer):
    """LSTM bias: 0, with the forget gate's quarter at ``forget_bias``
    (reference ``LSTMBias``)."""

    def __init__(self, forget_bias=1.0):
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = np.zeros(arr.shape, dtype=np.float32)
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)

    _init_bias = _init_weight


@register
class Mixed(Initializer):
    """The first initializer whose pattern matches the parameter's name
    (reference ``Mixed``)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers length mismatch")
        self.map = [(re.compile(p), create(i)) for p, i in
                    zip(patterns, initializers)]

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise MXNetError(f"parameter {name} did not match any pattern; add "
                         "'.*' as the last pattern")

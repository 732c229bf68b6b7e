"""Gluon basic layers: HybridSequential, Dense, BatchNorm, Flatten and
Embedding.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``.  The other layers
(Dropout, LayerNorm, ...) port with the op library (ROADMAP Queue 1).

``HybridSequential`` runs each ``Conv2D → BatchNorm → Activation("relu")``
run of its children whose conv is 1×1 (pad 0, dilation 1, one group,
NCHW, no activation of its own) and whose BatchNorm normalizes axis 1 as
one fused op (``ops/conv_bn_relu.py``), on the two conditions under which
folding the BatchNorm into the conv is exact: BatchNorm uses its moving
statistics (``not autograd.is_training() or use_global_stats``, the
reference ``batch_norm``'s own test) and no gradient is recorded (the
fused kernel has no backward).  In ResNet-50 v1 that is the first three
layers of each bottleneck's body: 16 fused calls a forward.
"""
from __future__ import annotations

import math

import torch

from ... import autograd
from ...base import resolve_dtype
from ...ops.conv_bn_relu import conv1x1_bn_relu
from ...ops.registry import apply_op
from ..block import HybridBlock
from .activations import Activation
from .conv_layers import Conv2D

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Flatten", "Embedding"]


def _fusable(conv, bn, act):
    """Whether three consecutive children are a 1×1 conv, a BatchNorm
    over the channel axis and a ReLU."""
    return (isinstance(conv, Conv2D) and isinstance(bn, BatchNorm) and
            isinstance(act, Activation) and act._act_type == "relu" and
            conv._kernel == (1, 1) and conv._padding == (0, 0) and
            conv._dilation == (1, 1) and conv._groups == 1 and
            conv._layout == "NCHW" and conv.act is None and bn._axis == 1)


def _conv1x1_bn_relu(x, conv, bn):
    """``bn(conv(x))`` then relu, as one ``conv1x1_bn_relu``."""
    conv_p = conv._param_data(x)
    bn._init_channels(conv._channels)
    bn_p = bn._param_data()
    has_bias = "bias" in conv_p

    def f(xr, wr, *rest):
        return conv1x1_bn_relu(xr, wr, rest[0] if has_bias else None,
                               *rest[-4:], bn._epsilon, conv._strides,
                               not bn._scale)

    args = [x, conv_p["weight"]] + ([conv_p["bias"]] if has_bias else []) \
        + [bn_p[k] for k in ("gamma", "beta", "running_mean",
                             "running_var")]
    return apply_op(f, *args, name="conv1x1_bn_relu")


class HybridSequential(HybridBlock):
    """Hybridizable Sequential (reference ``nn.HybridSequential``), with
    the inference fusion of 1×1 conv, BatchNorm and ReLU."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        blocks = list(self._children.values())
        fold_bn = not autograd.is_recording()
        training = autograd.is_training()
        i = 0
        while i < len(blocks):
            if fold_bn and i + 2 < len(blocks) and \
                    _fusable(*blocks[i:i + 3]) and \
                    (not training or blocks[i + 1]._use_global_stats):
                x = _conv1x1_bn_relu(x, blocks[i], blocks[i + 1])
                i += 3
            else:
                x = blocks[i](x)
                i += 1
        return x

    def __iter__(self):
        return iter(self._children.values())

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        return list(self._children.values())[key]


class Dense(HybridBlock):
    """Fully-connected layer y = x·Wᵀ + b, weight stored (units, in_units)
    as the reference does.  ``flatten=True`` first folds every axis after
    the first into one; ``activation`` is applied after."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype=torch.float32, weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x):
        in_units = math.prod(x.shape[1:]) if self._flatten \
            else int(x.shape[-1])
        self.weight._finish_deferred_init((self._units, in_units))
        if self.bias is not None:
            self.bias._finish_deferred_init((self._units,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.fully_connected(x, weight, bias, num_hidden=self._units,
                                no_bias=bias is None, flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out


class BatchNorm(HybridBlock):
    """Batch normalization with moving statistics (reference
    ``nn.BatchNorm``).  ``F.batch_norm`` returns the moved statistics;
    the layer writes them into ``running_mean`` and ``running_var`` (in
    place) only when ``autograd.is_training()`` and not
    ``use_global_stats``.  The four parameters stay f32 under
    ``cast("bfloat16")`` / ``cast("float16")``, as in the reference."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,), grad_req="null",
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,), grad_req="null",
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x):
        self._init_channels(int(x.shape[self._axis]))

    def _init_channels(self, channels):
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p._finish_deferred_init((channels,))

    def cast(self, dtype):
        if resolve_dtype(dtype) in (torch.float16, torch.bfloat16):
            dtype = torch.float32
        return super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        y, new_mean, new_var = F.batch_norm(
            x, gamma, beta, running_mean, running_var,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis)
        if autograd.is_training() and not self._use_global_stats:
            with torch.no_grad():
                running_mean._data.copy_(new_mean._data)
                running_var._data.copy_(new_var._data)
        return y


class Flatten(HybridBlock):
    """(B, ...) → (B, prod(...))."""

    def hybrid_forward(self, F, x):
        return F.flatten(x)


class Embedding(HybridBlock):
    """Rows of the (input_dim, output_dim) table gathered by integer ids;
    out-of-range ids are clipped as in the reference."""

    def __init__(self, input_dim, output_dim, dtype=torch.float32,
                 weight_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer)

    def hybrid_forward(self, F, x, weight):
        def f(idx, w):
            return w[idx.long().clamp(0, w.shape[0] - 1)]

        return apply_op(f, x, weight, name="embedding")

"""Gluon basic layers: Sequential, HybridSequential, Dense, Dropout,
BatchNorm, LayerNorm, InstanceNorm, GroupNorm, Flatten, Embedding,
Lambda, HybridLambda, HybridConcatenate and Identity.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``, ``SyncBatchNorm``
included (its statistics summed over the process group, ``parallel``).

``HybridSequential`` runs each ``Conv2D → BatchNorm → Activation("relu")``
run of its children whose conv is 1×1 (pad 0, dilation 1, one group,
NCHW, no activation of its own) and whose BatchNorm normalizes axis 1 as
one fused op (``ops/conv_bn_relu.py``), on the two conditions under which
folding the BatchNorm into the conv is exact: BatchNorm uses its moving
statistics (``not autograd.is_training() or use_global_stats``, the
reference ``batch_norm``'s own test) and no gradient is recorded (the
fused kernel has no backward).  In ResNet-50 v1 that is the first three
layers of each bottleneck's body: 16 fused calls a forward; in MobileNet
v1 1.0 the 13 pointwise convolutions, in Inception v3 the 40 1×1
``_make_basic_conv``s (BatchNorm eps 0.001), in DenseNet-121 the 58
bottleneck 1×1 convolutions of the dense layers.  A run whose blocks
carry a forward hook or pre-hook, or whose conv had its forward rewritten
on the instance (``quantize_net``), runs block by block, as the
reference runs every run.  Observers (``Monitor``) do not unfuse a run:
they get the conv's and the BatchNorm's outputs from those layers,
computed for them alone, and the ReLU's from the fused op.
"""
from __future__ import annotations

import math

import torch

from ... import amp
from ... import autograd
from ...base import resolve_dtype
from ...ops.conv_bn_relu import conv1x1_bn_relu
from ...base import MXNetError
from ...ops.registry import apply_op
from ..block import Block, HybridBlock
from .activations import Activation
from .conv_layers import Conv2D

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "SyncBatchNorm", "Embedding", "Flatten", "LayerNorm",
           "InstanceNorm", "GroupNorm", "Lambda", "HybridLambda",
           "HybridConcatenate", "Identity"]


def _fusable(conv, bn, act):
    """Whether three consecutive children are a 1×1 conv, a BatchNorm
    over the channel axis and a ReLU that may run as one op: none of the
    three has a forward hook or pre-hook (the fused op calls none of
    them), and the conv's ``hybrid_forward`` is its class's (not one
    that ``contrib.quantization.quantize_net`` set on the instance)."""
    return (isinstance(conv, Conv2D) and isinstance(bn, BatchNorm) and
            isinstance(act, Activation) and act._act_type == "relu" and
            conv._kernel == (1, 1) and conv._padding == (0, 0) and
            conv._dilation == (1, 1) and conv._groups == 1 and
            conv._layout == "NCHW" and conv.act is None and bn._axis == 1
            and "hybrid_forward" not in conv.__dict__ and
            not any(b._forward_hooks or b._forward_pre_hooks
                    for b in (conv, bn, act)))


def _conv1x1_bn_relu(x, conv, bn):
    """``bn(conv(x))`` then relu, as one ``conv1x1_bn_relu``.  Under amp
    the conv's operands are cast as amp casts ``convolution``'s; the
    BatchNorm's stay as they are (``batch_norm`` is on neither list)."""
    conv_p = conv._param_data(x)
    bn._init_channels(conv._channels)
    bn_p = bn._param_data()
    has_bias = "bias" in conv_p

    def f(xr, wr, *rest):
        conv_raws = amp.maybe_cast_args(
            "convolution", [xr, wr] + ([rest[0]] if has_bias else []))
        xr, wr = conv_raws[:2]
        b = conv_raws[2] if has_bias else None
        return conv1x1_bn_relu(xr, wr, b, *rest[-4:], bn._epsilon,
                               conv._strides, not bn._scale)

    args = [x, conv_p["weight"]] + ([conv_p["bias"]] if has_bias else []) \
        + [bn_p[k] for k in ("gamma", "beta", "running_mean",
                             "running_var")]
    return apply_op(f, *args, name="conv1x1_bn_relu")


def _observe_fused(blocks, x, out):
    """Report a fused run's blocks to their observers (``Monitor``): the
    conv's and the BatchNorm's outputs from their own layers, computed
    for the observers alone, and the ReLU's from the fused op."""
    conv, bn, act = blocks
    if not (conv._observers or bn._observers or act._observers):
        return
    with autograd.pause():
        y = bn(conv(x))
    for obs in tuple(act._observers.values()):
        obs(act, (y,), out)


class _SequentialAccess:
    """add, iteration, len and indexing (a slice gives a new container of
    the same kind, under the same prefix) of the sequential blocks."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __iter__(self):
        return iter(self._children.values())

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers[key])
            return net
        return layers[key]


class Sequential(_SequentialAccess, Block):
    """Blocks run one after another (reference ``nn.Sequential``)."""

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_SequentialAccess, HybridBlock):
    """Hybridizable Sequential (reference ``nn.HybridSequential``), with
    the inference fusion of 1×1 conv, BatchNorm and ReLU."""

    def hybrid_forward(self, F, x):
        blocks = list(self._children.values())
        fold_bn = not autograd.is_recording()
        training = autograd.is_training()
        i = 0
        while i < len(blocks):
            if fold_bn and i + 2 < len(blocks) and \
                    _fusable(*blocks[i:i + 3]) and \
                    (not training or blocks[i + 1]._use_global_stats):
                x_in = x
                x = _conv1x1_bn_relu(x, blocks[i], blocks[i + 1])
                _observe_fused(blocks[i:i + 3], x_in, x)
                i += 3
            else:
                x = blocks[i](x)
                i += 1
        return x


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


class Dropout(HybridBlock):
    """Dropout at ``rate`` in training (``F.dropout``), the identity
    otherwise; ``axes`` share one draw along those axes."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.dropout(x, p=self._rate, axes=self._axes)
        return F.identity(x)


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


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` (reference ``nn.LayerNorm``):
    statistics in f32, output in the input's dtype; gamma and beta keep
    their own dtype (f32 unless cast) and meet bf16 activations under
    amp."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)

    def infer_shape(self, x):
        c = int(x.shape[self._axis])
        self.gamma._finish_deferred_init((c,))
        self.beta._finish_deferred_init((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.layer_norm(x, gamma, beta, axis=self._axis,
                            eps=self._epsilon)


class Flatten(HybridBlock):
    """(B, ...) → (B, prod(...))."""

    def hybrid_forward(self, F, x):
        return F.flatten(x)


class Embedding(HybridBlock):
    """Rows of the (input_dim, output_dim) table gathered by integer ids;
    out-of-range ids are clipped as in the reference.  ``matmul_lookup``
    computes them as a one-hot product (``F.embedding``); ``sparse_grad``
    marks the weight's ``grad_stype`` as ``"row_sparse"`` (so step fusion
    leaves it to the Trainer), and the gradient is dense, as the
    reference's op computes it."""

    def __init__(self, input_dim, output_dim, dtype=torch.float32,
                 weight_initializer=None, sparse_grad=False,
                 matmul_lookup=False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._matmul_lookup = matmul_lookup
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim,
                           matmul_lookup=self._matmul_lookup)


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (reference ``nn.SyncBatchNorm``,
    ``contrib/sync_batch_norm.cc``): in training its statistics and its
    input gradient cover the batch of every rank (``ops.nn_ops.
    _SyncBNTrain``: the forward all-reduces (Σx, Σx², count), the
    backward (Σdy, Σdy·x̂)), with the reference's population variance,
    ``momentum`` (the weight of the old moving value) and ``fix_gamma``.
    Each rank's own batch (plain tensors) sums over the whole process
    group; an input over a mesh sums over its ``dp`` axis.  Without a
    process group, or in inference, it is ``BatchNorm``.  ``num_devices``
    is accepted and unused, as in the reference."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", prefix=None,
                 params=None, **kwargs):
        super().__init__(
            axis=1, momentum=momentum, epsilon=epsilon, center=center,
            scale=scale, use_global_stats=use_global_stats,
            beta_initializer=beta_initializer,
            gamma_initializer=gamma_initializer,
            running_mean_initializer=running_mean_initializer,
            running_variance_initializer=running_variance_initializer,
            in_channels=in_channels, prefix=prefix, params=params)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        if not autograd.is_training() or self._use_global_stats:
            return super().hybrid_forward(F, x, gamma, beta, running_mean,
                                          running_var)
        from ...ops.nn_ops import sync_batch_norm

        y, new_mean, new_var = sync_batch_norm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            axis=self._axis)
        with torch.no_grad():
            running_mean._data.copy_(new_mean._data)
            running_var._data.copy_(new_var._data)
        return y


class _ChannelNorm(HybridBlock):
    """gamma and beta of the channel axis (1), deferred until the first
    input."""

    def __init__(self, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)

    def infer_shape(self, x):
        c = int(x.shape[1])
        self.gamma._finish_deferred_init((c,))
        self.beta._finish_deferred_init((c,))


class InstanceNorm(_ChannelNorm):
    """Each sample's channels normalized over the spatial axes (reference
    ``nn.InstanceNorm``; ``axis`` is accepted, the channel axis is 1)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.instance_norm(x, gamma, beta, eps=self._epsilon)


class GroupNorm(_ChannelNorm):
    """Channels normalized in ``num_groups`` groups (reference
    ``nn.GroupNorm``)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)
        self._num_groups = num_groups

    def hybrid_forward(self, F, x, gamma, beta):
        return F.group_norm(x, gamma, beta, num_groups=self._num_groups,
                            eps=self._epsilon)


class Lambda(Block):
    """An NDArray function (or the name of an ``nd`` op) as a Block
    (reference ``nn.Lambda``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd

            function = getattr(nd, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """A function of the inputs (or the name of an ``F`` op) as a
    HybridBlock (reference ``nn.HybridLambda``, which calls it without
    ``F``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_name, self._func = function, None
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "lambda")

    def hybrid_forward(self, F, *args):
        return (self._func or getattr(F, self._func_name))(*args)


class HybridConcatenate(_SequentialAccess, HybridBlock):
    """Every child on the same input, the outputs joined along ``axis``
    (reference ``nn.HybridConcatenate``)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    """The input, copied (reference ``nn.Identity``)."""

    def hybrid_forward(self, F, x):
        return F.identity(x)

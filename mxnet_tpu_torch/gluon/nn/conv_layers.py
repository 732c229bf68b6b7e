"""Convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``Conv2D`` (with
deferred ``in_channels``), ``MaxPool2D``, ``AvgPool2D`` and
``GlobalAvgPool2D``, as far as the ResNet slice needs.  The 1D and 3D
layers, the transposed convolutions and the global max pools raise
``MXNetError`` naming ROADMAP.md.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D",
           "Conv1D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool3D", "AvgPool1D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool3D"]


def _ntuple(val, n):
    if isinstance(val, (list, tuple)):
        return tuple(int(v) for v in val)
    return (int(val),) * n


class _Conv(HybridBlock):
    """N-d convolution over a channel-first layout; weight
    (channels, in_channels/groups, *kernel), ``in_channels`` inferred at
    the first forward when 0."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if not layout.startswith("NC"):
            raise MXNetError(f"layout {layout!r}: the channel-first layouts "
                             "are ported (ROADMAP.md, Queue 1 item 2)")
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = kernel_size
        self._strides = strides
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._layout = layout
        with self.name_scope():
            wshape = (channels, in_channels // groups if in_channels else 0) \
                + kernel_size
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x):
        c = int(x.shape[1])
        self._in_channels = c
        shape = list(self.weight.shape)
        shape[1] = c // self._groups
        self.weight._finish_deferred_init(tuple(shape))
        if self.bias is not None:
            self.bias._finish_deferred_init((self._channels,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.convolution(
            x, weight, bias, kernel=self._kernel, stride=self._strides,
            dilate=self._dilation, pad=self._padding,
            num_filter=self._channels, num_group=self._groups,
            no_bias=bias is None)
        if self.act is not None:
            out = self.act(out)
        return out


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _ntuple(kernel_size, 2),
                         _ntuple(strides, 2), _ntuple(padding, 2),
                         _ntuple(dilation, 2), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=True, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._pool_size = pool_size
        self._strides = strides if strides is not None else pool_size
        self._padding = padding
        self._ceil_mode = ceil_mode
        self._global_pool = global_pool
        self._pool_type = pool_type
        self._count_include_pad = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.pooling(
            x, kernel=self._pool_size, pool_type=self._pool_type,
            global_pool=self._global_pool, stride=self._strides,
            pad=self._padding,
            pooling_convention="full" if self._ceil_mode else "valid",
            count_include_pad=self._count_include_pad)


class MaxPool2D(_Pooling):
    """Max over windows; the padding is −inf and the output size floors
    (``ceil_mode=False``: ``pooling_convention="valid"``)."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_ntuple(pool_size, 2),
                         _ntuple(strides, 2) if strides is not None else None,
                         _ntuple(padding, 2), ceil_mode, False, "max",
                         **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_ntuple(pool_size, 2),
                         _ntuple(strides, 2) if strides is not None else None,
                         _ntuple(padding, 2), ceil_mode, False, "avg",
                         count_include_pad, **kwargs)


class GlobalAvgPool2D(_Pooling):
    """Mean over H and W, keeping them: (B, C, H, W) → (B, C, 1, 1)."""

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, "avg", **kwargs)


def _not_ported(name):
    def __init__(self, *args, **kwargs):
        raise MXNetError(f"gluon.nn.{name} is not ported yet (ROADMAP.md, "
                         "Queue 1 item 2)")

    return type(name, (HybridBlock,), {"__init__": __init__})


Conv1D = _not_ported("Conv1D")
Conv3D = _not_ported("Conv3D")
Conv1DTranspose = _not_ported("Conv1DTranspose")
Conv2DTranspose = _not_ported("Conv2DTranspose")
Conv3DTranspose = _not_ported("Conv3DTranspose")
MaxPool1D = _not_ported("MaxPool1D")
MaxPool3D = _not_ported("MaxPool3D")
AvgPool1D = _not_ported("AvgPool1D")
AvgPool3D = _not_ported("AvgPool3D")
GlobalMaxPool1D = _not_ported("GlobalMaxPool1D")
GlobalMaxPool2D = _not_ported("GlobalMaxPool2D")
GlobalMaxPool3D = _not_ported("GlobalMaxPool3D")
GlobalAvgPool1D = _not_ported("GlobalAvgPool1D")
GlobalAvgPool3D = _not_ported("GlobalAvgPool3D")

"""Convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``Conv1D/2D/3D``
and their transposes (with deferred ``in_channels``), the max, average,
global max and global average pools in 1, 2 and 3 dimensions, and
``ReflectionPad2D``.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D",
           "Conv1D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool3D", "AvgPool1D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _ntuple(val, n):
    if isinstance(val, (list, tuple)):
        return tuple(int(v) for v in val)
    return (int(val),) * n


class _Conv(HybridBlock):
    """N-d convolution over a channel-first layout; weight
    (channels, in_channels/groups, *kernel), or (in_channels,
    channels/groups, *kernel) when ``transposed``; ``in_channels``
    inferred at the first forward when 0."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", transposed=False,
                 output_padding=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if not layout.startswith("NC"):
            raise MXNetError(f"layout {layout!r}: the channel-first layouts "
                             "only, as in the reference")
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = kernel_size
        self._strides = strides
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._layout = layout
        self._transposed = transposed
        self._output_padding = output_padding
        with self.name_scope():
            if transposed:
                wshape = (in_channels, channels // groups) + kernel_size
            else:
                wshape = (channels, in_channels // groups if in_channels
                          else 0) + kernel_size
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
        if self._transposed:
            shape[0] = c
        else:
            shape[1] = c // self._groups
        self.weight._finish_deferred_init(tuple(shape))
        if self.bias is not None:
            self.bias._finish_deferred_init((self._channels,))

    def hybrid_forward(self, F, x, weight, bias=None):
        if self._transposed:
            out = F.deconvolution(
                x, weight, bias, kernel=self._kernel, stride=self._strides,
                dilate=self._dilation, pad=self._padding,
                adj=self._output_padding, num_filter=self._channels,
                num_group=self._groups, no_bias=bias is None)
        else:
            out = F.convolution(
                x, weight, bias, kernel=self._kernel, stride=self._strides,
                dilate=self._dilation, pad=self._padding,
                num_filter=self._channels, num_group=self._groups,
                no_bias=bias is None)
        if self.act is not None:
            out = self.act(out)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _ntuple(kernel_size, 1),
                         _ntuple(strides, 1), _ntuple(padding, 1),
                         _ntuple(dilation, 1), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


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


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _ntuple(kernel_size, 3),
                         _ntuple(strides, 3), _ntuple(padding, 3),
                         _ntuple(dilation, 3), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


def _transposed(n, layout):
    """The transposed convolution of ``n`` spatial dims."""
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout=layout,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        _Conv.__init__(self, channels, _ntuple(kernel_size, n),
                       _ntuple(strides, n), _ntuple(padding, n),
                       _ntuple(dilation, n), groups, layout, in_channels,
                       activation, use_bias, weight_initializer,
                       bias_initializer, transposed=True,
                       output_padding=_ntuple(output_padding, n), **kwargs)

    return type(f"Conv{n}DTranspose", (_Conv,), {"__init__": __init__})


Conv1DTranspose = _transposed(1, "NCW")
Conv2DTranspose = _transposed(2, "NCHW")
Conv3DTranspose = _transposed(3, "NCDHW")


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


def _pool(n, pool_type, layout, doc):
    """The ``pool_type`` pooling layer of ``n`` spatial dims."""
    def __init__(self, pool_size=2, strides=None, padding=0, layout=layout,
                 ceil_mode=False, count_include_pad=True, **kwargs):
        _Pooling.__init__(
            self, _ntuple(pool_size, n),
            _ntuple(strides, n) if strides is not None else None,
            _ntuple(padding, n), ceil_mode, False, pool_type,
            count_include_pad, **kwargs)

    name = {"max": "Max", "avg": "Avg"}[pool_type] + f"Pool{n}D"
    return type(name, (_Pooling,), {"__init__": __init__, "__doc__": doc})


def _global_pool(n, pool_type, layout):
    """The global ``pool_type`` pooling layer of ``n`` spatial dims: the
    spatial axes reduced to 1."""
    def __init__(self, layout=layout, **kwargs):
        _Pooling.__init__(self, (1,) * n, None, (0,) * n, False, True,
                          pool_type, **kwargs)

    name = "Global" + {"max": "Max", "avg": "Avg"}[pool_type] + f"Pool{n}D"
    return type(name, (_Pooling,), {"__init__": __init__})


_MAX_DOC = ("Max over windows; the padding is −inf and the output size "
            "floors (``ceil_mode=False``: ``pooling_convention=\"valid\"``; "
            "``True``: MXNet's \"full\" rule, padded explicitly).")
_AVG_DOC = ("Mean over windows (``count_include_pad=False`` divides by the "
            "input elements a window covers).")
MaxPool1D = _pool(1, "max", "NCW", _MAX_DOC)
MaxPool2D = _pool(2, "max", "NCHW", _MAX_DOC)
MaxPool3D = _pool(3, "max", "NCDHW", _MAX_DOC)
AvgPool1D = _pool(1, "avg", "NCW", _AVG_DOC)
AvgPool2D = _pool(2, "avg", "NCHW", _AVG_DOC)
AvgPool3D = _pool(3, "avg", "NCDHW", _AVG_DOC)
GlobalMaxPool1D = _global_pool(1, "max", "NCW")
GlobalMaxPool2D = _global_pool(2, "max", "NCHW")
GlobalMaxPool3D = _global_pool(3, "max", "NCDHW")
GlobalAvgPool1D = _global_pool(1, "avg", "NCW")
GlobalAvgPool2D = _global_pool(2, "avg", "NCHW")
GlobalAvgPool3D = _global_pool(3, "avg", "NCDHW")


class ReflectionPad2D(HybridBlock):
    """H and W padded by reflection (reference ``nn.ReflectionPad2D``)."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._padding = _ntuple(padding, 2)

    def hybrid_forward(self, F, x):
        ph, pw = self._padding
        return F.pad(x, mode="reflect",
                     pad_width=(0, 0, 0, 0, ph, ph, pw, pw))

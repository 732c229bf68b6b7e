"""Gluon basic layers: Dense, Embedding and HybridSequential.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``.  The other layers
(Dropout, BatchNorm, LayerNorm, ...) port with the training slices
(ROADMAP Queue 1).
"""
from __future__ import annotations

import math

import torch

from ...base import MXNetError
from ...ops.registry import apply_op
from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "Embedding"]


class HybridSequential(HybridBlock):
    """Hybridizable Sequential (reference ``nn.HybridSequential``)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
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
    the first into one."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype=torch.float32, weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if activation is not None:
            raise MXNetError(
                "Dense(activation=...) ports with nn.Activation "
                "(ROADMAP.md, Queue 1, \"Left out of slice 1\")")
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

    def infer_shape(self, x):
        in_units = math.prod(x.shape[1:]) if self._flatten \
            else int(x.shape[-1])
        self.weight._finish_deferred_init((self._units, in_units))
        if self.bias is not None:
            self.bias._finish_deferred_init((self._units,))

    def hybrid_forward(self, F, x, weight, bias=None):
        flatten = self._flatten

        def f(xr, wr, *b):
            if flatten:
                xr = xr.reshape(xr.shape[0], -1)
            y = torch.matmul(xr, wr.t())
            return y + b[0] if b else y

        args = (x, weight) if bias is None else (x, weight, bias)
        return apply_op(f, *args, name="fully_connected")


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

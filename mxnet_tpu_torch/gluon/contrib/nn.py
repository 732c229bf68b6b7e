"""gluon.contrib.nn layers.

Counterpart of ``mxnet_tpu/gluon/contrib/nn.py`` (reference
``python/mxnet/gluon/contrib/nn/basic_layers.py``): ``Concurrent``/
``HybridConcurrent`` (branches on one input, concatenated), ``Identity``,
``SparseEmbedding`` (an ``Embedding`` whose weight's gradient storage is
``row_sparse``, so ``Trainer`` updates only the rows a batch touched),
``SyncBatchNorm`` (``nn.SyncBatchNorm``) and ``PixelShuffle1D/2D/3D``
with the reference's channel-major ordering (each output channel's
``f`` sub-positions come from ``f`` consecutive input channels).
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ..block import HybridBlock
from .. import nn as _nn

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class HybridConcurrent(HybridBlock):
    """Run the children on the same input, concatenate along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def hybrid_forward(self, F, x):
        out = [child(x) for child in self._children.values()]
        return F.concat(*out, dim=self.axis)


class Concurrent(HybridConcurrent):
    """The reference's imperative variant."""


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(_nn.Embedding):
    """Reference ``contrib.nn.SparseEmbedding``: ``Embedding`` with a
    ``row_sparse`` gradient storage type (``Trainer`` takes the lazy
    rows)."""

    def __init__(self, input_dim, output_dim, dtype=torch.float32,
                 weight_initializer=None, prefix=None, params=None):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer,
                         sparse_grad=True, prefix=prefix, params=params)


SyncBatchNorm = _nn.SyncBatchNorm


class _PixelShuffle(HybridBlock):
    def __init__(self, factor, ndim, **kwargs):
        super().__init__(**kwargs)
        self._factors = (factor,) * ndim if isinstance(factor, int) \
            else tuple(factor)
        if len(self._factors) != ndim:
            raise MXNetError(f"factor must have {ndim} elements")

    def hybrid_forward(self, F, x):
        from ...ops.registry import apply_op

        fs = self._factors
        k = len(fs)

        def shuffle(a):
            n, c_in, *sp = a.shape
            c = c_in // torch.Size(fs).numel()
            # (n, c, f1..fk, s1..sk) -> (n, c, s1, f1, ..., sk, fk)
            a = a.reshape(n, c, *fs, *sp)
            order = [0, 1] + [i for j in range(k) for i in (2 + k + j, 2 + j)]
            a = a.permute(*order)
            return a.reshape(n, c, *(s * f for s, f in zip(sp, fs)))

        return apply_op(shuffle, x, name=f"pixel_shuffle{k}d")


class PixelShuffle1D(_PixelShuffle):
    """(N, C·f, W) → (N, C, W·f) (reference ``PixelShuffle1D``)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 1, **kwargs)


class PixelShuffle2D(_PixelShuffle):
    """(N, C·f1·f2, H, W) → (N, C, H·f1, W·f2)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 2, **kwargs)


class PixelShuffle3D(_PixelShuffle):
    """(N, C·f1·f2·f3, D, H, W) → (N, C, D·f1, H·f2, W·f3)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 3, **kwargs)

"""Activation layers (counterpart of ``mxnet_tpu/gluon/nn/activations.py``):
``Activation``.  LeakyReLU, PReLU, ELU, SELU, GELU and Swish port with the
op library (ROADMAP.md, Queue 1 item 2)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    """Applies the ``activation`` nonlinearity (``F.activation``)."""

    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.activation(x, act_type=self._act_type)

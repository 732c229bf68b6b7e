"""Activation layers (counterpart of ``mxnet_tpu/gluon/nn/activations.py``):
``Activation``, ``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU`` (the
erf form) and ``Swish``."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


class Activation(HybridBlock):
    """Applies the ``activation`` nonlinearity (``F.activation``)."""

    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.activation(x, act_type=self._act_type)


class LeakyReLU(HybridBlock):
    """x for x > 0, ``alpha``·x otherwise."""

    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned ``alpha`` of ``in_channels`` values
    (initialized to 0.25)."""

    def __init__(self, alpha_initializer=None, in_channels=1, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        from ... import initializer as init_mod

        if alpha_initializer is None:
            alpha_initializer = init_mod.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(in_channels,), init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.leaky_relu(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    """x for x > 0, ``alpha``·(exp(x) - 1) otherwise."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """The scaled ELU of Klambauer et al."""

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    """x·Φ(x), the erf form."""

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type="gelu")


class Swish(HybridBlock):
    """x·sigmoid(``beta``·x)."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)

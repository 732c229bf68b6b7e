"""Gluon layers (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .basic_layers import *  # noqa: F401,F403

"""The ``mx.mod`` namespace: legacy symbolic training API.

Counterpart of ``mxnet_tpu/module/__init__.py`` (reference
``python/mxnet/module/__init__.py``).
"""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule"]

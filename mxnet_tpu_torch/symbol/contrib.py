"""``mx.sym.contrib`` namespace.

Counterpart of ``mxnet_tpu/symbol/contrib.py`` (reference
``python/mxnet/symbol/contrib.py``): a symbol-level builder for every op
of ``nd.contrib`` that the registry holds, as in ``mx.sym``.
"""
from __future__ import annotations

from ..ndarray import contrib as _nd_contrib
from ..ops import registry as _registry
from .symbol import _sym_op

__all__ = []
for _name in _nd_contrib.__all__:
    if _registry.get_op(_name) is not None:
        globals()[_name] = _sym_op(_name)
        __all__.append(_name)
del _name

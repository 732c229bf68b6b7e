"""The ``mx.sym`` namespace.

Counterpart of ``mxnet_tpu/symbol/__init__.py`` (reference
``python/mxnet/symbol/__init__.py``, whose op wrappers are generated from
the C++ registry): every op of the registry (``ops/registry.py``) gets a
symbol-level builder that appends a graph node instead of running.
"""
from __future__ import annotations

from ..ops import registry as _registry
from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     zeros, ones, arange, _sym_op)
from . import contrib  # noqa: F401  (mx.sym.contrib namespace)

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones", "arange"]

# generate mx.sym.<op> for every registered op; ops land as module attrs so
# tab-completion and getattr both work (the reference generates these from
# the C++ registry at import)
for _opname in _registry.list_ops():
    if _opname in globals():
        continue
    globals()[_opname] = _sym_op(_opname)
    __all__.append(_opname)


def __getattr__(name):
    # ops registered after import (custom ops, plugins) resolve lazily
    if _registry.get_op(name) is not None:
        fn = _sym_op(name)
        globals()[name] = fn
        return fn
    raise AttributeError(f"module 'symbol' has no attribute {name!r}")

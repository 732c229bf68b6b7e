"""Public names of the reference that have no counterpart in the port,
with the ROADMAP.md list that owns each ("Not carried over"): reading
one raises ``MXNetError`` naming that list (never ``AttributeError``).
The modules with such names install ``refuse`` as their module
``__getattr__``."""
from __future__ import annotations

from .base import MXNetError

_NC = "Not carried over"

AUTOGRAD = {"Node": _NC}


def refuse(table, module):
    """A module ``__getattr__`` raising ``MXNetError`` for ``table``'s
    names and ``AttributeError`` for any other."""
    def __getattr__(name):
        if name in table:
            raise MXNetError(f"{module}.{name} has no counterpart in the "
                             f"port (ROADMAP.md, {table[name]})")
        raise AttributeError(f"module {module!r} has no attribute {name!r}")

    return __getattr__

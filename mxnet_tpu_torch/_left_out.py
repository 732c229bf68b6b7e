"""Public names of the reference that the port has not ported yet, with
the ROADMAP.md list that owns each: reading one raises ``MXNetError``
naming that list (never ``AttributeError``).  ``mx`` and the modules
with such names install ``refuse`` as their module ``__getattr__``."""
from __future__ import annotations

from .base import MXNetError

_7 = "Left out of slice 7"
_NC = "Not carried over"

# the reference's bulk segment compiler and async executor: a CUDA stream
# is already asynchronous (``engine.py``)
ENGINE = {
    **dict.fromkeys(("cached_vjp", "clear_segment_cache", "key_intern_stats",
                     "maybe_defer", "register_dispatch_callback",
                     "segment_cache_stats", "unregister_dispatch_callback"),
                    _7),
}

AUTOGRAD = {"Node": _NC}


def refuse(table, module):
    """A module ``__getattr__`` raising ``MXNetError`` for ``table``'s
    names and ``AttributeError`` for any other."""
    def __getattr__(name):
        if name in table:
            what = "has no counterpart in the port" \
                if table[name] == _NC else "is not ported yet"
            raise MXNetError(f"{module}.{name} {what} "
                             f"(ROADMAP.md, {table[name]})")
        raise AttributeError(f"module {module!r} has no attribute {name!r}")

    return __getattr__

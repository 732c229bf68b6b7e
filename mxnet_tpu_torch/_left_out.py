"""Public names of the reference that the port has not ported yet, with
the ROADMAP.md list that owns each: reading one raises ``MXNetError``
naming that list (never ``AttributeError``).  ``mx`` and ``nd`` install
``refuse`` as their module ``__getattr__``."""
from __future__ import annotations

from .base import MXNetError

_8E = "Queue 1 item 8e, sparse"
_8F = "Queue 1 item 8f, symbols and export"
_8G = "Queue 1 item 8g"
_9 = "Queue 1 item 9, observability and tooling"

MX = {
    **dict.fromkeys(("executor", "mod", "module", "model", "predictor",
                     "sym", "symbol"), _8F),
    **dict.fromkeys(("np", "npx", "numpy", "numpy_extension",
                     "operator", "rtc"), _8G),
    **dict.fromkeys(("monitor", "runtime", "sanitizer", "telemetry",
                     "test_utils", "util", "visualization", "viz"), _9),
}

ND = {
    "Custom": _8G,
    "cast_storage": _8E, "sparse": _8E,
}

CONTRIB = {"onnx": _8F, "symbol": _8F}


def refuse(table, module):
    """A module ``__getattr__`` raising ``MXNetError`` for ``table``'s
    names and ``AttributeError`` for any other."""
    def __getattr__(name):
        if name in table:
            raise MXNetError(f"{module}.{name} is not ported yet "
                             f"(ROADMAP.md, {table[name]})")
        raise AttributeError(f"module {module!r} has no attribute {name!r}")

    return __getattr__

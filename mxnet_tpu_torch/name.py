"""Automatic symbol naming.

Counterpart of ``mxnet_tpu/name.py`` (reference ``python/mxnet/name.py``):
a thread-local ``NameManager`` that assigns ``{op}{counter}`` names to
anonymous objects, plus ``Prefix`` which prepends a fixed prefix.
"""
from __future__ import annotations

import threading


class NameManager:
    """Assigns unique names per hint: ``fullyconnected0``, ``conv1``..."""

    _state = threading.local()

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        self._old = NameManager.current()
        NameManager._state.value = self
        return self

    def __exit__(self, *exc):
        NameManager._state.value = self._old

    @classmethod
    def current(cls):
        if getattr(cls._state, "value", None) is None:
            cls._state.value = NameManager()
        return cls._state.value


class Prefix(NameManager):
    """NameManager that prepends ``prefix`` to every generated name."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return name if name else self._prefix + super().get(name, hint)

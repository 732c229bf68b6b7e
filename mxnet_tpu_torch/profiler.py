"""The profiler: left out of slice 9 (ROADMAP.md, "Left out of slice 9").

Counterpart of ``mxnet_tpu/profiler.py``, whose per-op scopes the
reference's ``apply_op`` feeds while it runs; it ports over
``torch.profiler`` with observability (ROADMAP Queue 1 item 9).  Until
then every entry point that would start, scope or read a profile raises
``MXNetError``; ``is_running()`` is False, so nothing is ever recorded.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["set_config", "set_state", "is_running", "pause", "resume",
           "dump", "dumps", "Scope", "Marker"]


def _left_out(*args, **kwargs):
    raise MXNetError("the profiler (and the op registry's profiler hook) "
                     "is left out of slice 9 (ROADMAP.md, \"Left out of "
                     "slice 9\")")


set_config = set_state = pause = resume = dump = dumps = Scope = Marker = \
    _left_out


def is_running():
    return False

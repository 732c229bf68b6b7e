"""Engine semantics: the engine type, ``bulk`` and ``flush``.

Counterpart of the user surface of ``mxnet_tpu/engine.py`` (reference
``python/mxnet/engine.py`` and ``MXNET_ENGINE_TYPE``).  Device work is
already asynchronous here: every op is enqueued on the device's current
CUDA stream and the host runs ahead until a read (``asnumpy``,
``asscalar``) or a ``flush`` waits for it.  So the reference's deferred
bulk segments and their compiler (``_Segment``, ``cached_vjp``) have no
counterpart: ``bulk`` is accepted and changes nothing, and ``flush``
drains the current stream.  The switches of the reference's bulking and
async tiers (``set_bulk_enabled``, ``set_async_enabled``) are accepted
the same way and their reads report what was set; ``pending_ops`` is
always 0, ``async_stats`` all zeros, and ``shutdown_async`` drains the
stream as ``flush`` does.  The compiler's own entry points
(``cached_vjp``, ``maybe_defer``, the segment cache, the dispatch
callbacks) raise ``MXNetError`` naming ROADMAP.md's "Left out of slice
7".

``NaiveEngine`` is the user's choice of op-by-op execution, as in the
reference: the Trainer then updates each parameter with its own eager
rule instead of the fused multi-tensor kernel, and a hybridized block
runs eagerly instead of replaying a CUDA graph.  The port never chooses
it on its own.
"""
from __future__ import annotations

import contextlib
import os

import torch

from .base import MXNetError

__all__ = ["engine_type", "set_engine_type", "is_naive", "bulk",
           "set_bulk_size", "bulk_size", "flush", "set_bulk_enabled",
           "bulk_enabled", "set_async_enabled", "async_enabled",
           "async_stats", "pending_ops", "shutdown_async"]

_TYPES = ("ThreadedEnginePerDevice", "ThreadedEngine", "NaiveEngine")
_type = None
_bulk_size = 15
_bulk_on = os.environ.get("MXT_ENGINE_BULK", "0").strip().lower() in \
    ("1", "true", "yes", "on")
_async_on = os.environ.get("MXNET_ENGINE_ASYNC", "1").strip().lower() \
    not in ("0", "false", "no", "off")


def engine_type():
    """The engine type: ``MXT_ENGINE_TYPE`` or ``MXNET_ENGINE_TYPE`` from
    the environment (default ``ThreadedEnginePerDevice``), unless
    ``set_engine_type`` chose one."""
    global _type
    if _type is None:
        env = os.environ.get(
            "MXT_ENGINE_TYPE",
            os.environ.get("MXNET_ENGINE_TYPE", _TYPES[0]))
        if env not in _TYPES:  # not cached: a bad value raises every call
            raise MXNetError(f"unknown engine type {env!r}; one of "
                             f"{_TYPES}")
        _type = env
    return _type


def set_engine_type(name):
    """Choose the engine type at run time; returns it."""
    global _type
    if name not in _TYPES:
        raise MXNetError(f"unknown engine type {name!r}; one of {_TYPES}")
    _type = name
    return name


def is_naive():
    return engine_type() == "NaiveEngine"


def set_bulk_size(size):
    """Accepted for the reference API; returns the previous size."""
    global _bulk_size
    prev, _bulk_size = _bulk_size, int(size)
    return prev


def bulk_size():
    return _bulk_size


@contextlib.contextmanager
def bulk(size):
    """``with engine.bulk(n):`` — accepted; ops are enqueued on the CUDA
    stream as they come in any case.  The stream is drained on exit, as
    the reference flushes its segment there."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
        flush()


def flush(reason="explicit"):
    """Wait until every op enqueued so far on the current device's stream
    has run; a device fault raises here.  Returns 0 (no op is ever held
    back on the host)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()
    return 0


def set_bulk_enabled(flag):
    """Accepted for the reference API (its deferred dispatch); returns
    the previous setting and drains the stream when turned off, as the
    reference flushes its segment."""
    global _bulk_on
    prev, _bulk_on = _bulk_on, bool(flag)
    if not _bulk_on:
        flush()
    return prev


def bulk_enabled():
    return _bulk_on


def set_async_enabled(flag):
    """Accepted for the reference API (its async executor tier); returns
    the previous setting and drains the stream when turned off."""
    global _async_on
    prev, _async_on = _async_on, bool(flag)
    if not _async_on:
        flush()
    return prev


def async_enabled():
    return _async_on


def async_stats():
    """The reference's async-tier counters: no segment is ever held back
    on the host here, so all are 0."""
    return {"submitted": 0, "stitched_segments": 0, "stitched_inputs": 0,
            "max_queue_depth": 0, "wait_ms": 0.0}


def pending_ops():
    """Ops held back on the host: always 0 (each op is enqueued on the
    stream as it comes)."""
    return 0


def shutdown_async(join=True):
    """Drain the stream, as ``flush`` does (there is no executor thread
    to stop)."""
    flush()


from . import telemetry  # noqa: E402,F401  (the reference's name)
from . import _left_out as _lo  # noqa: E402

__getattr__ = _lo.refuse(_lo.ENGINE, "mxnet_tpu_torch.engine")

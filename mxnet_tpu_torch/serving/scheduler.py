"""Request queue and the serving path's one host sync.

Counterpart of ``mxnet_tpu/serving/scheduler.py``.  Client threads
``put()`` requests into a bounded :class:`RequestQueue` (full →
:class:`ServerOverloadedError`, the backpressure contract); the
generative scheduler and the lanes take FIFO-head-compatible groups of
them (same length bucket).

Host-sync discipline: the ONE place the serving path waits on the card
is :func:`_materialize` — the copy of a batch's result tensors to the
host (``.cpu()``), at the batch boundary, after the whole batch was
dispatched.

The reference's ``BatchScheduler`` (dynamic batching for stateless
models, behind ``InferenceServer``) is the second half of ROADMAP Queue 1
item 6 and raises here ("Left out of slice 6").
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..base import MXNetError
from .protocol import ServerClosedError, ServerOverloadedError

__all__ = ["RequestQueue", "BatchScheduler"]


def _materialize(arrays):
    """THE designated result-materialization point: batch outputs →
    host numpy, one sync per batch after full dispatch.  Keep every
    device→host wait in the serving path inside this function.  On a
    card it first waits on an event, which releases the GIL (a blocking
    copy would hold it, and the other lane's Python would stall)."""
    if any(getattr(a, "is_cuda", False) for a in arrays):
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    out = []
    for a in arrays:
        if hasattr(a, "asnumpy"):
            out.append(a.asnumpy())
        elif hasattr(a, "cpu"):
            out.append(a.cpu().numpy())
        else:
            out.append(np.asarray(a))
    return out


class RequestQueue:
    """Thread-safe bounded FIFO with bucket-aware group take."""

    def __init__(self, capacity=64):
        self.capacity = int(capacity)
        self._items = []
        self._cond = threading.Condition()
        self._closed = False
        self._rejected = 0

    def __len__(self):
        with self._cond:
            return len(self._items)

    @property
    def rejected(self):
        with self._cond:
            return self._rejected

    def queued_tokens(self, weigh):
        """Sum ``weigh(req)`` over the queued requests under the lock —
        the dispatcher's load probe, so callers never reach into
        ``_items`` bare."""
        with self._cond:
            return sum(weigh(r) for r in self._items)

    def put(self, req):
        with self._cond:
            if self._closed:
                raise ServerClosedError("server is not accepting requests")
            if len(self._items) >= self.capacity:
                self._rejected += 1
                raise ServerOverloadedError(
                    f"request queue full ({self.capacity} pending); "
                    "retry with backoff")
            self._items.append(req)
            self._cond.notify_all()

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def wait_for_item(self, timeout):
        """Block until an item is queued (True) or timeout/closed."""
        with self._cond:
            if not self._items:
                self._cond.wait(timeout)
            return bool(self._items)

    def offer(self, req):
        """Non-raising ``put``: False when full/closed instead of an
        exception, and never counted as a rejection — the dispatcher's
        primitive for routing an ALREADY-accepted request to a replica
        queue (the client-facing backpressure happened at the front
        queue's ``put``)."""
        with self._cond:
            if self._closed or len(self._items) >= self.capacity:
                return False
            self._items.append(req)
            self._cond.notify_all()
            return True

    def take_group(self, key_fn, max_n):
        """Pop the FIFO head plus every queued request sharing its
        ``key_fn`` value (the length bucket), up to ``max_n``, keeping
        everything else in order.  Empty queue → []."""
        with self._cond:
            if not self._items:
                return []
            head_key = key_fn(self._items[0])
            taken, rest = [], []
            for r in self._items:
                if len(taken) < max_n and key_fn(r) == head_key:
                    taken.append(r)
                else:
                    rest.append(r)
            self._items = rest
            return taken

    def take_batch(self, key_fn, max_n, accept):
        """Like :meth:`take_group`, but each candidate must also pass
        ``accept(req)`` — the prefill lane's admission gate (cumulative
        KV block budget).  Stops at the FIRST head-bucket request the
        gate refuses, so admission stays FIFO within the bucket instead
        of starving a big request behind small ones."""
        with self._cond:
            if not self._items:
                return []
            head_key = key_fn(self._items[0])
            taken, rest = [], []
            gate_shut = False
            for r in self._items:
                if (not gate_shut and len(taken) < max_n
                        and key_fn(r) == head_key):
                    if accept(r):
                        taken.append(r)
                        continue
                    gate_shut = True
                rest.append(r)
            self._items = rest
            return taken


class BatchScheduler:
    """The reference's dynamic-batching loop for stateless models: not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "serving.BatchScheduler (dynamic batching for stateless "
            "models) is not ported yet (ROADMAP.md, Queue 1, \"Left out "
            "of slice 6\")")

"""Request queue, the stateless models' batching loop, and the serving
path's one host sync.

Counterpart of ``mxnet_tpu/serving/scheduler.py``.  Client threads
``put()`` requests into a bounded :class:`RequestQueue` (full →
:class:`ServerOverloadedError`, the backpressure contract);
:class:`BatchScheduler` (behind ``InferenceServer``), the generative
scheduler and the lanes take FIFO-head-compatible groups of them (same
length bucket).

Host-sync discipline: the ONE place the serving path waits on the card
is :func:`_materialize` — the copy of a batch's result tensors to the
host (``.cpu()``), at the batch boundary, after the whole batch was
dispatched.

The reference's telemetry spans, histograms and rolling summary
(``emit_summary``) come back with the serving side of the telemetry
package (ROADMAP Queue 1, "Left out of slice 19"); the counters
``batches``, ``completed`` and ``failed`` are here.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .bucketing import pad_batch
from .protocol import ServerClosedError, ServerOverloadedError

__all__ = ["RequestQueue", "BatchScheduler"]


def _materialize(arrays):
    """THE designated result-materialization point: batch outputs →
    host numpy, one sync per batch after full dispatch.  Keep every
    device→host wait in the serving path inside this function.  On a
    card it first waits on an event, which releases the GIL (a blocking
    copy would hold it, and the other lane's Python would stall)."""
    # an NDArray (what a block or a callable model returns) holds its
    # tensor in ``_data``
    if any(getattr(getattr(a, "_data", a), "is_cuda", False)
           for a in arrays):
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
    """The dynamic-batching loop for stateless (one forward) models.

    ``runner(batch_inputs)`` takes a dict name → stacked numpy array of
    one padded bucket shape and returns the model's outputs (NDArrays,
    tensors or arrays); ``InferenceServer`` builds it around a gluon
    block or a callable.  The loop waits for a request, dwells
    ``batch_window_ms`` so that concurrent submitters land in one batch,
    takes the queue's head and every queued request of its length
    bucket (up to ``max_batch``), pads them to the bucket's shape
    (``pad_batch``), runs them, waits for the result in
    ``_materialize`` and resolves each request's future with its own
    rows.  ``output_length_axis`` (optional) names the per-example output
    axis trimmed back to the request's true length at demux; None for
    pooled outputs (classifiers) that have no length axis."""

    def __init__(self, runner, policy, queue, length_axis=0,
                 output_length_axis=None, batch_window_ms=2.0, poll_s=0.05):
        self.runner = runner
        self.policy = policy
        self.queue = queue
        self.length_axis = int(length_axis)
        self.output_length_axis = output_length_axis
        self.batch_window_s = float(batch_window_ms) * 1e-3
        self.poll_s = float(poll_s)
        self.batches = 0
        self.completed = 0
        self.failed = 0
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="mxt-serving-sched",
                                        daemon=True)
        self._thread.start()

    def stop(self, drain=True):
        """Stop the loop; with ``drain`` (default) the queued requests are
        served first (on the calling thread), otherwise they fail with
        ServerClosedError."""
        self._stop.set()
        self.queue.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        leftovers = self.queue.take_group(lambda r: 0, 1 << 30)
        if drain and leftovers:
            for group in self._regroup(leftovers):
                self._serve_batch(group)
        else:
            for r in leftovers:
                r.future.set_exception(
                    ServerClosedError("server stopped before execution"))

    def _regroup(self, reqs):
        groups = {}
        for r in reqs:
            groups.setdefault(self._bucket_key(r), []).append(r)
        return [g[i:i + self.policy.max_batch]
                for g in groups.values()
                for i in range(0, len(g), self.policy.max_batch)]

    # -- the loop -------------------------------------------------------------
    def _bucket_key(self, req):
        return self.policy.length_bucket(req.length)

    def _loop(self):
        while not self._stop.is_set():
            if not self.queue.wait_for_item(self.poll_s):
                continue
            if self.batch_window_s > 0:
                time.sleep(self.batch_window_s)
            group = self.queue.take_group(self._bucket_key,
                                          self.policy.max_batch)
            if group:
                self._serve_batch(group)

    def _serve_batch(self, group):
        t_start = time.perf_counter()
        lb = self._bucket_key(group[0])
        bb = self.policy.batch_bucket(len(group))
        for r in group:
            r.t_start = t_start
            r.bucket = (bb, lb)
            r.batch_size = len(group)
        try:
            batch = {
                name: pad_batch([r.inputs[name] for r in group], bb, lb,
                                axis=self.length_axis)
                for name in group[0].inputs}
            outs = self.runner(batch)
            outs = _materialize(outs if isinstance(outs, (list, tuple))
                                else [outs])
        except Exception as exc:
            self.failed += len(group)
            for r in group:
                r.t_done = time.perf_counter()
                r.future.set_exception(exc)
            return
        self.batches += 1
        t_done = time.perf_counter()
        for i, r in enumerate(group):
            r.t_done = t_done
            self.completed += 1
            r.future.set_result(self._demux(outs, i, r.length))

    def _demux(self, outs, i, length):
        picked = []
        for o in outs:
            row = o[i]
            if self.output_length_axis is not None:
                row = np.take(row, np.arange(length),
                              axis=self.output_length_axis)
            picked.append(row)
        return picked if len(picked) > 1 else picked[0]


from .. import _left_out as _lo  # noqa: E402

__getattr__ = _lo.refuse(dict.fromkeys(("telemetry", "tracing"), _lo._19),
                         "mxnet_tpu_torch.serving.scheduler")

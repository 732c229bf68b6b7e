"""Request/response protocol for the serving layer.

Counterpart of ``mxnet_tpu/serving/protocol.py`` (the port keeps its own
copy).  A :class:`Request` is one unit of admitted work: identity,
timing and a completion handle (``future``, a
``concurrent.futures.Future``; ``future.result(timeout)`` is the client's
wait point).

Backpressure is explicit: a full queue raises
:class:`ServerOverloadedError` at submit time instead of buying
unbounded latency.  Clients treat it like HTTP 503 — back off and
retry.

A request carries its trace (``req.trace``, a ``telemetry.tracing.Trace``
or None while tracing is off) across the serving threads; its record
(:meth:`Request.record`) carries the trace id, and the servers keep the
records of finished requests (``GenerativeServer.request_records``).
"""
from __future__ import annotations

import itertools
import time
from concurrent.futures import Future

from ..base import MXNetError

__all__ = ["Request", "ServerOverloadedError", "ServerClosedError"]


class ServerOverloadedError(MXNetError):
    """The bounded request queue is full: the server sheds load at
    admission instead of queueing into unbounded latency.  Retry with
    backoff, or raise ``queue_capacity``."""


class ServerClosedError(MXNetError):
    """Submit after ``stop()`` (or before ``start()``)."""


_ids = itertools.count(1)


class Request:
    """One in-flight inference request.

    Generative requests carry ``prompt_ids`` (1-D int32) and
    ``max_new_tokens``.  Timing fields are filled in as the request
    moves through the pipeline and land in the per-request record:
    ``t_submit`` → ``t_start`` (dequeued into a batch; the delta is
    ``queue_wait_ms``) → ``t_first`` (first token emitted; delta from
    submit is ``ttft_ms``) → ``t_done``.
    """

    __slots__ = ("id", "inputs", "length", "prompt_ids", "max_new_tokens",
                 "future", "t_submit", "t_start", "t_first", "t_done",
                 "batch_size", "bucket", "slot", "joined_step",
                 "done_step", "replica", "t_handoff", "kv_blocks",
                 "trace", "tenant", "draft_tokens", "accepted_tokens",
                 "prefix_hit_tokens", "prefill_saved_ms")

    def __init__(self, inputs=None, length=None, prompt_ids=None,
                 max_new_tokens=None, tenant=None):
        self.id = next(_ids)
        self.inputs = inputs
        self.length = length
        self.prompt_ids = prompt_ids
        self.max_new_tokens = max_new_tokens
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.t_start = None
        self.t_first = None
        self.t_done = None
        self.batch_size = None
        self.bucket = None
        self.slot = None
        self.joined_step = None
        self.done_step = None
        # disaggregated-lane fields (paged path)
        self.replica = None     # which replica served the request
        self.t_handoff = None   # decode lane adopted the prefilled KV
        self.kv_blocks = None   # blocks reserved for the request
        # the request-scoped span context (None while tracing is off:
        # every serving call site guards on that None) and the SLO tenant
        self.trace = None
        self.tenant = tenant
        # speculative decoding + radix prefix cache
        self.draft_tokens = 0        # draft proposals scored for us
        self.accepted_tokens = 0     # proposals the target agreed with
        self.prefix_hit_tokens = None  # prompt tokens reused from cache
        self.prefill_saved_ms = None   # estimated prefill ms not spent

    def tpot_ms(self):
        """Time-per-output-token: decode milliseconds per generated
        token AFTER the first (TTFT owns the first) — None until done,
        and None for 1-token requests (no decode interval exists)."""
        if self.t_first is None or self.t_done is None or \
                not self.max_new_tokens or self.max_new_tokens < 2:
            return None
        return (self.t_done - self.t_first) * 1e3 \
            / (self.max_new_tokens - 1)

    def record(self, kind="serving.request", lane=None, status="ok",
               error=None):
        """The per-request record (made on completion, and — with
        ``status="error"`` — on the failure paths, so rejected or evicted
        requests still carry their replica and lane)."""
        rec = {
            "record": kind,
            "request_id": self.id,
            "status": status,
            "bucket": self.bucket,
            "batch_size": self.batch_size,
            "queue_wait_ms": (self.t_start - self.t_submit) * 1e3
            if self.t_start is not None else None,
            "total_ms": (self.t_done - self.t_submit) * 1e3
            if self.t_done is not None else None,
        }
        if lane is not None:
            rec["lane"] = lane
        if error is not None:
            rec["error"] = error
        if self.tenant is not None:
            rec["tenant"] = self.tenant
        if self.trace is not None:
            rec["trace_id"] = self.trace.trace_id
        if self.t_first is not None:
            rec["ttft_ms"] = (self.t_first - self.t_submit) * 1e3
        tpot = self.tpot_ms()
        if tpot is not None:
            rec["tpot_ms"] = tpot
        if self.slot is not None:
            rec["slot"] = self.slot
            rec["joined_step"] = self.joined_step
            rec["done_step"] = self.done_step
        if self.replica is not None:
            rec["replica"] = self.replica
        if self.kv_blocks is not None:
            rec["kv_blocks"] = self.kv_blocks
        if self.t_handoff is not None and self.t_first is not None:
            # prefill→decode KV handoff latency: first token emitted by
            # the prefill forward → decode lane adopted the slot
            rec["handoff_ms"] = (self.t_handoff - self.t_first) * 1e3
        if self.t_first is not None and self.t_start is not None:
            # prompt-processing wall time (dequeue → first token): the
            # figure the radix prefix cache exists to shrink
            rec["prefill_ms"] = (self.t_first - self.t_start) * 1e3
        if self.draft_tokens:
            rec["draft_tokens"] = self.draft_tokens
            rec["accepted_tokens"] = self.accepted_tokens
            rec["accept_rate"] = round(self.accepted_tokens
                                       / self.draft_tokens, 4)
        if self.prefix_hit_tokens is not None:
            rec["prefix_hit_tokens"] = self.prefix_hit_tokens
        if self.prefill_saved_ms is not None:
            rec["prefill_saved_ms"] = round(self.prefill_saved_ms, 3)
        return rec

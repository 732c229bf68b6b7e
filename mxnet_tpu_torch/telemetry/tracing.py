"""Request-scoped tracing and the flight recorder.

Counterpart of ``mxnet_tpu/telemetry/tracing.py``.  The serving path is
three threads deep (dispatcher → prefill lane → decode lane,
``serving/lanes.py``); every request carries its :class:`Trace` on the
``Request`` itself (``req.trace``) across those boundaries — no
thread-locals, since a request changes threads twice before its first
decode tick.  One completed trace is a connected parent→child tree::

    request                          (root, span id 1)
    ├── queue        dispatcher wait + bucket dwell
    ├── prefill      prompt forward + KV commit   [replica, slot,
    │                                              kv_blocks, mates]
    ├── handoff      prefill→decode KV adoption
    ├── decode.step  one per decode tick          [step, batch]
    ├── ...
    └── evict        slot/block release           (zero-duration)

Spans are recorded **retroactively** from the stamps the serving path
already takes (``t_submit``/``t_start``/``t_first``/…): the decode tick
pays one dict and one list append per traced slot.  A decode tick's
stamps close after the host has the tick's tokens (the lane's one
sync), so a ``decode.step`` span covers the card's work, not just its
launch.  Completed traces go to a ``{"record": "trace"}`` JSONL record
(``tools/trace_report.py`` rebuilds the tree from it), to the
profiler's chrome trace while it runs (``record_span_event``), and to
the flight recorder: a bounded ring of recent traces, dumped to JSON by
:func:`incident` on overload rejection, replica exception or OOM
(``memwatch`` embeds :func:`recent` in its post-mortem).  Dumps go to
``MXNET_TRACE_DUMP`` (or ``path=``) and are rate-limited per reason.

Disabled, ``start_trace`` is one module-boolean check returning None
and every serving call site guards on ``req.trace is not None``.
``MXNET_TRACING=1`` enables at import.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import deque

__all__ = ["enable", "disable", "is_enabled", "start_trace", "finish",
           "recent", "clear", "dump", "incident", "Trace",
           "RECORDER_CAPACITY"]

# -- state -------------------------------------------------------------------

_enabled = False
_trace_ids = itertools.count(1)

#: flight-recorder ring capacity (completed traces kept for dumps)
RECORDER_CAPACITY = 64

_ring_lock = threading.Lock()
_ring = deque(maxlen=RECORDER_CAPACITY)
_last_dump = {}   # reason -> monotonic stamp of the last dump
#: minimum seconds between two dumps for the SAME reason — an overload
#: storm writes one report, not one per rejected request
DUMP_INTERVAL_S = 5.0


def _telemetry():
    # the parent package imports this module at its own import time;
    # resolve it lazily through sys.modules to keep the cycle harmless
    return sys.modules.get("mxnet_tpu_torch.telemetry")


# -- spans -------------------------------------------------------------------

class _LiveSpan:
    """Context-manager form for code that brackets a region itself
    (tests/tools; the serving hot paths use :meth:`Trace.add`)."""

    __slots__ = ("trace", "name", "parent", "tags", "_t0")

    def __init__(self, trace, name, parent, tags):
        self.trace = trace
        self.name = name
        self.parent = parent
        self.tags = tags

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.trace.add(self.name, self._t0, time.perf_counter(),
                       parent=self.parent, **(self.tags or {}))
        return False


class Trace:
    """One request's span collection.  Thread-safe by construction:
    span ids come from a per-trace ``itertools.count`` and completed
    spans are appended to a plain list — both atomic under CPython —
    so the three lane threads never contend on a lock."""

    __slots__ = ("trace_id", "request_id", "tenant", "t0", "wall0",
                 "spans", "_ids", "root_id")

    def __init__(self, trace_id, request_id=None, tenant=None):
        self.trace_id = trace_id
        self.request_id = request_id
        self.tenant = tenant
        self.t0 = time.perf_counter()
        self.wall0 = time.time()
        self.spans = []
        self._ids = itertools.count(1)
        self.root_id = next(self._ids)   # root "request" span == id 1;
        # it is appended at finish() so its duration covers everything

    def add(self, name, t0, t1, parent=None, **tags):
        """Record a completed span retroactively from two
        ``perf_counter`` stamps.  Returns the span id (usable as a
        ``parent`` for children)."""
        sid = next(self._ids)
        self.spans.append({
            "id": sid,
            "parent": self.root_id if parent is None else parent,
            "name": name,
            "ts": t0,
            "dur_ms": (t1 - t0) * 1e3,
            "thread": threading.current_thread().name,
            "tags": tags,
        })
        return sid

    def event(self, name, parent=None, **tags):
        """Zero-duration marker (e.g. ``evict``)."""
        now = time.perf_counter()
        return self.add(name, now, now, parent=parent, **tags)

    def span(self, name, parent=None, **tags):
        """``with trace.span("phase"):`` — live-timed child span."""
        return _LiveSpan(self, name, parent, tags)


def enable():
    """Turn request tracing on.  Independent of ``telemetry.enable`` so
    the tracing-on-vs-off A/B can hold the telemetry arm fixed; enable
    both to get trace records on the JSONL stream (``telemetry.emit``
    is a no-op while telemetry is off — the flight-recorder ring still
    fills either way)."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def is_enabled():
    return _enabled


def start_trace(request_id=None, tenant=None):
    """A fresh :class:`Trace` for one request — or None while tracing
    is disabled (call sites guard on the None, the near-zero path)."""
    if not _enabled:
        return None
    return Trace(f"{os.getpid():x}-{next(_trace_ids):06x}",
                 request_id=request_id, tenant=tenant)


def finish(trace, status="ok", **root_tags):
    """Seal ``trace``: close the root span over the trace's whole
    lifetime, emit the ``trace`` JSONL record, mirror every span into
    the profiler's chrome-trace buffer when profiling, and push the
    trace into the flight-recorder ring.  Returns the record dict."""
    if trace is None:
        return None
    t1 = time.perf_counter()
    trace.spans.append({
        "id": trace.root_id,
        "parent": None,
        "name": "request",
        "ts": trace.t0,
        "dur_ms": (t1 - trace.t0) * 1e3,
        "thread": threading.current_thread().name,
        "tags": root_tags,
    })
    record = {
        "record": "trace",
        "trace_id": trace.trace_id,
        "request_id": trace.request_id,
        "tenant": trace.tenant,
        "status": status,
        "wall_time": trace.wall0,
        "t0": trace.t0,
        "total_ms": (t1 - trace.t0) * 1e3,
        "spans": list(trace.spans),
    }
    tel = _telemetry()
    if tel is not None:
        tel.emit(record)
        tel.count("tracing.finished")
    prof = sys.modules.get("mxnet_tpu_torch.profiler")
    if prof is not None and prof.is_running():
        for sp in record["spans"]:
            args = {"trace_id": trace.trace_id,
                    "request_id": trace.request_id}
            args.update(sp["tags"])
            prof.record_span_event(
                f"trace.{sp['name']}", sp["ts"], sp["dur_ms"] * 1e-3,
                cat="trace", args=args)
    with _ring_lock:
        _ring.append(record)
    return record


# -- flight recorder ---------------------------------------------------------

def recent(n=None):
    """The most recent completed trace records, oldest first (up to
    ``n``, default the whole ring)."""
    with _ring_lock:
        traces = list(_ring)
    return traces if n is None else traces[-int(n):]


def clear():
    """Empty the ring (tests)."""
    with _ring_lock:
        _ring.clear()
    _last_dump.clear()


def dump(path=None, reason="", context=None):
    """Write the flight record — reason, context, and every ring trace
    — to ``path`` (default ``MXNET_TRACE_DUMP`` or
    ``flight_record_<pid>.json`` in the cwd).  Returns the path."""
    if path is None:
        path = os.environ.get("MXNET_TRACE_DUMP") \
            or f"flight_record_{os.getpid()}.json"
    report = {
        "record": "flight_recorder",
        "reason": reason,
        "wall_time": time.time(),
        "context": context or {},
        "traces": recent(),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, default=str)
    tel = _telemetry()
    if tel is not None:
        tel.count("tracing.flight_dump")
    return path


def incident(reason, context=None, path=None):
    """The automatic dump hook for serving failure paths (overload
    rejection, replica exception, OOM).  Rate-limited per ``reason``
    (one dump per :data:`DUMP_INTERVAL_S`), never raises into the
    caller, returns the dump path or None when skipped."""
    if not _enabled:
        return None
    now = time.monotonic()
    with _ring_lock:
        last = _last_dump.get(reason)
        if last is not None and now - last < DUMP_INTERVAL_S:
            return None
        _last_dump[reason] = now
    try:
        return dump(path=path, reason=reason, context=context)
    except Exception:
        return None  # reporting never masks the original failure


if os.environ.get("MXNET_TRACING", "0") == "1":
    enable()

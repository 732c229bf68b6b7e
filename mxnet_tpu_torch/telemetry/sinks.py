"""Telemetry sinks: where per-step structured records go (counterpart of
``mxnet_tpu/telemetry/sinks.py``).

The JSONL sink is the trajectory-analysis surface: one self-contained
JSON object per line, so a regression between two runs can be
attributed (capture churn vs. comms vs. host sync) by diffing their
logs with nothing fancier than ``jq``.  The record's keys are the
reference's (``telemetry.step_end``); every record carries at least ``step``,
``step_ms``, ``phases_ms``, ``counters``, ``host_sync``,
``cachedop_cache_hit``/``cachedop_cache_miss``, ``compile_count`` and
``allreduce_bytes``.

The chrome-trace sink is not a class here: completed spans are mirrored
straight into ``profiler``'s event buffer (see ``telemetry._Span``), so
there is exactly one trace file and one timebase for op events and
phase spans.
"""
from __future__ import annotations

import glob as _glob
import json
import threading


class JsonlSink:
    """Append one JSON line per step record to ``path``.

    Writes are line-buffered and flushed per record — a crashed run
    keeps every completed step, which is the whole point of a
    structured flight recorder.  Thread-safe: concurrent ``step_end``
    calls (multi-threaded input pipelines driving their own steps)
    serialize on a sink-local lock rather than the telemetry module
    lock, keeping file I/O out of the recording critical section.
    """

    def __init__(self, path, append=False):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a" if append else "w", encoding="utf-8")

    def emit(self, record):
        line = json.dumps(record, default=_json_default)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class ListSink:
    """In-memory sink for tests and tooling: records accumulate on
    ``.records``."""

    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def close(self):
        pass


def _json_default(obj):
    """Best-effort coercion for numpy scalars and other number-likes
    that land in counters/gauges; never raises out of the sink."""
    try:
        return float(obj)
    except Exception:
        return repr(obj)


class JsonlRecords(list):
    """``read_jsonl``'s result: a plain list of record dicts (backward
    compatible with every indexing/iteration call site) plus a
    ``truncated`` attribute — True when the log ended mid-record (a
    crashed run's final partial write was skipped)."""

    truncated = False


def read_jsonl(path):
    """Parse a JSONL telemetry log back into a list of record dicts
    (skipping blank lines) — the analysis-side inverse of JsonlSink.

    A truncated FINAL line (the writer died mid-record) is tolerated:
    the complete records are returned with ``.truncated = True`` instead
    of raising ``json.JSONDecodeError``.  Corruption anywhere else in
    the file still raises — that is data loss, not a crash artifact.

    ``path`` may also be a list/tuple of paths or a glob pattern
    (``"out/rank*.jsonl"``): each stream is read as above, then the
    streams are stable-merged sorted by ``(step, rank)`` so per-rank
    logs from one run interleave into a single fleet-ordered list
    (records missing either key sort as 0; ``.truncated`` is True when
    ANY stream was truncated).  A single path returns records in file
    order, byte-identical to the old behavior."""
    if isinstance(path, (list, tuple)):
        paths = list(path)
    elif any(c in path for c in "*?["):
        paths = sorted(_glob.glob(path))
    else:
        return _read_one(path)
    merged = JsonlRecords()
    streams = [_read_one(p) for p in paths]
    for recs in streams:
        merged.extend(recs)
        if recs.truncated:
            merged.truncated = True
    merged.sort(key=lambda r: (r.get("step") or 0, r.get("rank") or 0)
                if isinstance(r, dict) else (0, 0))
    return merged


def _read_one(path):
    records = JsonlRecords()
    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    stripped = [ln.strip() for ln in lines]
    last_nonblank = max((i for i, ln in enumerate(stripped) if ln),
                        default=-1)
    for i, line in enumerate(stripped):
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            if i == last_nonblank:
                records.truncated = True
                break
            raise
    return records

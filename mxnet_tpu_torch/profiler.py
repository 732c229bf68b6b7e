"""The profiler.

Counterpart of ``mxnet_tpu/profiler.py`` (reference
``src/profiler/profiler.{h,cc}`` and ``python/mxnet/profiler.py``), with
its two layers:

1. Host-side op events.  While the profiler runs, ``ops.registry.
   apply_op`` times each op it dispatches and calls ``record_op_event``
   (the reference's engine workers wrap each operation the same way),
   under the name of the enclosing ``Scope`` (``"scope:op"``).  ``dump``
   writes them as chrome://tracing JSON, ``dumps`` aggregates them by
   name (count, total, min, max, mean in ms).  The time is the host's
   dispatch time: the card runs asynchronously.
2. The device trace.  With ``set_config(profile_device_trace=True)``,
   ``set_state("run")`` starts a ``torch.profiler`` trace of the CPU and
   (where there is a card) CUDA activity, and ``set_state("stop")`` ends
   it and writes it as a chrome trace beside ``filename``
   (``<name>_torch_trace.json``); ``device_profile()`` returns the
   ``torch.profiler.profile`` object of the last such run, whose
   ``key_averages()`` hold each kernel's device time.  This is where the
   reference starts ``jax.profiler``.

``MXNET_PROFILER_AUTOSTART=1`` starts a profile at import, as in the
reference.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict

from .base import MXNetError

__all__ = ["set_config", "set_state", "is_running", "pause", "resume",
           "dump", "dumps", "Scope", "Marker", "record_op_event",
           "record_span_event", "record_counter_event",
           "current_scope_prefix", "device_profile"]

_lock = threading.Lock()
_config = {
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "profile_device_trace": False,
    "filename": "profile.json",
    "aggregate_stats": False,
}
_state = "stop"
_events = []          # chrome trace events
_agg = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])  # n, tot, min, max
_t0 = None
_torch_prof = None    # the running device trace
_last_prof = None     # the last finished one


def set_config(**kwargs):
    """Configure (reference ``profiler.set_config``): the reference's
    keys (``profile_all``, ``profile_symbolic``, ``profile_imperative``,
    ``profile_memory``, ``profile_api``, ``filename``,
    ``aggregate_stats``) and ``profile_device_trace`` for the
    ``torch.profiler`` trace."""
    unknown = set(kwargs) - set(_config)
    if unknown:
        raise MXNetError(f"unknown profiler config keys {sorted(unknown)}")
    _config.update(kwargs)


def _start_device_trace():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   profile_memory=bool(_config["profile_memory"]))
    prof.__enter__()
    return prof


def set_state(state="stop"):
    """``"run"`` starts collecting events, ``"stop"`` ends it (reference
    ``profiler.set_state``); the chrome-trace epoch stays across a pause
    and resume."""
    global _state, _t0, _torch_prof, _last_prof
    if state not in ("run", "stop"):
        raise MXNetError("profiler state must be 'run' or 'stop'")
    if state == "run" and _state != "run":
        if _t0 is None:
            _t0 = time.perf_counter()
        if _config["profile_device_trace"]:
            _torch_prof = _start_device_trace()
    if state == "stop" and _state == "run" and _torch_prof is not None:
        prof, _torch_prof = _torch_prof, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            os.path.splitext(_config["filename"])[0] + "_torch_trace.json")
        _last_prof = prof
    _state = state


def is_running():
    return _state == "run"


def pause(profile_process="worker"):
    set_state("stop")


def resume(profile_process="worker"):
    set_state("run")


def device_profile():
    """The ``torch.profiler.profile`` of the last device trace (None
    before one has run)."""
    return _last_prof


def _tid():
    return threading.get_ident() % 100000


def _aggregate(name, dur_s):
    a = _agg[name]
    a[0] += 1
    a[1] += dur_s * 1e3
    a[2] = min(a[2], dur_s * 1e3)
    a[3] = max(a[3], dur_s * 1e3)


def record_op_event(name, dur_s, cat="operator"):
    """One dispatched op that took ``dur_s`` seconds and ended now
    (called by ``ops.registry.apply_op`` while the profiler runs)."""
    if _state != "run":
        return
    with _lock:
        ts = (time.perf_counter() - _t0) * 1e6
        _events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": ts - dur_s * 1e6, "dur": dur_s * 1e6,
            "pid": os.getpid(), "tid": _tid(),
        })
        _aggregate(name, dur_s)


def record_span_event(name, start_s, dur_s, cat="telemetry", args=None):
    """A finished span (``start_s`` a ``time.perf_counter()`` stamp) into
    the same timeline and table as the op events."""
    if _state != "run":
        return
    with _lock:
        if _t0 is None:
            return
        event = {
            "name": name, "cat": cat, "ph": "X",
            "ts": (start_s - _t0) * 1e6, "dur": dur_s * 1e6,
            "pid": os.getpid(), "tid": _tid(),
        }
        if args:
            event["args"] = {k: str(v) for k, v in args.items()}
        _events.append(event)
        _aggregate(name, dur_s)


def record_counter_event(name, values, ts_s=None):
    """A chrome-trace counter sample (``"ph": "C"``): one track per
    ``name``, one series per key of ``values``."""
    if _state != "run":
        return
    with _lock:
        if _t0 is None:
            return
        stamp = time.perf_counter() if ts_s is None else ts_s
        _events.append({
            "name": name, "cat": "memory", "ph": "C",
            "ts": (stamp - _t0) * 1e6, "pid": os.getpid(), "tid": _tid(),
            "args": {k: float(v) for k, v in values.items()},
        })


def dump(finished=True, profile_process="worker"):
    """Write the events as chrome://tracing JSON to ``filename``
    (reference ``profiler.dump``); ``finished=True`` stops the profile
    and starts the next one afresh."""
    global _t0
    if finished:
        set_state("stop")
    with _lock:
        payload = {"traceEvents": list(_events), "displayTimeUnit": "ms"}
        if finished:
            _events.clear()
            _t0 = None
    with open(_config["filename"], "w") as f:
        json.dump(payload, f)


def dumps(reset=False, format="table"):
    """The per-name aggregate (reference ``profiler.dumps``): a
    fixed-width table, or with ``format="json"`` a JSON object of name →
    {count, total_ms, min_ms, max_ms, avg_ms}."""
    if format not in ("table", "json"):
        raise MXNetError(
            f"unknown dumps format {format!r}; expected 'table' or 'json'")
    with _lock:
        rows = sorted(_agg.items(), key=lambda kv: -kv[1][1])
        if format == "json":
            out = json.dumps({
                name: {"count": n, "total_ms": tot, "min_ms": mn,
                       "max_ms": mx, "avg_ms": tot / max(n, 1)}
                for name, (n, tot, mn, mx) in rows})
        else:
            lines = [f"{'Name':<40}{'Total Count':>12}{'Total(ms)':>12}"
                     f"{'Min(ms)':>10}{'Max(ms)':>10}{'Avg(ms)':>10}"]
            for name, (n, tot, mn, mx) in rows:
                lines.append(f"{name[:39]:<40}{n:>12}{tot:>12.3f}"
                             f"{mn:>10.3f}{mx:>10.3f}"
                             f"{tot / max(n, 1):>10.3f}")
            out = "\n".join(lines)
        if reset:
            _agg.clear()
    return out


class Scope:
    """A named scope (reference ``profiler.Scope``): ops dispatched
    inside it are recorded as ``name:op``."""

    _current = threading.local()

    def __init__(self, name="<unk>:"):
        self._name = name if name.endswith(":") else name + ":"
        self._old = None

    def __enter__(self):
        self._old = getattr(Scope._current, "value", None)
        Scope._current.value = self._name
        return self

    def __exit__(self, *exc):
        Scope._current.value = self._old


def current_scope_prefix():
    return getattr(Scope._current, "value", None) or ""


class Marker:
    """An instant event (reference ``profiler.Marker``)."""

    def __init__(self, name, scope="process"):
        self._name = name
        self._scope = scope

    def mark(self, scope=None):
        if _state != "run":
            return
        with _lock:
            _events.append({
                "name": self._name, "ph": "i",
                "ts": (time.perf_counter() - _t0) * 1e6,
                "s": {"process": "p", "thread": "t",
                      "global": "g"}.get(scope or self._scope, "p"),
                "pid": os.getpid(), "tid": _tid(),
            })


if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") == "1":
    set_config(profile_all=True)
    set_state("run")

"""Training telemetry: spans, counters, gauges and per-step records.

Counterpart of ``mxnet_tpu/telemetry/__init__.py``: named spans at the
phases of a training step (``trainer.step`` / ``trainer.allreduce`` /
``trainer.update``, ``cachedop.build`` / ``compile`` / ``replay``,
``step_fusion.build`` / ``compile`` / ``replay``, ``kvstore.push`` /
``pull``, ``ckpt.*``), counters (CachedOp cache hits and misses, host
syncs on ``asnumpy``/``wait_to_read``/``asscalar``, allreduce and
kvstore bytes, ``data.wait_ms``) and gauges, folded into one record per
``step_begin()``/``step_end()`` pair.  Per-op dispatch events stay the
profiler's (``ops.registry.apply_op``); while the profiler runs, every
finished span is mirrored into its chrome trace
(``profiler.record_span_event``), so phases and ops share one timeline.

Design constraints, as the reference's:

* **Near-zero cost when disabled.**  Every recorder's disabled path is
  one module-global boolean check and a return: no lock, no allocation
  (``span()`` hands back a shared null singleton).
* **Thread-safe when enabled.**  Counters, gauges and phase sums take
  one module lock; span nesting is thread-local.
* **Host-side only.**  Recording never touches a tensor's data and never
  synchronizes the card.  ``step_ms`` is host wall time.

The step record has the reference's key set.  ``bulk_flush`` and
``bulk_async_wait_ms`` read the bulk engine's ``engine.bulk_flush`` and
``engine.bulk_async_wait_ms`` counters (its flushed segments and the
callers' waits on the async worker, ``engine.py``).  A "compile" in the
port is a signature's first call, which on a card captures its CUDA
graph; ``compile_count`` sums those counters.

Submodules: ``sinks`` (``JsonlSink``, ``read_jsonl``), ``numerics``
(per-layer tensor statistics, also inside CUDA graphs), ``memwatch``
(the live-storage ledger and the OOM post-mortem), ``retrace`` (the
recapture sanitizer), ``costs`` (flops and bytes per compile site,
``mfu``), ``tracing`` (request-scoped spans and the flight recorder),
``capacity`` (the serving lanes' duty cycle, λ/μ/ρ and headroom),
``fleet`` (rank-aware step records, the straggler and anomaly watchdog,
the training flight recorder) and ``promtext`` (Prometheus text).

Typical use::

    from mxnet_tpu_torch import telemetry

    telemetry.enable(jsonl_path="train_telemetry.jsonl", numerics=True)
    for batch in loader:
        with telemetry.step(examples=batch_size):
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(batch_size)
    telemetry.disable()

``MXNET_TELEMETRY=1`` enables at import, with ``MXNET_TELEMETRY_JSONL``
naming the log.
"""
from __future__ import annotations

import os
import sys
import threading
import time

from .sinks import JsonlSink, read_jsonl  # noqa: F401  (re-exported)
from . import costs
from . import memwatch
from . import tracing
from . import promtext
from . import fleet as _fleet_mod
from . import numerics as _numerics_mod
from . import retrace as _retrace_mod
from . import capacity as _capacity_mod

# ``enable(fleet=..., numerics=..., retrace=..., capacity=...)`` take
# keywords of the same names
fleet = _fleet_mod
numerics = _numerics_mod
retrace = _retrace_mod
capacity = _capacity_mod

__all__ = ["enable", "disable", "is_enabled", "span", "count", "gauge",
           "hist", "hist_summary", "hists", "emit",
           "step", "step_begin", "step_end", "counters", "gauges",
           "phases", "reset", "current_span", "JsonlSink", "read_jsonl",
           "costs", "memwatch", "numerics", "retrace", "tracing",
           "promtext", "fleet", "capacity"]

# -- state -------------------------------------------------------------------
# _enabled is read unlocked on every recorder's fast path; it is only
# ever flipped under _lock or at enable/disable.

_enabled = False
_lock = threading.Lock()
_counters = {}        # cumulative: name -> number
_gauges = {}          # last-value: name -> number
_hists = {}           # rolling reservoir: name -> _Reservoir
_step_counters = {}   # deltas since step_begin
_step_phases = {}     # span name -> accumulated seconds since step_begin
_step_idx = 0
_step_t0 = None
_step_wall = None
_sinks = []
_tls = threading.local()


def _span_stack():
    stack = getattr(_tls, "spans", None)
    if stack is None:
        stack = _tls.spans = []
    return stack


def _active_profiler():
    """The profiler module iff it is imported and running (the same
    probe as ``ops.registry._profiler``)."""
    prof = sys.modules.get("mxnet_tpu_torch.profiler")
    return prof if prof is not None and prof.is_running() else None


# -- spans -------------------------------------------------------------------

class _NullSpan:
    """Shared no-op context manager handed out while telemetry is
    disabled: ``span()`` must not allocate on the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """A live timed region.  Its duration lands in the current step's
    phase breakdown under ``name`` (summed over entries) and, while the
    profiler runs, in its chrome trace."""

    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs

    def annotate(self, **attrs):
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        _span_stack().append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        stack = _span_stack()
        if stack and stack[-1] is self:
            stack.pop()
        if _enabled:
            with _lock:
                _step_phases[self.name] = \
                    _step_phases.get(self.name, 0.0) + dur
        prof = _active_profiler()
        if prof is not None:
            args = self.attrs
            if _fleet_mod._enabled:
                # rank-aware spans: merged timelines tell the ranks apart
                try:
                    r, n = _fleet_mod.world()
                    args = dict(args) if args else {}
                    args["rank"] = r
                    args["world_size"] = n
                except Exception:  # noqa: BLE001 - never raises
                    pass
            prof.record_span_event(
                prof.current_scope_prefix() + self.name, self.t0, dur,
                cat="telemetry", args=args)
        return False


def span(name, attrs=None):
    """Context manager timing a named phase; ``attrs`` (a dict) rides into
    the chrome-trace event's ``args``.  Disabled: the shared null
    singleton."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, attrs)


def current_span():
    """Innermost live span on this thread (None outside any span)."""
    stack = getattr(_tls, "spans", None)
    return stack[-1] if stack else None


# -- counters / gauges -------------------------------------------------------

def count(name, n=1):
    """Increment counter ``name`` by ``n`` (cumulative and per step)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
        _step_counters[name] = _step_counters.get(name, 0) + n


def gauge(name, value):
    """Record the latest value of gauge ``name``."""
    if not _enabled:
        return
    with _lock:
        _gauges[name] = value


# -- rolling histograms ------------------------------------------------------

#: default reservoir capacity
HIST_CAPACITY = 1024


class _Reservoir:
    """Bounded ring buffer over the most recent ``cap`` observations (a
    sliding window, not a sample); ``total``/``count`` track the whole
    stream."""

    __slots__ = ("cap", "values", "idx", "count", "total", "vmin", "vmax")

    def __init__(self, cap):
        self.cap = int(cap)
        self.values = []
        self.idx = 0
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None

    def add(self, v):
        v = float(v)
        if len(self.values) < self.cap:
            self.values.append(v)
        else:
            self.values[self.idx] = v
            self.idx = (self.idx + 1) % self.cap
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def summary(self, percentiles):
        vals = sorted(self.values)
        n = len(vals)
        if not n:
            return None
        out = {"count": self.count, "window": n,
               "mean": self.total / self.count, "min": self.vmin,
               "max": self.vmax}
        for p in percentiles:
            # nearest-rank on the sorted window: exact, no interpolation
            rank = max(0, min(n - 1, -(-int(p) * n // 100) - 1))
            out[f"p{int(p)}"] = vals[rank]
        return out


def hist(name, value, cap=HIST_CAPACITY):
    """Record one observation into rolling histogram ``name``."""
    if not _enabled:
        return
    with _lock:
        r = _hists.get(name)
        if r is None:
            r = _hists[name] = _Reservoir(cap)
        r.add(value)


def hist_summary(name, percentiles=(50, 90, 99)):
    """``{count, window, mean, min, max, p50, p90, p99}`` of histogram
    ``name`` over its window (None when it has no observation);
    nearest-rank percentiles, ``pK = vals[ceil(K·n/100) − 1]``."""
    with _lock:
        r = _hists.get(name)
        return r.summary(percentiles) if r is not None else None


def hists(percentiles=(50, 90, 99)):
    """Summaries of every live histogram, name -> summary dict."""
    with _lock:
        names = list(_hists)
    return {n: hist_summary(n, percentiles) for n in names}


def emit(record):
    """Write one structured record to every attached sink (records that
    are not step-shaped: ``retrace``).  Returns the record (None while
    disabled)."""
    if not _enabled:
        return None
    with _lock:
        sinks = list(_sinks)
    for s in sinks:
        s.emit(record)
    return record


def counters():
    """Snapshot of cumulative counters."""
    with _lock:
        return dict(_counters)


def gauges():
    """Snapshot of gauges."""
    with _lock:
        return dict(_gauges)


def phases():
    """Snapshot of the current step's phase seconds."""
    with _lock:
        return dict(_step_phases)


# -- step records ------------------------------------------------------------

#: per-step counters summed into ``compile_count``: every "this step
#: built a program" signal (the reference's names; ``engine.bulk_compile``
#: stays 0 in the port)
_COMPILE_COUNTERS = ("cachedop.compile", "step_fusion.compile",
                     "trainer.fused_cache_miss", "engine.bulk_compile")

#: per-step counters summed into ``allreduce_bytes``
_ALLREDUCE_BYTE_COUNTERS = ("kvstore.allreduce_bytes",
                            "trainer.allreduce_bytes")


def step_begin():
    """Open a step window: phase and counter deltas reset, the wall clock
    starts.  No-op while disabled."""
    global _step_idx, _step_t0, _step_wall
    if not _enabled:
        return
    with _lock:
        _step_counters.clear()
        _step_phases.clear()
        _step_idx += 1
        _step_t0 = time.perf_counter()
        _step_wall = time.time()
        idx = _step_idx
    if memwatch._enabled:
        memwatch.step_mark(idx)


def upcoming_step():
    """The index the record of the open step window will carry (None
    without one): ``numerics.harvesting()`` asks whether it falls on the
    stride."""
    return _step_idx if _enabled and _step_t0 is not None else None


def step_end(examples=None, **extra):
    """Close the step window and emit one record to every sink.
    ``examples`` (items consumed this step) gives ``examples_per_sec``;
    ``extra`` keys land verbatim.  Returns the record (None while
    disabled or without ``step_begin``).  Never synchronizes the card:
    only at the numerics stride does ``numerics.step_summary`` copy the
    step's pending statistics to the host."""
    if not _enabled:
        return None
    with _lock:
        if _step_t0 is None:
            return None
        dur = time.perf_counter() - _step_t0
        sc = dict(_step_counters)
        record = {
            "step": _step_idx,
            "wall_time": _step_wall,
            "step_ms": dur * 1e3,
            "phases_ms": {k: v * 1e3 for k, v in _step_phases.items()},
            "counters": sc,
            "gauges": dict(_gauges),
            "host_sync": sc.get("host_sync", 0),
            "cachedop_cache_hit": sc.get("cachedop.cache_hit", 0),
            "cachedop_cache_miss": sc.get("cachedop.cache_miss", 0),
            "bulk_flush": sc.get("engine.bulk_flush", 0),
            "bulk_async_wait_ms": sc.get("engine.bulk_async_wait_ms", 0.0),
            "data_wait_ms": sc.get("data.wait_ms", 0.0),
            "ckpt_saves": sc.get("ckpt.save", 0),
            "ckpt_bytes": sc.get("ckpt.bytes", 0),
            "ckpt_async_overlap_ms": sc.get("ckpt.async_overlap_ms", 0.0),
            "compile_count": sum(sc.get(k, 0) for k in _COMPILE_COUNTERS),
            "allreduce_bytes": sum(sc.get(k, 0)
                                   for k in _ALLREDUCE_BYTE_COUNTERS),
        }
        if examples is not None and dur > 0:
            record["examples"] = examples
            record["examples_per_sec"] = examples / dur
        if memwatch._enabled:
            record["live_bytes"] = memwatch.live_bytes()
            record["peak_live_bytes"] = memwatch.peak_live_bytes()
            record["live_bytes_by_device"] = memwatch.live_bytes_by_device()
        if costs._enabled:
            model_flops = sc.get("cost.model_flops", 0.0)
            record["model_flops"] = model_flops
            record["bytes_accessed"] = sc.get("cost.bytes_accessed", 0.0)
            peak = costs.peak_flops()
            record["mfu"] = (model_flops / (dur * peak)) \
                if peak and dur > 0 else None
        pl = sys.modules.get("mxnet_tpu_torch.parallel")
        if pl is not None:
            try:
                mesh = pl.current_mesh()
                if mesh is not None:
                    record["mesh_shape"] = _mesh_shape(mesh)
                placement = pl.last_placement()
                if placement is not None:
                    record.setdefault("mesh_shape",
                                      placement["mesh_shape"])
                    record["sharded_params"] = \
                        placement["sharded_params"]
                    record["replicated_params"] = \
                        placement["replicated_params"]
            except Exception:  # noqa: BLE001 - never raises into training
                pass
        # memory-budget context: remat_policy / predicted_peak_bytes /
        # offload_bytes, only once mxnet_tpu_torch.memory was imported
        mem = sys.modules.get("mxnet_tpu_torch.memory")
        if mem is not None:
            try:
                record.update(mem.telemetry_fields())
            except Exception:  # noqa: BLE001 - never raises into training
                pass
        record.update(extra)
        sinks = list(_sinks)
    if _numerics_mod._enabled:
        try:
            ns = _numerics_mod.step_summary(record.get("step"))
            if ns is not None:
                record["numerics"] = ns
        except Exception:  # noqa: BLE001 - never raises into training
            pass
    if _fleet_mod._enabled:
        # rank/world_size stamped in place before the sinks see the
        # record; the watchdog and (at the stride) the fleet exchange.
        # Raises only the opt-in WatchdogHalt, at a step boundary
        _fleet_mod.on_step_record(record)
    if _retrace_mod._enabled:
        _retrace_mod.on_step()
    for s in sinks:
        s.emit(record)
    return record


def _mesh_shape(mesh):
    """{axis: size} of a mesh (a ``DeviceMesh`` or the dict form)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None) or \
        tuple(f"d{i}" for i in range(mesh.ndim))
    return dict(zip(names, tuple(mesh.shape)))


class _StepScope:
    __slots__ = ("examples", "extra", "record")

    def __init__(self, examples, extra):
        self.examples = examples
        self.extra = extra
        self.record = None

    def __enter__(self):
        step_begin()
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.record = step_end(examples=self.examples, **self.extra)
        return False


def step(examples=None, **extra):
    """``with telemetry.step(examples=batch_size):`` — ``step_begin`` on
    entry, ``step_end`` on a clean exit; the record is ``scope.record``
    after the block."""
    if not _enabled:
        return _NULL_SPAN
    return _StepScope(examples, extra)


# -- lifecycle ---------------------------------------------------------------

def enable(jsonl_path=None, append=False, memory=True, cost=True,
           trace=False, fleet=False, numerics=False, retrace=False,
           capacity=False):
    """Turn recording on.  ``jsonl_path`` attaches a JSONL sink (one line
    a record; truncates unless ``append``).  Re-enabling resets counters
    and swaps sinks.  ``memory``/``cost`` switch on the live-storage
    ledger (``memwatch``) and the cost registry (``costs``), on by
    default.  ``numerics=True`` enables the tensor-statistics tier at its
    default stride (``numerics.enable(stride=...)`` to tune it);
    ``retrace=True``, ``"warn"`` or ``"raise"`` the recapture sanitizer.
    ``trace=True`` enables request tracing (``MXNET_TRACING=1`` does so
    on its own), ``fleet=True`` the fleet layer at its default knobs
    (``fleet.enable(...)`` to tune it), ``capacity=True`` the serving
    capacity accounting (``capacity.enable(...)`` for thresholds)."""
    global _enabled
    with _lock:
        _reset_locked()
        for s in _sinks:
            s.close()
        _sinks.clear()
        if jsonl_path is not None:
            _sinks.append(JsonlSink(jsonl_path, append=append))
    _enabled = True
    if memory:
        memwatch.enable()
    if cost:
        costs.enable()
    if trace:
        tracing.enable()
    if fleet:
        _fleet_mod.enable()
    if numerics:
        _numerics_mod.enable()
    if retrace:
        _retrace_mod.enable(mode=retrace if isinstance(retrace, str)
                            else "warn")
    if capacity:
        _capacity_mod.enable()


def disable():
    """Turn recording off and close the sinks."""
    global _enabled
    _enabled = False
    memwatch.disable()
    costs.disable()
    tracing.disable()
    _fleet_mod.disable()
    _numerics_mod.disable()
    _capacity_mod.disable()
    with _lock:
        for s in _sinks:
            s.close()
        _sinks.clear()


def is_enabled():
    return _enabled


def add_sink(sink):
    """Attach an extra sink (anything with ``emit(record)`` and
    ``close()``)."""
    with _lock:
        _sinks.append(sink)


def reset():
    """Zero counters, gauges and step state without touching sinks."""
    with _lock:
        _reset_locked()


def _reset_locked():
    global _step_idx, _step_t0, _step_wall
    _counters.clear()
    _gauges.clear()
    _hists.clear()
    _step_counters.clear()
    _step_phases.clear()
    _step_idx = 0
    _step_t0 = None
    _step_wall = None


# -- helpers for instrumented sites -----------------------------------------

def nbytes_of(value):
    """Payload size of an NDArray / sparse NDArray / tensor / list of
    those: shape × itemsize arithmetic, never a sync."""
    if isinstance(value, (list, tuple)):
        return sum(nbytes_of(v) for v in value)
    if getattr(value, "stype", "default") != "default":
        # sparse: the stored values and indices
        total = nbytes_of(value.data) + nbytes_of(value.indices)
        indptr = getattr(value, "indptr", None)
        return total + (nbytes_of(indptr) if indptr is not None else 0)
    raw = getattr(value, "_data", value)
    try:
        size = 1
        for s in raw.shape:
            size *= int(s)
        return size * raw.dtype.itemsize
    except Exception:  # noqa: BLE001 - not an array: no payload
        return 0


if os.environ.get("MXNET_TELEMETRY", "0") == "1":
    enable(jsonl_path=os.environ.get("MXNET_TELEMETRY_JSONL"))

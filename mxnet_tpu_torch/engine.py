"""Engine: the engine type, and deferred imperative dispatch (bulk
segments) with its async executor.

Counterpart of ``mxnet_tpu/engine.py`` (reference ``src/engine/`` and
``python/mxnet/engine.py``), to its contract:

* ``NaiveEngine`` (``MXT_ENGINE_TYPE`` / ``MXNET_ENGINE_TYPE`` or
  ``set_engine_type``) is the user's choice of op-by-op execution: the
  Trainer updates each parameter with its own eager rule instead of the
  fused multi-tensor kernel, a hybridized block runs eagerly instead of
  replaying a CUDA graph, and bulking is bypassed.  The port never
  chooses it on its own.
* **Op bulking.**  With bulking on (``MXT_ENGINE_BULK=1``,
  ``set_bulk_enabled`` or ``with engine.bulk(n):``), ``apply_op`` does
  not run the op: it appends it to a thread-local pending *segment* and
  returns NDArrays whose tensor is a ``_PendingArray`` placeholder, with
  the shape and dtype inferred on ``meta`` tensors (once a call site and
  input signature).  A segment flushes on the bulk size, any read of the
  value (``NDArray._data``: ``asnumpy``, ``wait_to_read``, ``item``,
  ``__getitem__``, an eager op on it), an ``autograd.record()``
  boundary, a ``CachedOp``, ``FusedTrainStep`` or kvstore dispatch, and
  an explicit ``flush()`` (which returns the count).  A read of an
  array that a pending segment takes as an input flushes too, so an
  in-place write never runs ahead of a deferred read.
* **Segments as CUDA graphs.**  A segment's signature (each op's call
  site and closure attributes, the wiring, the inputs' shapes, dtypes
  and device, and the live outputs) keys an LRU cache
  (``segment_cache_stats``, ``clear_segment_cache``,
  ``MXT_ENGINE_SEGMENT_CACHE``).  On the CPU a segment runs its ops in
  order.  On a card its first run is eager and is then captured into
  one CUDA graph (``cuda_graph.capture``, thread-local mode), which
  every later segment of the signature replays: the inputs are copied
  into the graph's, the live outputs copied out.  A float closure
  attribute is not part of the key: it is a float64 device scalar of the
  graph, written before each replay, so a changed learning rate replays
  the same graph.  It is such a scalar only where the op's tensor
  inputs are float32 or float64 (a device scalar beside a bf16 tensor
  would be rounded to bf16, beside an integer one it would promote the
  result): a segment with a float attribute on another dtype, or whose
  capture fails (an op that reads a value back), runs eagerly on every
  flush.  torch's eager kernels take a host scalar divisor as its
  reciprocal, so a replayed division by a float attribute may differ
  from the eager op in the last bit.
* **The async tier** (``MXNET_ENGINE_ASYNC``, on by default while
  bulking is on): a segment flushed by the bulk size goes to one worker
  thread through a bounded queue (``MXNET_ENGINE_ASYNC_QUEUE``), which
  runs (or replays) it on the stream of the thread that submitted it,
  while that thread appends to the next segment.  A worker failure is
  raised again at the next materialization point, naming the ops.  A
  segment whose input is still pending in an earlier submitted one
  takes a stitch reference instead of waiting (FIFO order runs the
  producer first).  ``flush`` drains: on return every segment this
  thread submitted has run.  ``async_stats`` and ``shutdown_async``.
* Interned call-site keys (``key_intern_stats``), dispatch callbacks
  (``register_dispatch_callback``: the data prefetcher counts the
  dispatches that overlap a transfer), ``maybe_defer`` and
  ``cached_vjp``.  ``apply_op`` does not use ``cached_vjp``: a torch op
  records its backward as it runs, with no trace to save.
* Deferral is bypassed while recording, under the NaiveEngine, while
  amp or the profiler is active, during the numerics bisection, during
  a CUDA graph capture (``cuda_graph.capturing()``: a bulk scope inside
  ``FusedTrainStep`` or a ``CachedOp`` capture dispatches directly),
  and for operands over a mesh.  The donation sanitizer checks a
  segment's real inputs at flush.  Telemetry: ``engine.bulk_flush`` and
  ``engine.bulk_flush.<reason>``, ``engine.bulk_compile`` (a captured
  or first-run segment), ``engine.bulk_segment_cache_{hit,miss}``, the
  ``engine.bulk_segment_ops`` and ``engine.async_queue_depth`` gauges and
  ``engine.bulk_async_wait_ms``, which the step record reads as
  ``bulk_flush`` and ``bulk_async_wait_ms``.
"""
from __future__ import annotations

import atexit
import contextlib
import math
import os
import queue
import sys
import threading
import time
import types
import weakref
from collections import OrderedDict

import numpy as np
import torch

from .base import MXNetError
from . import sanitizer as _san

__all__ = ["engine_type", "set_engine_type", "is_naive", "bulk",
           "set_bulk_size", "bulk_size", "set_bulk_enabled", "bulk_enabled",
           "set_async_enabled", "async_enabled", "async_stats",
           "key_intern_stats", "shutdown_async", "flush", "pending_ops",
           "segment_cache_stats", "clear_segment_cache", "cached_vjp",
           "maybe_defer", "register_dispatch_callback",
           "unregister_dispatch_callback"]

_TYPES = ("ThreadedEnginePerDevice", "ThreadedEngine", "NaiveEngine")
_type = None
_naive = None  # cached (_type == "NaiveEngine")


def engine_type():
    """The engine type: ``MXT_ENGINE_TYPE`` or ``MXNET_ENGINE_TYPE`` from
    the environment (default ``ThreadedEnginePerDevice``), unless
    ``set_engine_type`` chose one."""
    global _type, _naive
    if _type is None:
        env = os.environ.get(
            "MXT_ENGINE_TYPE",
            os.environ.get("MXNET_ENGINE_TYPE", _TYPES[0]))
        if env not in _TYPES:  # not cached: a bad value raises every call
            raise MXNetError(f"unknown engine type {env!r}; one of "
                             f"{_TYPES}")
        _type = env
        _naive = env == "NaiveEngine"
    return _type


def set_engine_type(name):
    """Choose the engine type at run time; returns it."""
    global _type, _naive
    if name not in _TYPES:
        raise MXNetError(f"unknown engine type {name!r}; one of {_TYPES}")
    _type = name
    _naive = name == "NaiveEngine"
    return name


def is_naive():
    return engine_type() == "NaiveEngine"


# --- bulk sizes and switches -------------------------------------------------

def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_flag(name) -> bool:
    return os.environ.get(name, "").strip().lower() \
        not in ("", "0", "false", "off", "no")


#: MXNET_ENGINE_BULK_SIZE seeds the budget; the _IN_TRAIN/_IN_INFER
#: variants pick one a mode (read through autograd.is_training())
_bulk_size = _env_int("MXNET_ENGINE_BULK_SIZE", 15)
_bulk_size_train = _env_int("MXNET_ENGINE_BULK_SIZE_IN_TRAIN", _bulk_size)
_bulk_size_infer = _env_int("MXNET_ENGINE_BULK_SIZE_IN_INFER", _bulk_size)

_bulk_default = _env_flag("MXT_ENGINE_BULK")
_bulk_scopes = 0  # live bulk() scopes across all threads

#: apply_op's disabled path is one read of this flag
_bulk_on = _bulk_default

_async_on = os.environ.get("MXNET_ENGINE_ASYNC", "1").strip().lower() \
    not in ("0", "false", "off", "no")

#: bounded worker queue: a caller that outruns the worker by this many
#: segments blocks on submit
_ASYNC_QUEUE_MAX = max(1, _env_int("MXNET_ENGINE_ASYNC_QUEUE", 8))


def _update_bulk_on():
    global _bulk_on
    _bulk_on = bool(_bulk_default or _bulk_scopes > 0)


def set_async_enabled(flag):
    """Switch the async tier (``MXNET_ENGINE_ASYNC``); returns the
    previous value.  Turning it off drains this thread's in-flight
    segments first."""
    global _async_on
    prev = _async_on
    if not flag:
        _drain_async()
    _async_on = bool(flag)
    return prev


def async_enabled():
    return _async_on


def set_bulk_size(size):
    """How many deferred ops a segment holds before it flushes (the
    reference's ``MXNET_ENGINE_BULK_SIZE``): sets the budget and both
    mode variants; returns the previous budget.  A size ≤ 1 turns
    deferral off even with bulking on."""
    global _bulk_size, _bulk_size_train, _bulk_size_infer
    prev = _bulk_size
    _bulk_size = _bulk_size_train = _bulk_size_infer = int(size)
    return prev


def bulk_size():
    """The segment budget of the current mode."""
    from . import autograd as ag

    return _bulk_size_train if ag.is_training() else _bulk_size_infer


def set_bulk_enabled(flag):
    """The process-wide default of deferred dispatch (``MXT_ENGINE_BULK``);
    returns the previous one.  Turning it off flushes this thread's
    segment."""
    global _bulk_default
    prev = _bulk_default
    _bulk_default = bool(flag)
    _update_bulk_on()
    if not _bulk_default:
        flush("explicit")
    return prev


def bulk_enabled():
    """Is deferred dispatch on for the calling thread?"""
    e = _TLS.enabled
    return _bulk_default if e is None else e


@contextlib.contextmanager
def bulk(size):
    """``with engine.bulk(n):`` — deferred dispatch on this thread with a
    budget of ``n`` ops a segment; the segment flushes on exit and the
    previous sizes and switch come back.  ``bulk(0)``/``bulk(1)`` turn
    deferral off in the scope."""
    global _bulk_scopes, _bulk_size, _bulk_size_train, _bulk_size_infer
    prev_sizes = (_bulk_size, _bulk_size_train, _bulk_size_infer)
    prev_enabled = _TLS.enabled
    set_bulk_size(size)
    _TLS.enabled = int(size) > 1
    _bulk_scopes += 1
    _update_bulk_on()
    try:
        yield
    finally:
        try:
            flush("explicit")
        finally:
            _bulk_scopes -= 1
            _TLS.enabled = prev_enabled
            _bulk_size, _bulk_size_train, _bulk_size_infer = prev_sizes
            _update_bulk_on()


# --- segments ----------------------------------------------------------------

class _BulkTLS(threading.local):
    def __init__(self):
        self.enabled = None   # None: the process default
        self.segment = None   # the thread's pending _Segment
        self.flushing = False
        self.inflight = []    # submitted to the worker, not yet drained


_TLS = _BulkTLS()


class _PendingArray:
    """The tensor of an NDArray whose op sits in a pending segment: the
    shape, dtype and device an NDArray's cheap properties read.  Any read
    of ``NDArray._data`` materializes it (``_materialize``)."""

    __slots__ = ("_segment", "_slot", "shape", "dtype", "device",
                 "__weakref__")

    def __init__(self, segment, slot, shape, dtype, device):
        self._segment = segment
        self._slot = slot
        self.shape = shape
        self.dtype = dtype
        self.device = device
        # at flush, only slots whose placeholder is still referenced
        # leave the segment
        segment.phrefs.append(weakref.ref(self))

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def is_cuda(self):
        return self.device.type == "cuda"

    def numel(self):
        return math.prod(self.shape)

    def element_size(self):
        return self.dtype.itemsize

    def __repr__(self):
        return (f"<pending {'x'.join(map(str, self.shape))} {self.dtype} "
                f"slot={self._slot}>")


class _SegOp:
    """One deferred op: its function, its input wiring (a slot ≥ 0 or an
    external input -(index + 1)), the output slots it fills, and its
    inputs' dtypes (whether its float attributes may become device
    scalars)."""

    __slots__ = ("fun", "in_refs", "base", "n_out", "single", "name", "key",
                 "lift", "lifted", "dtypes")

    def __init__(self, fun, in_refs, base, n_out, single, name, key, lift,
                 lifted, dtypes):
        self.fun = fun
        self.in_refs = in_refs
        self.base = base
        self.n_out = n_out
        self.single = single
        self.name = name
        self.key = key
        self.lift = lift
        self.lifted = lifted
        self.dtypes = dtypes


class _StitchRef:
    """An external input that is an output slot of an earlier submitted
    segment, resolved on the worker before the run (FIFO runs the
    producer first); holds the producer's placeholder so its slot stays
    live."""

    __slots__ = ("pending",)

    def __init__(self, pending):
        self.pending = pending

    @property
    def segment(self):
        return self.pending._segment

    @property
    def slot(self):
        return self.pending._slot


_FLOATS = (torch.float32, torch.float64)


class _Segment:
    """A thread's pending ops (one engine bulk)."""

    __slots__ = ("ops", "ext", "ext_ids", "slots", "results", "error",
                 "error_delivered", "submitted", "stitched", "phrefs",
                 "keep", "stream", "_lock", "_done")

    def __init__(self):
        self.ops = []
        self.ext = []        # external input tensors (or _StitchRefs)
        self.ext_ids = {}    # id(tensor) / stitch key -> index into ext
        self.slots = 0
        self.results = None  # a tensor per slot once run
        self.error = None
        self.error_delivered = False
        self.submitted = False
        self.stitched = 0
        self.phrefs = []
        self.keep = None     # the live slots, fixed when it is finalized
        self.stream = None   # the submitting thread's CUDA stream
        self._lock = threading.Lock()
        self._done = threading.Event()

    def finalize(self):
        """Fix the live output slots (those whose placeholder is still
        referenced, directly or through a later segment's stitch) on the
        thread that made the segment, so that its key does not depend on
        when a worker runs it."""
        if self.keep is None:
            live = set()
            for wr in self.phrefs:
                p = wr()
                if p is not None:
                    live.add(p._slot)
            self.keep = tuple(sorted(live))

    def execute(self, reason):
        """Run the segment (once).  A failure is kept in ``error`` (the
        worker's is raised again at the caller's next materialization)
        and raised."""
        with self._lock:
            if self.results is not None or self.error is not None:
                return
            try:
                if self.stream is not None:
                    with torch.cuda.stream(self.stream):
                        self._execute_locked(reason)
                else:
                    self._execute_locked(reason)
            except BaseException as e:
                if self.error is None:
                    names = ", ".join(op.name or "op" for op in self.ops[:8])
                    self._fail_locked(MXNetError(
                        f"bulked segment of {len(self.ops)} ops ({names}) "
                        f"failed at flush ({reason}): {e}"))
                raise
            finally:
                self._done.set()

    def _fail_locked(self, exc):
        self.error = exc
        self.ops = ()
        self.ext = ()
        self.ext_ids = None
        self.phrefs = ()
        return exc

    def _execute_locked(self, reason):
        n_ops = len(self.ops)
        telemetry.count("engine.bulk_flush")
        telemetry.count("engine.bulk_flush." + reason)
        telemetry.gauge("engine.bulk_segment_ops", n_ops)
        ext = self.ext
        if self.stitched:
            telemetry.count("engine.bulk_stitch")
            with _STATS_LOCK:
                _async_stats["stitched_segments"] += 1
            for i, r in enumerate(ext):
                if r.__class__ is _StitchRef:
                    src = r.segment
                    src._done.wait()
                    if src.error is not None:
                        raise self._fail_locked(MXNetError(
                            f"bulked segment of {n_ops} ops consumed the "
                            "output of an upstream stitched segment that "
                            f"failed: {src.error}")) from src.error
                    ext[i] = src.results[r.slot]
        if _san._enabled:
            for raw in ext:
                try:
                    _san.check(raw, "bulk segment input")
                except MXNetError as e:
                    raise self._fail_locked(e)
        self.finalize()
        keep = self.keep
        key = (tuple(op.key for op in self.ops),
               tuple((tuple(r.shape), r.dtype, r.device) for r in ext),
               keep)
        entry = _cache_lookup(key)
        first = entry is None
        if first:
            if _retrace._enabled and n_ops > 1:
                _retrace.observe(
                    "engine_bulk", hash(key[0]),
                    {"ext": key[1], "keep": keep},
                    site="mxnet_tpu_torch.engine:_Segment._execute_locked "
                         f"({n_ops} ops)")
            entry = _CompiledSegment(
                _build_segment_fn(self.ops, self.slots, keep), self.ops)
            _cache_insert(key, entry)
        scalars = tuple(v for op in self.ops for v in op.lifted)
        prev_flushing = _TLS.flushing
        _TLS.flushing = True
        try:
            with telemetry.span("engine.bulk_compile" if first
                                else "engine.bulk_replay"):
                res = entry.run(scalars, ext)
        except MXNetError as e:
            self._fail_locked(e)
            raise
        except Exception as e:
            names = ", ".join(op.name or "op" for op in self.ops[:8])
            if _mw._enabled:
                _mw.annotate_oom(e, context=f"bulk segment flush ({reason})")
            raise self._fail_locked(MXNetError(
                f"bulked segment of {n_ops} ops ({names}"
                f"{', ...' if n_ops > 8 else ''}) failed at flush "
                f"({reason}): {e}")) from e
        finally:
            _TLS.flushing = prev_flushing
        if first:
            telemetry.count("engine.bulk_compile")
        results = [None] * self.slots
        for i, s in enumerate(keep):
            results[s] = res[i]
        self.results = results
        self.ops = ()
        self.ext = ()
        self.ext_ids = None
        self.phrefs = ()


def _graph_device(ext):
    """The card a segment over ``ext`` replays a graph on, or None (a CPU
    or mixed segment, or one over a mesh, runs its ops in order)."""
    from .parallel.local import is_dtensor

    dev = None
    for t in ext:
        if not t.is_cuda or is_dtensor(t):
            return None
        if dev is None:
            dev = t.device
        elif t.device != dev:
            return None
    return dev


class _CompiledSegment:
    """A cached segment: its function (``_build_segment_fn``) and, on a
    card, its CUDA graph with the static inputs and device scalars the
    graph reads (``graph`` is False once the segment is known to run
    eagerly)."""

    __slots__ = ("fn", "graph", "statics", "scalars", "liftable")

    def __init__(self, fn, ops):
        self.fn = fn
        self.graph = None
        self.statics = None
        self.scalars = None
        self.liftable = all(not op.lift or
                            all(d in _FLOATS for d in op.dtypes)
                            for op in ops)

    def run(self, scalars, ext):
        """The live outputs of the segment on ``ext``."""
        dev = _graph_device(ext) if self.graph is not False else None
        if dev is None or not self.liftable:
            with torch.no_grad():
                return self.fn(scalars, *ext)
        if self.graph is None:
            with torch.no_grad():
                out = self.fn(scalars, *ext)  # the first run: eager
            self._capture(scalars, ext, dev)
            return out
        with torch.no_grad():
            for s, e in zip(self.statics, ext):
                s.copy_(e)
            if scalars:
                self.scalars.copy_(torch.tensor(scalars,
                                                dtype=torch.float64))
        self.graph.replay()
        return tuple(o.clone() for o in self.graph.outputs)

    def _capture(self, scalars, ext, dev):
        from . import cuda_graph

        with torch.no_grad():
            statics = [e.detach().clone() for e in ext]
            table = torch.tensor(scalars, dtype=torch.float64, device=dev) \
                if scalars else None
        cells = tuple(table[i] for i in range(len(scalars)))

        def body():
            with torch.no_grad():
                return tuple(self.fn(cells, *statics))

        try:
            with torch.cuda.device(dev):
                self.graph = cuda_graph.capture(body, mode="thread_local")
        except Exception:  # an op that reads a value back: eager from now
            self.graph = False
            telemetry.count("engine.bulk_eager")
            return
        self.statics, self.scalars = statics, table


# --- the async executor --------------------------------------------------------
# One worker thread for the process; FIFO order is what stitch refs rely on.

_async_stats = {"submitted": 0, "stitched_segments": 0,
                "stitched_inputs": 0, "max_queue_depth": 0,
                "wait_ms": 0.0}
_STATS_LOCK = _san.wrap_lock(threading.Lock(), "engine._STATS_LOCK")


class _AsyncExecutor:
    def __init__(self, maxsize):
        self.q = queue.Queue(maxsize)
        self._thread = None
        self._lock = _san.wrap_lock(threading.Lock(),
                                    "engine._AsyncExecutor._lock")

    def ensure_thread(self):
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._worker, name="mxt-engine-async",
                    daemon=True)
                self._thread.start()

    def _worker(self):
        while True:
            item = self.q.get()
            if item is None:
                self.q.task_done()
                return
            seg, reason = item
            try:
                seg.execute(reason)
            except BaseException:
                pass  # kept in seg.error, raised at the next materialization
            finally:
                self.q.task_done()

    def stop(self, join=True):
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            self.q.put(None)
            if join:
                t.join(timeout=30)


_EXEC = _AsyncExecutor(_ASYNC_QUEUE_MAX)

#: ``cb(reason)`` observers of each segment handed to the worker (the
#: data prefetcher counts the dispatches that overlap a transfer)
_dispatch_callbacks = []


def register_dispatch_callback(cb):
    """Register ``cb(reason)`` to run after each async segment dispatch."""
    if cb not in _dispatch_callbacks:
        _dispatch_callbacks.append(cb)


def unregister_dispatch_callback(cb):
    try:
        _dispatch_callbacks.remove(cb)
    except ValueError:
        pass


def _submit_async(seg, reason):
    """Hand a finalized segment to the worker (blocking while the queue is
    full) and track it for the drain."""
    seg.finalize()
    seg.submitted = True
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        seg.stream = torch.cuda.current_stream()
    _EXEC.ensure_thread()
    depth = _EXEC.q.qsize() + 1
    with _STATS_LOCK:
        _async_stats["submitted"] += 1
        if depth > _async_stats["max_queue_depth"]:
            _async_stats["max_queue_depth"] = depth
    if telemetry._enabled:
        telemetry.gauge("engine.async_queue_depth", depth)
    _EXEC.q.put((seg, reason))
    for cb in tuple(_dispatch_callbacks):
        try:
            cb(reason)
        except Exception:
            pass
    inflight = _TLS.inflight
    if len(inflight) >= 4:
        _TLS.inflight = inflight = [
            s for s in inflight
            if not s._done.is_set()
            or (s.error is not None and not s.error_delivered)]
    inflight.append(seg)


def _wait_done(seg):
    """Wait for a submitted segment, booked as ``bulk_async_wait_ms``."""
    if seg._done.is_set():
        return
    t0 = time.perf_counter()
    seg._done.wait()
    ms = (time.perf_counter() - t0) * 1e3
    with _STATS_LOCK:
        _async_stats["wait_ms"] += ms
    if telemetry._enabled:
        telemetry.count("engine.bulk_async_wait_ms", ms)


def _drain_async():
    """Wait for every segment this thread submitted; raise the first
    worker failure not yet delivered."""
    inflight = _TLS.inflight
    if not inflight:
        return
    _TLS.inflight = []
    err = None
    for seg in inflight:
        _wait_done(seg)
        if seg.error is not None and not seg.error_delivered and err is None:
            seg.error_delivered = True
            err = seg.error
    if err is not None:
        raise err


def shutdown_async(join=True):
    """Drain this thread's in-flight segments and stop the worker (it
    starts again at the next async submit)."""
    try:
        _drain_async()
    finally:
        _EXEC.stop(join=join)


atexit.register(shutdown_async)


def async_stats():
    """Segments submitted and stitched, the largest queue depth seen and
    the callers' total wait (ms)."""
    with _STATS_LOCK:
        return dict(_async_stats)


def _with_cells(fun, lift, values):
    """A copy of ``fun`` whose closure cells at ``lift`` hold ``values``."""
    cells = list(fun.__closure__)
    for i, v in zip(lift, values):
        cells[i] = types.CellType(v)
    g = types.FunctionType(fun.__code__, fun.__globals__, fun.__name__,
                           fun.__defaults__, tuple(cells))
    g.__kwdefaults__ = fun.__kwdefaults__
    return g


def _build_segment_fn(ops, n_slots, keep=None):
    """The function that runs a segment: lifted float attributes (python
    floats, or device scalars inside a capture) and the external inputs
    in, the live output slots (``keep``; all when None) out.  Each op
    runs as its eager dispatch does, in order."""
    ops = tuple(ops)

    def seg_fn(scalars, *ext):
        vals = [None] * n_slots
        pos = 0
        for op in ops:
            args = [vals[i] if i >= 0 else ext[-i - 1] for i in op.in_refs]
            fun = op.fun
            if op.lift:
                k = len(op.lift)
                fun = _with_cells(fun, op.lift, scalars[pos:pos + k])
                pos += k
            r = fun(*args)
            rt = (r,) if op.single else tuple(r)
            for j in range(op.n_out):
                vals[op.base + j] = rt[j]
        if keep is None:
            return tuple(vals)
        return tuple(vals[i] for i in keep)

    return seg_fn


# --- the segment cache (LRU) ---------------------------------------------------

_SEG_CACHE = OrderedDict()
_SEG_CACHE_MAX = max(1, _env_int("MXT_ENGINE_SEGMENT_CACHE", 256))
_SEG_LOCK = _san.wrap_lock(threading.Lock(), "engine._SEG_LOCK")
_seg_stats = {"hit": 0, "miss": 0}


def _cache_lookup(key):
    with _SEG_LOCK:
        entry = _SEG_CACHE.get(key)
        if entry is None:
            _seg_stats["miss"] += 1
        else:
            _SEG_CACHE.move_to_end(key)
            _seg_stats["hit"] += 1
    telemetry.count("engine.bulk_segment_cache_miss" if entry is None
                    else "engine.bulk_segment_cache_hit")
    return entry


def _cache_insert(key, entry):
    with _SEG_LOCK:
        _SEG_CACHE[key] = entry
        while len(_SEG_CACHE) > _SEG_CACHE_MAX:
            _SEG_CACHE.popitem(last=False)


def segment_cache_stats():
    """``{"hit", "miss", "size"}`` of the segment cache."""
    with _SEG_LOCK:
        return dict(_seg_stats, size=len(_SEG_CACHE))


def clear_segment_cache():
    """Drop every cached segment (and its graph) and zero the counts."""
    with _SEG_LOCK:
        _SEG_CACHE.clear()
        _seg_stats["hit"] = _seg_stats["miss"] = 0


# --- keys of a deferred function ---------------------------------------------
# A deferred function is usually a fresh closure a call (``lambda a: fn(a,
# other)`` in an op wrapper): its key is its code object and the values in
# its closure cells.  Only immutable values are admitted; a tensor or any
# other mutable object makes the op run eagerly.

_IMMUTABLE_TYPES = (type(None), bool, int, float, complex, str, bytes,
                    np.dtype, np.generic, type, torch.dtype, torch.device,
                    torch.layout, torch.memory_format)


class _Unkeyable(Exception):
    pass


def _key_component(v):
    if isinstance(v, _IMMUTABLE_TYPES):
        return v
    if isinstance(v, tuple):
        return tuple(_key_component(x) for x in v)
    if isinstance(v, frozenset):
        return frozenset(_key_component(x) for x in v)
    if isinstance(v, slice):
        return ("__slice__", _key_component(v.start), _key_component(v.stop),
                _key_component(v.step))
    if callable(v) and not isinstance(v, torch.nn.Module):
        try:
            hash(v)
        except TypeError:
            raise _Unkeyable from None
        return v
    raise _Unkeyable


def _fun_key(fun):
    """``(key, lift)``: a hashable signature of ``fun`` and the closure
    cells holding float attributes (their values stay out of the key);
    None when ``fun`` cannot be keyed."""
    code = getattr(fun, "__code__", None)
    if code is None:
        try:
            hash(fun)
        except TypeError:
            return None
        return fun, ()
    lift = []
    try:
        cells = []
        for i, cell in enumerate(getattr(fun, "__closure__", None) or ()):
            try:
                v = cell.cell_contents
            except ValueError:
                return None
            if type(v) is float or isinstance(v, np.floating):
                lift.append(i)
                cells.append(("__scalar__", type(v).__name__))
            else:
                cells.append(_key_component(v))
        defaults = tuple(_key_component(d)
                         for d in (getattr(fun, "__defaults__", None) or ()))
    except _Unkeyable:
        return None
    return (code, tuple(cells), defaults), tuple(lift)


# --- output shapes ---------------------------------------------------------------

_AVAL_CACHE = {}
_AVAL_CACHE_MAX = 8192


def _out_avals(fun, fkey, in_avals):
    """(((shape, dtype) per output), single) from a run of ``fun`` on
    ``meta`` tensors, or None when that fails (an op that reads a value,
    a kernel wrapper, a non-tensor output): such an op runs eagerly."""
    akey = (fkey, in_avals)
    if akey in _AVAL_CACHE:
        return _AVAL_CACHE[akey]
    try:
        metas = [torch.empty(s, dtype=d, device="meta")
                 for s, d, _ in in_avals]
        with torch.no_grad():
            out = fun(*metas)
        single = not isinstance(out, (tuple, list))
        outs = (out,) if single else tuple(out)
        if not all(isinstance(o, torch.Tensor) and o.device.type == "meta"
                   for o in outs):
            raise TypeError("non-tensor output")
        res = (tuple((tuple(o.shape), o.dtype) for o in outs), single)
    except Exception:
        res = None
    if len(_AVAL_CACHE) >= _AVAL_CACHE_MAX:
        _AVAL_CACHE.clear()
    _AVAL_CACHE[akey] = res
    return res


# --- interned call-site keys ----------------------------------------------------
# A call site (the code object of the deferred function) pays the full key
# and the meta run once; later dispatches revalidate its closure cells and
# match an input signature seen before.

class _Site:
    __slots__ = ("cells", "defaults", "fkey", "lift", "variants", "fast_i",
                 "fast_v")


class _Variant:
    __slots__ = ("in_sig", "avals", "single")

    def __init__(self, in_sig, avals, single):
        self.in_sig = in_sig
        self.avals = avals
        self.single = single


_SITE_CACHE = {}
#: sites kept a code object: a site is its ops' cache-key head, so one
#: evicted and made again misses every segment it is in (SSD-512's
#: forward has more distinct convolutions than the reference's 8)
_SITES_PER_CODE = 256
_intern_stats = {"hit": 0, "miss": 0}
_CHEAP_EQ = (int, float, str, bytes, tuple, np.dtype, slice, frozenset,
             complex, torch.dtype, torch.device)
_IDENTITY_STABLE = (types.FunctionType, types.BuiltinFunctionType, type,
                    types.ModuleType, np.ufunc)


def _cheap_same(v, s):
    if v is s:
        return True
    if type(v) is not type(s):
        return False
    if isinstance(v, _CHEAP_EQ):
        try:
            return bool(v == s)
        except Exception:
            return False
    if type(v) is types.FunctionType:
        # a helper defined afresh on every call of the op wrapper
        if v.__code__ is not s.__code__:
            return False
        vc, sc = v.__closure__ or (), s.__closure__ or ()
        if len(vc) != len(sc):
            return False
        try:
            for a, b in zip(vc, sc):
                if not _cheap_same(a.cell_contents, b.cell_contents):
                    return False
        except ValueError:
            return False
        vd, sd = v.__defaults__ or (), s.__defaults__ or ()
        return len(vd) == len(sd) and all(_cheap_same(a, b)
                                          for a, b in zip(vd, sd))
    return False


def _new_site(fun, fkey, lift):
    site = _Site()
    if fkey is None:
        site.cells = None  # an unkeyable site: always eager
        site.defaults = ()
    else:
        site.cells = tuple(c.cell_contents for c in
                           (getattr(fun, "__closure__", None) or ()))
        site.defaults = tuple(getattr(fun, "__defaults__", None) or ())
    site.fkey = fkey
    site.lift = lift
    site.fast_i, site.fast_v = -1, None
    if site.cells:
        lifted = set(lift)
        for i, v in enumerate(site.cells):
            if i not in lifted and isinstance(v, _IDENTITY_STABLE):
                site.fast_i, site.fast_v = i, v
                break
    site.variants = ()
    return site


def _cells_match(site, fun):
    scells = site.cells
    if scells is None:
        return True
    cells = getattr(fun, "__closure__", None) or ()
    if len(cells) != len(scells):
        return False
    lift = site.lift
    for i, cell in enumerate(cells):
        try:
            v = cell.cell_contents
        except ValueError:
            return False
        if i in lift:
            if type(v) is not type(scells[i]):
                return False
            continue
        if not _cheap_same(v, scells[i]):
            return False
    d = getattr(fun, "__defaults__", None) or ()
    return len(d) == len(site.defaults) and all(
        _cheap_same(a, b) for a, b in zip(d, site.defaults))


def _lookup_site(fun):
    """(the site whose closure snapshot matches ``fun``, or None; its
    cache key, None when ``fun`` cannot be interned)."""
    code = getattr(fun, "__code__", None)
    if code is None:
        try:
            sites = _SITE_CACHE.get(fun)
        except TypeError:
            return None, None
        return (sites[0] if sites else None), fun
    sites = _SITE_CACHE.get(code)
    if sites:
        cells = fun.__closure__
        for s in sites:
            fi = s.fast_i
            if fi >= 0:
                try:
                    v = cells[fi].cell_contents
                except (IndexError, TypeError, ValueError):
                    continue
                sv = s.fast_v
                if v is not sv and (
                        type(v) is not types.FunctionType or
                        type(sv) is not types.FunctionType or
                        v.__code__ is not sv.__code__):
                    continue
            if _cells_match(s, fun):
                return s, code
    return None, code


def _store_site(key, site):
    sites = _SITE_CACHE.get(key) or ()
    _SITE_CACHE[key] = (site,) + sites[:_SITES_PER_CODE - 1]
    return site


def _aval(raw):
    return (tuple(raw.shape), raw.dtype, raw.device)


def _find_variant(site, raws):
    sig = tuple(_aval(r) for r in raws)
    for var in site.variants:
        if var.in_sig == sig:
            return var
    return None


def key_intern_stats():
    """``{"hit", "miss", "sites"}`` of the interned call-site keys."""
    return dict(_intern_stats,
                sites=sum(len(v) for v in _SITE_CACHE.values()))


# --- deferral --------------------------------------------------------------------

def _bypassed():
    """Whether this dispatch must run eagerly whatever the op."""
    from . import amp, autograd as ag, cuda_graph
    from .ops import registry

    if _TLS.flushing or not bulk_enabled():
        return True
    st = ag._STATE
    size = _bulk_size_train if st.training else _bulk_size_infer
    if size <= 1 or st.recording:
        return True
    if _naive if _naive is not None else is_naive():
        return True
    if amp.is_active() or registry._bisect_hook is not None:
        return True
    prof = sys.modules.get("mxnet_tpu_torch.profiler")
    if prof is not None and prof.is_running():
        return True
    return cuda_graph.capturing() or (
        torch.cuda.is_available() and torch.cuda.is_initialized() and
        torch.cuda.is_current_stream_capturing())


def cached_vjp(fun, raws, name=""):
    """``(outs, vjp)`` for an op under ``autograd.record()`` with bulking
    and the async tier on, at a call site that can be keyed: ``outs`` is
    ``fun`` on ``raws`` with torch's graph recorded, and ``vjp(cots)`` the
    gradients of ``raws`` (None for one that needs none).  None when the
    site cannot be cached, or outside those conditions (NaiveEngine, amp,
    the profiler), as in the reference.  ``apply_op`` does not call it:
    torch records an op's backward as it runs, so there is no per-op
    trace to replace."""
    from . import amp
    from .parallel.local import is_dtensor

    if _TLS.flushing or not bulk_enabled() or not _async_on:
        return None
    if bulk_size() <= 1 or (_naive if _naive is not None else is_naive()):
        return None
    if amp.is_active():
        return None
    prof = sys.modules.get("mxnet_tpu_torch.profiler")
    if prof is not None and prof.is_running():
        return None
    site, key = _lookup_site(fun)
    if site is None:
        if key is None:
            return None
        keyed = _fun_key(fun)
        site = _store_site(key, _new_site(
            fun, *(keyed if keyed is not None else (None, ()))))
    if site.fkey is None or any(is_dtensor(r) for r in raws):
        return None
    inputs = [r.detach().requires_grad_(r.is_floating_point())
              for r in raws]
    with torch.enable_grad():
        outs = fun(*inputs)
    flat = outs if isinstance(outs, (tuple, list)) else (outs,)

    def vjp(cots):
        cots = cots if isinstance(cots, (tuple, list)) else (cots,)
        need = [i for i in inputs if i.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o in flat if o.requires_grad],
            need, [c for o, c in zip(flat, cots) if o.requires_grad],
            allow_unused=True, retain_graph=True))
        return tuple(next(got) if i.requires_grad else None
                     for i in inputs)

    return outs, vjp


def maybe_defer(fun, nd_args, name):
    """Append the op to this thread's pending segment.

    Returns ``(single, raws)``, the raws ``_PendingArray`` placeholders
    (real tensors when the append ran a size flush inline), or None when
    the op must run eagerly (recording, NaiveEngine, amp or the profiler
    active, a capture running, an operand over a mesh, a function that
    cannot be keyed or whose shapes cannot be inferred).  Reached only
    behind the ``_bulk_on`` flag."""
    from .parallel.local import is_dtensor

    if not nd_args or _bypassed():
        return None
    raws = [getattr(a, "_raw", None) for a in nd_args]  # a sparse array
    for r in raws:                                     # has no _raw
        if r.__class__ is not _PendingArray and (
                not isinstance(r, torch.Tensor) or is_dtensor(r)):
            return None
    dev = raws[0].device
    if any(r.device != dev for r in raws):
        return None
    site, scode = _lookup_site(fun)
    var = None
    if site is not None:
        if site.fkey is None:
            return None
        var = _find_variant(site, raws)
    if var is not None:
        _intern_stats["hit"] += 1
        if var.avals is None:
            return None
        fkey, lift = site.fkey, site.lift
        avals, single = var.avals, var.single
    else:
        _intern_stats["miss"] += 1
        if site is not None:
            fkey, lift = site.fkey, site.lift
        else:
            keyed = _fun_key(fun)
            if keyed is None:
                if scode is not None:
                    _store_site(scode, _new_site(fun, None, ()))
                return None
            fkey, lift = keyed
            if scode is not None:
                site = _store_site(scode, _new_site(fun, fkey, lift))
        in_sig = tuple(_aval(r) for r in raws)
        info = _out_avals(fun, fkey, in_sig)
        if site is not None:
            site.variants = (_Variant(
                in_sig, None if info is None else info[0],
                None if info is None else info[1]),) + site.variants[:3]
        if info is None:
            return None
        avals, single = info
    cl = fun.__closure__ if lift else None
    lifted = tuple(float(cl[i].cell_contents) for i in lift)

    tls = _TLS
    seg = tls.segment
    if seg is None or seg.results is not None or seg.error is not None:
        seg = tls.segment = _Segment()
    in_refs = []
    stitched = 0
    ext_ids = seg.ext_ids
    for a, raw in zip(nd_args, raws):
        if raw.__class__ is _PendingArray:
            src = raw._segment
            if src is seg:
                in_refs.append(raw._slot)
                continue
            if src.results is not None:
                raw = src.results[raw._slot]
                a._raw = raw
            elif src.error is None and src.submitted:
                skey = ("x", id(src), raw._slot)
                idx = ext_ids.get(skey)
                if idx is None:
                    idx = len(seg.ext)
                    seg.ext.append(_StitchRef(raw))
                    ext_ids[skey] = idx
                stitched += 1
                in_refs.append(-idx - 1)
                continue
            else:
                raw = _materialize(raw)
                a._raw = raw
        idx = ext_ids.get(id(raw))
        if idx is None:
            idx = len(seg.ext)
            seg.ext.append(raw)
            ext_ids[id(raw)] = idx
        in_refs.append(-idx - 1)
    in_refs = tuple(in_refs)
    base = seg.slots
    n_out = len(avals)
    seg.slots = base + n_out
    key_head = site if site is not None else fkey
    seg.ops.append(_SegOp(fun, in_refs, base, n_out, single, name,
                          (key_head, in_refs, name), lift, lifted,
                          tuple(r.dtype for r in raws)))
    if stitched:
        seg.stitched += stitched
        with _STATS_LOCK:
            _async_stats["stitched_inputs"] += stitched
    outs = tuple(_PendingArray(seg, base + j, sh, dt, dev)
                 for j, (sh, dt) in enumerate(avals))
    size = bulk_size()
    if len(seg.ops) >= size:
        tls.segment = None
        if _async_on:
            _submit_async(seg, "size")
        else:
            seg.execute("size")
            return single, tuple(seg.results[o._slot] for o in outs)
    return single, outs


def flush(reason="explicit"):
    """Run this thread's pending segment, then drain the async tier (wait
    for every segment this thread submitted and raise the first worker
    failure).  Returns how many ops the pending segment held."""
    seg = _TLS.segment
    n = 0
    if seg is not None:
        _TLS.segment = None
        n = len(seg.ops)
        seg.execute(reason)
    _drain_async()
    return n


def pending_ops():
    """Ops in this thread's pending segment (0 when idle)."""
    seg = _TLS.segment
    return len(seg.ops) if seg is not None else 0


def _materialize(pending, reason="host_sync"):
    """The tensor of a ``_PendingArray``: its segment runs now when it is
    this thread's pending one; a submitted one is waited for.  A failure
    of the segment is raised here, naming its ops."""
    seg = pending._segment
    if seg.results is None:
        if seg.submitted:
            _wait_done(seg)
        elif seg.error is None:
            if seg is _TLS.segment:
                _TLS.segment = None
            seg.execute(reason)
    if seg.error is not None:
        seg.error_delivered = True
        raise seg.error
    return seg.results[pending._slot]


def _before_read(raw):
    """An array is read (``NDArray._data``) while bulking is on: when it
    is an input of this thread's pending segment, that segment runs
    first, and a submitted one is waited for, so that no in-place write
    runs ahead of a deferred read of the old value."""
    seg = _TLS.segment
    key = id(raw)
    if seg is not None:
        ids = seg.ext_ids
        if ids and key in ids:
            flush("host_sync")
            return
    for s in _TLS.inflight:
        ids = s.ext_ids
        if ids and key in ids:
            _wait_done(s)


from . import telemetry  # noqa: E402  (telemetry imports this module)
from .telemetry import memwatch as _mw  # noqa: E402
from .telemetry import retrace as _retrace  # noqa: E402

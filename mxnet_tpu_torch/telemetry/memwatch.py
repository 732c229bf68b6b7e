"""Device-memory observability: the live-storage ledger and the OOM
post-mortem.

Counterpart of ``mxnet_tpu/telemetry/memwatch.py``.  Every NDArray bind
(an array made by an op, a creation function or a copy, and the
gradient buffers ``autograd.backward`` binds) registers its tensor's
storage here.  Torch tensors alias where JAX arrays do not: views,
``reshape`` and ``_data`` rebinds share one untyped storage, so the
ledger counts a storage once (keyed on the untyped storage, its whole
``nbytes``) and releases it when the storage itself is freed (a weak
reference on torch's storage object, which lives as long as the storage
does), not when one of its views goes.

Accounting is arithmetic only: tracking never synchronizes and never
reads data.  State:

* ``live_bytes()`` / ``live_bytes_by_device()`` — the current gauge;
* ``peak_live_bytes()`` — the high-water mark since the last
  ``step_mark()`` (``telemetry.step_begin`` calls it);
* while the profiler runs, every change mirrors a chrome-trace counter
  sample (``memwatch.live_bytes``).

On a card the caching allocator is the truth: ``torch.cuda.
memory_allocated()`` also holds tensors no NDArray ever bound (autograd's
saved activations, an op's temporaries, a CUDA graph's private pool) and
the allocator's rounding, so it reads above ``live_bytes()``.

The post-mortem: the dispatch sites (``ops.registry.apply_op``,
``CachedOp``, the Trainer's update, ``FusedTrainStep``) call
``annotate_oom`` from their except paths behind the ``_enabled`` flag.
A ``torch.cuda.OutOfMemoryError`` (or an error whose text says the
device ran out of memory) writes a ranked report of the live storages
(size, dtype, owning parameter name, age in steps) and raises ``OOMError``
naming the report and the largest buffers; any other error passes
through unchanged.

Every hook is ``if _mw._enabled: ...``: one module-global boolean test
when off.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import weakref

from ..base import MXNetError

__all__ = ["enable", "disable", "is_enabled", "track", "donated", "adopt",
           "live_bytes", "live_bytes_by_device", "peak_live_bytes",
           "peak_live_bytes_by_device",
           "step_mark", "ledger_size", "snapshot", "write_postmortem",
           "annotate_oom", "looks_like_oom", "OOMError"]

#: THE fast-path flag: every hook is ``if _mw._enabled: ...``
_enabled = False
# re-entrant: a storage freed by a collection that runs inside a locked
# region calls back into the ledger on the same thread
_lock = threading.RLock()
_ledger = {}            # id(storage object) -> _Entry
_live_total = 0
_live_by_device = {}    # device label -> bytes
_peak_total = 0
_peak_by_device = {}
_step_idx = 0           # pushed by telemetry.step_begin via step_mark()
_named = []             # [(weakref(NDArray holder), name)]: owner labels
_report_path = None


class OOMError(MXNetError):
    """A device allocation failure, raised again with the post-mortem."""


class _Entry:
    __slots__ = ("nbytes", "shape", "dtype", "device", "owner",
                 "birth_step", "ref")


def _storage(t):
    """The untyped storage of a plain tensor (a DTensor's local piece),
    or None for tensors without one (meta, fake and other subclasses)."""
    import torch

    from ..parallel.local import is_dtensor, local

    if is_dtensor(t):
        t = local(t)
    if type(t) not in (torch.Tensor, torch.nn.Parameter) or \
            t.device.type == "meta":
        return None
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def _device_label(t):
    dev = t.device
    return f"{dev.type}:{dev.index or 0}"


def _scope_owner():
    prof = sys.modules.get("mxnet_tpu_torch.profiler")
    if prof is None:
        return None
    prefix = prof.current_scope_prefix()
    return prefix.rstrip(":") if prefix else None


def _mirror_counter(total, by_device):
    prof = sys.modules.get("mxnet_tpu_torch.profiler")
    if prof is not None and prof.is_running():
        series = {"total": total}
        series.update(by_device)
        prof.record_counter_event("memwatch.live_bytes", series)


def _add_locked(e):
    global _live_total, _peak_total
    _live_total += e.nbytes
    cur = _live_by_device.get(e.device, 0) + e.nbytes
    _live_by_device[e.device] = cur
    if cur > _peak_by_device.get(e.device, 0):
        _peak_by_device[e.device] = cur
    if _live_total > _peak_total:
        _peak_total = _live_total


def _sub_locked(e):
    global _live_total
    _live_total -= e.nbytes
    cur = _live_by_device.get(e.device, 0) - e.nbytes
    if cur > 0:
        _live_by_device[e.device] = cur
    else:
        _live_by_device.pop(e.device, None)


# -- the ledger ---------------------------------------------------------------

def track(raw, owner=None):
    """Register the storage of tensor ``raw`` (idempotent per storage:
    views and rebinds over one storage count once).  Tensors without a
    storage of their own (meta, fake, other subclasses) are ignored.
    Release is automatic when the storage is freed."""
    if not _enabled:
        return
    st = _storage(raw)
    if st is None:
        return
    key = id(st)
    with _lock:
        e = _ledger.get(key)
        if e is not None:
            if e.ref() is st:
                if owner is not None and e.owner is None:
                    e.owner = owner
                return
            # id reuse: the registered storage died before its callback
            # ran; evict the stale entry first
            del _ledger[key]
            _sub_locked(e)
        e = _Entry()
        e.nbytes = st.nbytes()
        e.shape = tuple(raw.shape)
        e.dtype = str(raw.dtype).replace("torch.", "")
        e.device = _device_label(raw)
        e.owner = owner if owner is not None else _scope_owner()
        e.birth_step = _step_idx

        def _cb(ref, _key=key):
            with _lock:
                dead = _ledger.get(_key)
                if dead is not None and dead.ref is ref:
                    del _ledger[_key]
                    _sub_locked(dead)
                total, by_dev = _live_total, dict(_live_by_device)
            _mirror_counter(total, by_dev)

        e.ref = weakref.ref(st, _cb)
        _ledger[key] = e
        _add_locked(e)
        total, by_dev = _live_total, dict(_live_by_device)
    _mirror_counter(total, by_dev)


def donated(raws):
    """Release these tensors' storages from the ledger now (the
    reference's donation hook: a dispatch that consumed its inputs).
    Nothing in the port donates; the entry stays for callers that free a
    storage they know is gone."""
    if not _enabled:
        return
    with _lock:
        changed = False
        for raw in raws:
            st = _storage(raw)
            e = _ledger.get(id(st)) if st is not None else None
            if e is None or e.ref() is not st:
                continue
            del _ledger[id(st)]
            _sub_locked(e)
            changed = True
        total, by_dev = _live_total, dict(_live_by_device)
    if changed:
        _mirror_counter(total, by_dev)


def adopt(holder, name):
    """Label an NDArray holder with a stable owner name: a parameter
    registers its data holder, so the post-mortem names its storage
    ``name`` and its gradient's ``name.grad``, across rebinds."""
    if not _enabled:
        return
    try:
        ref = weakref.ref(holder)
    except TypeError:
        return
    with _lock:
        _named.append((ref, name))


def step_mark(step_idx):
    """Reset the per-step peak to the current live level (called from
    ``telemetry.step_begin``)."""
    global _peak_total, _step_idx
    if not _enabled:
        return
    with _lock:
        _step_idx = step_idx
        _peak_total = _live_total
        _peak_by_device.clear()
        _peak_by_device.update(_live_by_device)


def live_bytes():
    """Current tracked bytes (sum over devices)."""
    with _lock:
        return _live_total


def live_bytes_by_device():
    with _lock:
        return dict(_live_by_device)


def peak_live_bytes():
    """High-water mark of ``live_bytes`` since the last step_mark()."""
    with _lock:
        return _peak_total


def peak_live_bytes_by_device():
    with _lock:
        return dict(_peak_by_device)


def ledger_size():
    with _lock:
        return len(_ledger)


def snapshot():
    """Ranked (largest first) list of live-storage dicts: the
    post-mortem's body.  Owner names resolve through the adopted holders
    at snapshot time."""
    with _lock:
        owners = _resolve_owners_locked()
        rows = []
        for key, e in list(_ledger.items()):
            rows.append({
                "nbytes": e.nbytes,
                "shape": list(e.shape),
                "dtype": e.dtype,
                "device": e.device,
                "owner": owners.get(key, e.owner),
                "age_steps": max(0, _step_idx - e.birth_step),
            })
    rows.sort(key=lambda r: -r["nbytes"])
    return rows


def _resolve_owners_locked():
    owners = {}
    alive = []
    for ref, name in _named:
        holder = ref()
        if holder is None:
            continue
        alive.append((ref, name))
        grad = getattr(holder, "_grad", None)
        for arr, label in ((holder, name), (grad, name + ".grad")):
            raw = getattr(arr, "_data", None)
            st = _storage(raw) if raw is not None else None
            if st is not None:
                owners[id(st)] = label
    _named[:] = alive
    return owners


# -- OOM post-mortem ----------------------------------------------------------

_OOM_MARKERS = ("CUDA out of memory", "out of memory", "Out of memory",
                "can't allocate memory", "RESOURCE_EXHAUSTED",
                "Failed to allocate", "failed to allocate",
                "Allocation failure")


def looks_like_oom(exc):
    """Is this a device allocation failure?  ``torch.cuda.
    OutOfMemoryError``, or an error whose text says so."""
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(m in text for m in _OOM_MARKERS)


def write_postmortem(path=None, context="", error=""):
    """Write the ranked live-storage report and the top cost-registry
    entries to ``path`` (default: ``MXNET_MEMWATCH_REPORT`` or
    ``memwatch_oom_<pid>.json`` in the working directory).  Returns the
    path."""
    from . import costs as _costs

    if path is None:
        path = _report_path or os.environ.get(
            "MXNET_MEMWATCH_REPORT") or f"memwatch_oom_{os.getpid()}.json"
    buffers = snapshot()
    with _lock:
        report = {
            "context": context,
            "error": error,
            "wall_time": time.time(),
            "step": _step_idx,
            "live_bytes": _live_total,
            "peak_live_bytes": _peak_total,
            "live_bytes_by_device": dict(_live_by_device),
            "n_live_buffers": len(_ledger),
        }
    report["buffers"] = buffers
    report["allocator"] = _allocator_stats()
    report["top_artifacts_by_temp_bytes"] = \
        _costs.top_artifacts(n=10, by="temp_bytes")
    # the flight recorders join the post-mortem: the last completed
    # request traces, and the last step records and anomalies (rank-
    # stamped) before the OOM
    tr = sys.modules.get("mxnet_tpu_torch.telemetry.tracing")
    if tr is not None and tr.is_enabled():
        try:
            report["recent_traces"] = tr.recent(8)
        except Exception:  # noqa: BLE001 - never masks the failure
            pass
    fl = sys.modules.get("mxnet_tpu_torch.telemetry.fleet")
    if fl is not None and fl.is_enabled():
        try:
            report["recent_steps"] = fl.recent(16)
        except Exception:  # noqa: BLE001 - never masks the failure
            pass
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    return path


def _allocator_stats():
    """The caching allocator's allocated and reserved bytes of each card
    (empty without one)."""
    import torch

    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {"allocated": torch.cuda.memory_allocated(i),
                          "reserved": torch.cuda.memory_reserved(i)}
            for i in range(torch.cuda.device_count())}


def annotate_oom(exc, context=""):
    """Called from dispatch except paths (behind the ``_enabled`` flag):
    if ``exc`` is an allocation failure, write the post-mortem and raise
    ``OOMError`` naming the report file and the largest live buffers;
    otherwise return, so the caller raises the original unchanged."""
    if not _enabled or not looks_like_oom(exc):
        return
    try:
        path = write_postmortem(context=context, error=str(exc))
        top = snapshot()[:3]
    except Exception:  # noqa: BLE001 - never mask the original failure
        return
    largest = "; ".join(
        f"{r['owner'] or '<unnamed>'} {r['shape']} {r['dtype']} "
        f"{r['nbytes']} bytes on {r['device']}" for r in top)
    raise OOMError(
        f"device allocation failure during {context or 'dispatch'}: {exc}\n"
        f"largest live buffers: {largest or 'none tracked'}\n"
        f"memwatch post-mortem (ranked live buffers) written to {path}") \
        from exc


# -- lifecycle ----------------------------------------------------------------

def enable(report_path=None):
    """Turn the ledger on (clears prior state).  Arrays bound while it was
    off are not tracked: enable before building the model for an exact
    ledger."""
    global _enabled, _report_path
    with _lock:
        _clear_locked()
        _report_path = report_path
    _enabled = True


def disable():
    global _enabled
    _enabled = False
    with _lock:
        _clear_locked()


def is_enabled():
    return _enabled


def _clear_locked():
    global _live_total, _peak_total, _step_idx
    _ledger.clear()
    _live_by_device.clear()
    _peak_by_device.clear()
    _named.clear()
    _live_total = 0
    _peak_total = 0
    _step_idx = 0

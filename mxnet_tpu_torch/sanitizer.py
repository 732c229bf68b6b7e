"""Runtime sanitizers: buffer donation (``MXNET_SANITIZE_DONATION=1``)
and lock order (``MXNET_SANITIZE_LOCKS=1``).

Counterpart of ``mxnet_tpu/sanitizer.py``, with the same names, messages
and lock names, so the two packages' lock-order graphs key alike.

**Donation.**  In the reference the hot paths donate their parameter and
optimizer-state buffers to XLA (``donate_argnums``), after which the old
buffers are dead and any NDArray still holding one is a stale view; the
sanitizer turns a read of one into a precise ``DonatedBufferError``
naming the donating site.  The port's updates are in place instead: the
fused update kernel writes into the weights', masters' and states' own
tensors (``optimizer._fused_param_updates``) and ``FusedTrainStep``
into its graph's static tensors, so no buffer dies and a ``detach()``
taken before a step reads the NEW weights (ROADMAP.md, "Traps on the
reference").  What is ported is the API and its read sites: a tensor
handed to :func:`donate` (by a caller, or by a port path that rebinds a
holder to a fresh tensor) fails its next read through any NDArray that
shares it — ``asnumpy``, ``wait_to_read``, ``copyto``, ``asnative``,
wrapping, and every ``apply_op`` operand.

* ``_enabled`` is a module global read unlocked on every fast path;
  callers in per-op code guard with ``if sanitizer._enabled:`` so the
  disabled cost is one attribute load and a falsy branch.
* Donation is tracked per tensor object, keyed by ``id`` with a weakref
  guarding against id reuse, so every NDArray holding that tensor —
  ``detach()`` views made before the donation included — is poisoned.
  ``NDArray._donated`` surfaces the site.  A holder rebound to a fresh
  tensor is clean by construction.

**Locks.**  :func:`wrap_lock` wraps the package's named locks in a proxy
that, while enabled, records per-thread held stacks, the observed
acquisition-order edges and held-while-blocking events; a cycle in the
edges is a lock-order violation (``lock_order_violations``).  Disabled,
each operation is one boolean check and a delegation.
"""
from __future__ import annotations

import os
import threading
import weakref

from .base import MXNetError

__all__ = ["DonatedBufferError", "is_enabled", "enable", "disable",
           "donate", "site_of", "check", "reset",
           "wrap_lock", "locks_enabled", "enable_locks", "disable_locks",
           "reset_locks", "lock_order_edges", "lock_order_violations",
           "held_blocking_events", "set_trace_hook",
           "retrace", "RetraceError"]


def __getattr__(name):
    # the recompile sanitizer (MXNET_SANITIZE_RETRACE) lives with the
    # other one-boolean-null-path tiers in telemetry/retrace.py;
    # re-exported here so every runtime sanitizer is reachable from one
    # module.  Resolved lazily: telemetry.fleet wraps its lock through
    # THIS module at import time, so an eager import would be circular.
    if name == "retrace":
        from .telemetry import retrace as _retrace
        return _retrace
    if name == "RetraceError":
        from .telemetry.retrace import RetraceError as _err
        return _err
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class DonatedBufferError(MXNetError):
    """A device buffer was read after being donated to a jitted call."""


def _env_on() -> bool:
    return os.environ.get("MXNET_SANITIZE_DONATION", "").strip().lower() \
        not in ("", "0", "false", "off", "no")


#: fast-path flag: read unlocked everywhere, flipped only by
#: enable()/disable().  Import-time autostart mirrors MXNET_TELEMETRY.
_enabled = _env_on()

#: id(tensor) -> (weakref-or-None, site str).  The weakref both
#: auto-evicts entries when the donated tensor goes away and guards the
#: id against reuse by a new tensor.
_donated = {}


def is_enabled() -> bool:
    return _enabled


def enable():
    """Turn the sanitizer on (tests; production uses the env var)."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False
    _donated.clear()


def reset():
    """Forget every recorded donation (keeps the enabled state)."""
    _donated.clear()


def donate(raws, site: str):
    """Record that the tensors in ``raws`` were donated at ``site``:
    their next read through any NDArray raises.  ``None`` entries
    (absent masters) are skipped; an object that takes no weakref is
    registered without the reuse guard."""
    if not _enabled:
        return
    for raw in raws:
        if raw is None:
            continue
        key = id(raw)
        try:
            ref = weakref.ref(raw, lambda _r, _k=key: _donated.pop(_k, None))
        except TypeError:
            ref = None
        _donated[key] = (ref, site)


def site_of(raw):
    """The donation site string for ``raw``, or None if it is live."""
    entry = _donated.get(id(raw))
    if entry is None:
        return None
    ref, site = entry
    if ref is not None and ref() is not raw:
        # the donated buffer was collected and its id recycled by a new,
        # live array — drop the stale entry
        _donated.pop(id(raw), None)
        return None
    return site


def check(raw, op: str = "read"):
    """Raise DonatedBufferError if ``raw`` was donated.

    Callers guard with ``if sanitizer._enabled:`` so the disabled path
    never even enters this function.
    """
    site = site_of(raw)
    if site is not None:
        raise DonatedBufferError(
            f"NDArray {op}: buffer used after donation at {site}. "
            "The buffer was handed to XLA via donate_argnums and is no "
            "longer valid; re-read the value from its owner (e.g. "
            "param.data()) after the donating call, or .copy() the array "
            "before it.  (Detected by MXNET_SANITIZE_DONATION=1; see "
            "docs/lint.md T6/T7 for the donation contract.)")


# ---------------------------------------------------------------------------
# Lock-order sanitizer (``MXNET_SANITIZE_LOCKS=1``)
# ---------------------------------------------------------------------------
# The package's named locks are wrapped in :class:`_SanLock`, which —
# when enabled — records per-thread held-lock stacks, the observed
# acquisition-order edges (held -> acquired), and held-while-blocking
# events (acquiring a contended lock while already holding one).  A
# cycle in the observed edge set is a lock-order violation: two threads
# took the same locks in opposite orders and a deadlock is one bad
# schedule away.  Lock names are the reference's (``capacity._lock``,
# ``lanes.DecodeLane._hand_lock``), so both packages' graphs key alike.
#
# Disabled cost (the default): ``acquire``/``release``/``__enter__``/
# ``__exit__`` check one module-global boolean and delegate, pinned by
# the overhead bound in tests/test_torch_sanitizer.py.
#
# ``set_trace_hook`` exposes the acquire/acquired/released event stream,
# for a harness that parks threads at lock boundaries to drive a chosen
# interleaving.


def _locks_env_on() -> bool:
    return os.environ.get("MXNET_SANITIZE_LOCKS", "").strip().lower() \
        not in ("", "0", "false", "off", "no")


#: fast-path flag: read unlocked in every _SanLock method, flipped only
#: by enable_locks()/disable_locks().
_locks_enabled = _locks_env_on()

#: guards the registries below (never wrapped itself)
_locks_lock = threading.Lock()

#: (src name, dst name) -> first-observed site "thread-name"
_order_edges = {}

#: held-while-blocking events: (held name, wanted name, thread name)
_blocked_events = []

#: optional callable(event, lock_name) with event in
#: {"acquire", "acquired", "released"}; called OUTSIDE _locks_lock
_trace_hook = None

#: per-thread stack of _SanLock names currently held
_held = threading.local()


def _held_stack():
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def locks_enabled() -> bool:
    return _locks_enabled


def enable_locks():
    """Turn the lock sanitizer on (tests; production uses the env var)."""
    global _locks_enabled
    _locks_enabled = True


def disable_locks():
    global _locks_enabled
    _locks_enabled = False


def reset_locks():
    """Forget every recorded edge/event (keeps the enabled state)."""
    with _locks_lock:
        _order_edges.clear()
        del _blocked_events[:]


def set_trace_hook(cb):
    """Install (or clear, with None) the acquire-event hook.  Returns
    the previous hook (a harness serializes threads at lock boundaries
    through it)."""
    global _trace_hook
    prev = _trace_hook
    _trace_hook = cb
    return prev


def lock_order_edges():
    """``{(src, dst): site}`` — every observed held->acquired pair."""
    with _locks_lock:
        return dict(_order_edges)


def held_blocking_events():
    """Events where a thread blocked on a contended lock while already
    holding one — the dynamic half of T11's blocking-under-lock."""
    with _locks_lock:
        return list(_blocked_events)


def lock_order_violations():
    """Cycles in the observed acquisition-order graph, as a list of
    ``[name, name, ...]`` chains (empty == discipline held)."""
    edges = lock_order_edges()
    adj = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
    cycles = []
    seen = set()
    for start in sorted(adj):
        stack = [(start, (start,))]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(adj.get(node, ())):
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen:
                        seen.add(key)
                        cycles.append(list(path) + [start])
                elif nxt not in path and len(path) < 16:
                    stack.append((nxt, path + (nxt,)))
    return cycles


class _SanLock:
    """Instrumentation proxy around a ``threading`` lock/condition.

    Delegates everything to the wrapped primitive; when the sanitizer
    is enabled, acquisition records order edges against the calling
    thread's held stack.  ``wait``/``wait_for`` (Condition protocol)
    pop the lock around the wait — the condition releases it — so the
    held stack mirrors reality."""

    __slots__ = ("_lock", "name")

    def __init__(self, lock, name):
        self._lock = lock
        self.name = name

    # -- instrumented core ---------------------------------------------------
    def acquire(self, *args, **kwargs):
        if not _locks_enabled:
            return self._lock.acquire(*args, **kwargs)
        return self._acquire_traced(args, kwargs)

    def _acquire_traced(self, args, kwargs):
        hook = _trace_hook
        if hook is not None:
            hook("acquire", self.name)
        stack = _held_stack()
        if stack and self._locked():
            with _locks_lock:
                _blocked_events.append(
                    (stack[-1], self.name,
                     threading.current_thread().name))
        ok = self._lock.acquire(*args, **kwargs)
        if ok:
            if stack:
                site = threading.current_thread().name
                with _locks_lock:
                    for h in stack:
                        if h != self.name:
                            _order_edges.setdefault((h, self.name), site)
            stack.append(self.name)
            if hook is not None:
                hook("acquired", self.name)
        return ok

    def release(self):
        if not _locks_enabled:
            return self._lock.release()
        stack = _held_stack()
        if self.name in stack:
            stack.remove(self.name)
        self._lock.release()
        hook = _trace_hook
        if hook is not None:
            hook("released", self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _locked(self):
        probe = getattr(self._lock, "locked", None)
        if probe is None:
            return False
        try:
            return bool(probe())
        except TypeError:
            return False

    # -- Condition protocol --------------------------------------------------
    def wait(self, timeout=None):
        if not _locks_enabled:
            return self._lock.wait(timeout)
        stack = _held_stack()
        popped = self.name in stack
        if popped:
            stack.remove(self.name)
        try:
            return self._lock.wait(timeout)
        finally:
            if popped:
                stack.append(self.name)

    def wait_for(self, predicate, timeout=None):
        if not _locks_enabled:
            return self._lock.wait_for(predicate, timeout)
        stack = _held_stack()
        popped = self.name in stack
        if popped:
            stack.remove(self.name)
        try:
            return self._lock.wait_for(predicate, timeout)
        finally:
            if popped:
                stack.append(self.name)

    def __getattr__(self, attr):
        # notify/notify_all/locked/_is_owned/... delegate untouched
        return getattr(self._lock, attr)

    def __repr__(self):
        return f"<_SanLock {self.name} wrapping {self._lock!r}>"


def wrap_lock(lock, name: str):
    """Wrap a ``threading`` lock/RLock/Condition for the lock
    sanitizer.  ``name`` is the lock's identity — ``module.GLOBAL_NAME``
    or ``module.Class.attr``, the reference's names — so both packages'
    order graphs line up.  The proxy is always
    returned (construction cost is two slot writes); with the sanitizer
    disabled every operation is one boolean check plus delegation."""
    return _SanLock(lock, name)

"""Compiled-cost observability: flops and bytes per compile site.

Counterpart of ``mxnet_tpu/telemetry/costs.py``.  The reference harvests
XLA's ``cost_analysis()`` once per compiled signature; the port has no
compiler to ask, so each compile site (``CachedOp`` and its recorded
backward, ``FusedTrainStep``, the Trainer's fused update) counts its
work once, at a signature's first sighting, in the eager run that
precedes its capture (never during a capture), and every later call of
the signature is a dict hit that attributes the stored numbers to the
current telemetry step (``cost.model_flops``, ``cost.bytes_accessed``).

What is counted, under ``counting()`` (a ``TorchDispatchMode``):

* **flops** of each dispatched op by the rules of
  ``torch.utils.flop_counter`` (matrix products, convolutions,
  attention; elementwise ops count none), and
* **bytes**: each dispatched op's input bytes plus its output bytes,
  views excluded: the memory traffic of the same work run as an
  unfused program, an upper bound of what the fused kernels move.

The hand-written kernels are invisible to that counter (``ctypes``
launches, or custom ops it does not know), so each wrapper reports its
own work through ``kernel(cost_fn, ...)`` by the formula its bound
uses in ``chip_smoke.py``: attention's products over the visible
(query, key) pairs, causal counted as half; 2·M·N·K for the fused 1×1
conv; bytes as each input read once and each output written once.  The
plain route a wrapper takes on the CPU runs with the counter paused, so
its ops are not counted twice.

``telemetry.step_end`` folds the step's sums into ``model_flops``,
``bytes_accessed`` and ``mfu`` = model_flops / (step seconds ·
``peak_flops()``), where the peak is ``set_peak_flops``, the
``MXNET_PEAK_FLOPS`` environment variable, or the table below keyed on
``torch.cuda.get_device_name()``; ``mfu`` is null on the CPU and for a
card without an entry.

Every hook is ``if _costs._enabled: ...`` (one boolean when off); the
kernels' is ``if _costs._counting: with costs.kernel(...)`` (one
boolean when no count is running).
"""
from __future__ import annotations

import json
import os
import threading

__all__ = ["enable", "disable", "is_enabled", "note", "get", "snapshot",
           "dump", "top_artifacts", "stats", "set_peak_flops",
           "peak_flops", "device_kind", "counting", "first", "kernel"]

#: THE fast-path flag: every compile-site hook is ``if _costs._enabled``
_enabled = False
#: open ``counting()`` scopes (on any thread): the kernels' fast path
_counting = 0
_lock = threading.Lock()
_registry = {}                      # (kind, key) -> _Artifact
_stats = {"analyzed": 0, "hits": 0, "errors": 0}
_peak_flops_override = None

#: dense bf16 peak FLOP/s of a card, matched by lowercase substring of
#: ``torch.cuda.get_device_name()`` (first match wins).  NVIDIA's H100
#: data sheet, SXM part, dense (no sparsity), at its 700 W limit; another
#: card (or a PCIe part) takes ``set_peak_flops`` or MXNET_PEAK_FLOPS.
_PEAK_FLOPS_TABLE = (
    ("h100", 989e12),
)


class _Artifact:
    """One compile site's signature: its counted work and executions."""

    __slots__ = ("kind", "key", "flops", "bytes_accessed", "output_bytes",
                 "temp_bytes", "argument_bytes", "alias_bytes",
                 "generated_code_bytes", "executions", "error",
                 "mesh_shape", "remat", "site")

    def __init__(self, kind, key, site=None):
        self.kind = kind
        self.key = key
        self.mesh_shape = None
        self.remat = None
        self.site = site
        self.flops = 0.0
        self.bytes_accessed = 0.0
        # XLA's memory analysis has no counterpart: these stay 0
        self.output_bytes = 0
        self.temp_bytes = 0
        self.argument_bytes = 0
        self.alias_bytes = 0
        self.generated_code_bytes = 0
        self.executions = 0
        self.error = None

    def as_dict(self):
        return {
            "kind": self.kind,
            "key": _key_str(self.key),
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "argument_bytes": self.argument_bytes,
            "alias_bytes": self.alias_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "executions": self.executions,
            "error": self.error,
            "mesh_shape": self.mesh_shape,
            "remat": self.remat,
            "site": self.site,
        }


def _key_str(key, limit=300):
    text = repr(key)
    return text if len(text) <= limit else text[:limit] + "..."


# -- the counter --------------------------------------------------------------

def _tensor_bytes(tree):
    import torch

    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


def _mode_class():
    """The dispatch-mode class, made at first use (torch's dispatch-mode
    machinery is not imported with the package)."""
    global _Counter
    if _Counter is not None:
        return _Counter
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Counter(TorchDispatchMode):
        """Flops (``torch.utils.flop_counter``'s rules) and input+output
        bytes of every op dispatched under it, plus what the kernels'
        wrappers report."""

        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            rule = flop_registry.get(func._overloadpacket)
            if rule is not None:
                self.flops += float(rule(*args, **kwargs, out_val=out))
            if not getattr(func, "is_view", False):
                self.bytes += _tensor_bytes((args, kwargs)) + \
                    _tensor_bytes(out)
            return out

    _Counter = Counter
    return Counter


_Counter = None


class _Counting:
    """``counting()``'s context: enters the dispatch mode and keeps the
    kernels' ``_counting`` flag up while it runs."""

    __slots__ = ("mode",)

    def __enter__(self):
        global _counting
        self.mode = _mode_class()()
        self.mode.__enter__()
        with _lock:
            _counting += 1
        return self.mode

    def __exit__(self, *exc):
        global _counting
        with _lock:
            _counting -= 1
        return self.mode.__exit__(*exc)


def counting():
    """Count the flops and bytes of the work run inside (``with
    costs.counting() as c: ...; c.flops, c.bytes``)."""
    return _Counting()


class _Null:
    """Shared no-op context (no count to make)."""

    __slots__ = ()
    flops = None
    bytes = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def first(kind, key):
    """``counting()`` when the registry is on and ``(kind, key)`` has not
    been seen, else the shared null context (whose ``flops`` is None):
    the site runs its first sighting inside it, then calls ``note``."""
    if not _enabled or (kind, key) in _registry:
        return _NULL
    return counting()


def _active_counter():
    """The innermost ``Counter`` on the current dispatch-mode stack (the
    stack follows a backward onto autograd's threads)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if _Counter is not None and isinstance(mode, _Counter):
            return mode
    return None


def kernel(cost_fn, *args):
    """Context of a hand-written kernel's call.  While a count runs,
    adds ``cost_fn(*args)`` = (flops, bytes) to it and pauses the counter
    for the body (its plain route's ops are that same work); otherwise
    the shared null context."""
    if not _counting:
        return _NULL
    counter = _active_counter()
    if counter is None:
        return _NULL
    flops, nbytes = cost_fn(*args)
    counter.flops += float(flops)
    counter.bytes += float(nbytes)
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()


# -- the registry -------------------------------------------------------------

def note(kind, key, counted=None, attribute=True, scale=1, site=None,
         remat=None):
    """Register-or-attribute one execution of a site's signature.
    ``key`` is the site's own cache signature (hashable); ``counted`` the
    ``counting()`` result of its first sighting (None on later calls);
    ``scale`` multiplies the counted work when the first sighting ran a
    fraction of the signature's program (one of ``FusedTrainStep``'s K
    steps).  ``remat`` stamps the remat tier the entry ran under (the
    planner's registry lookup keys on it).  Later sightings only
    attribute.  ``attribute=False``
    registers without counting an execution.  Returns the entry (None
    when disabled or the key is unhashable)."""
    if not _enabled:
        return None
    rk = (kind, key)
    try:
        art = _registry.get(rk)
    except TypeError:
        return None
    with _lock:
        if art is None:
            art = _registry.get(rk)
        if art is None:
            art = _Artifact(kind, key, site=site)
            art.remat = remat
            if counted is None or counted.flops is None:
                art.error = "first sighting not counted"
                _stats["errors"] += 1
            else:
                art.flops = float(counted.flops) * scale
                art.bytes_accessed = float(counted.bytes) * scale
            _registry[rk] = art
            _stats["analyzed"] += 1
        else:
            _stats["hits"] += 1
        if attribute:
            art.executions += 1
    if not attribute:
        return art
    from . import count

    if art.error is None:  # a counted entry attributes, zero flops too
        count("cost.model_flops", art.flops)
        count("cost.bytes_accessed", art.bytes_accessed)
    return art


def get(kind, key):
    """The registry entry for ``(kind, key)`` or None."""
    try:
        return _registry.get((kind, key))
    except TypeError:
        return None


def snapshot():
    """All registry entries as JSON-ready dicts."""
    with _lock:
        arts = list(_registry.values())
    return [a.as_dict() for a in arts]


def top_artifacts(n=10, by="temp_bytes"):
    """Top ``n`` entries ranked by ``by``."""
    rows = snapshot()
    rows.sort(key=lambda r: -(r.get(by) or 0))
    return rows[:n]


def stats():
    """{"analyzed": n, "hits": n, "errors": n, "size": n}."""
    with _lock:
        return dict(_stats, size=len(_registry))


def dump(path=None):
    """The registry as a JSON-ready dict (written to ``path`` when
    given), in the reference's layout."""
    payload = {
        "version": 1,
        "device_kind": device_kind(),
        "peak_flops": peak_flops(),
        "stats": stats(),
        "entries": snapshot(),
    }
    if path is not None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
    return payload


# -- peak FLOP/s --------------------------------------------------------------

def device_kind():
    """``torch.cuda.get_device_name(0)``, or None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0)


def set_peak_flops(value):
    """Set the peak FLOP/s used for MFU (None: back to the environment
    and the table).  Returns the previous setting."""
    global _peak_flops_override
    prev = _peak_flops_override
    _peak_flops_override = float(value) if value is not None else None
    return prev


def peak_flops():
    """Peak FLOP/s for MFU: ``set_peak_flops``, else ``MXNET_PEAK_FLOPS``,
    else the table by the card's name; None when unknown (the CPU): MFU
    is then null rather than taken against a made-up peak."""
    if _peak_flops_override is not None:
        return _peak_flops_override
    env = os.environ.get("MXNET_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    kind = device_kind()
    if kind:
        lowered = kind.lower()
        for marker, value in _PEAK_FLOPS_TABLE:
            if marker in lowered:
                return value
    return None


# -- lifecycle ----------------------------------------------------------------

def enable():
    """Turn the registry on (clears prior entries)."""
    global _enabled
    with _lock:
        _registry.clear()
        _stats.update(analyzed=0, hits=0, errors=0)
    _enabled = True


def disable():
    """Turn the registry off; its entries stay for ``dump()``."""
    global _enabled
    _enabled = False


def is_enabled():
    return _enabled

"""Tensor statistics of the step: layer-resolved numerics telemetry.

Counterpart of ``mxnet_tpu/telemetry/numerics.py``.  Per-layer and
per-parameter l2 norm, max-abs, mean and nan/inf counts, computed as
torch ops on the card beside the step's own work and copied to the host
in ONE transfer every ``stride`` steps.

The tier keeps the reference's contract:

* **one-boolean disabled path**: ``tap()`` is ``if not _enabled:
  return`` when off; nothing allocates, nothing locks.
* **one graph per mode**: ``signature()`` is part of every graph key
  (``CachedOp``, ``FusedTrainStep``, the Trainer's fused update), so
  numerics on and numerics off each keep exactly one CUDA graph of a
  signature, and a graph captured in one mode never replays in the
  other.
* **never raises into training**: a failed stat drops that stat.
* **host work only at the stride**: off-stride steps drop their pending
  statistics without touching the card, and an eager tap off the stride
  computes nothing (inside a CUDA graph the taps run on every replay).

A CUDA graph replay runs no Python, so a tap cannot run at replay time.
While a graph is captured, its forward runs inside a ``collecting()``
scope: every tap appends its statistics (torch ops on the capture
stream) to the scope, and the capturing site returns them stacked as one
more graph output.  After each replay the site queues ONE copy of that
stacked output (``record_compiled``), never the static tensor itself,
which the next replay overwrites.

A bundle of statistics is a float64 tensor of 5 values, ``(l2, maxabs,
mean, nan, inf)`` (``FIELDS``); l2, maxabs and mean are computed in
float32 as the reference's are, the counts are exact.  The pending queue
holds ``(names, stats, stacked)`` entries, ``stats`` a (len(names), 5)
tensor (or an (L, 5) one for a stacked entry).

Three layers:

1. *Taps* (``tap``/``tap_stacked``/``stats_of``), called from model and
   trainer code.
2. *Harvest* (``step_summary``), called from ``telemetry.step_end``: at
   the stride, ``_materialize`` (the tier's one host sync: one
   ``torch.cat`` of every pending bundle, then one ``.cpu()``), then
   ``first_nan`` provenance (path and layer) and ``grad_norm``.
3. *Forensics* (``capture_step``/``load_capture``/``bisect``): snapshot a
   flagged step's inputs, parameters (through the asynchronous
   checkpointer) and the package's random generator states, then replay
   it eagerly with a per-op NaN hook in ``ops.registry.apply_op`` that
   names the first op whose clean inputs gave nan/inf outputs.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager

__all__ = [
    "enable", "disable", "is_enabled", "clear", "signature",
    "stats_of", "tap", "tap_stacked", "collecting",
    "record_compiled", "record_stacked", "step_summary", "consume",
    "arm_capture", "capture_step", "load_capture", "bisect",
    "layer_of", "harvesting", "fold", "DEFAULT_STRIDE", "FIELDS",
]

DEFAULT_STRIDE = 16
#: pending-entry cap: bounds the queue if step_summary is never drained
PENDING_CAP = 4096
#: the five values of a statistics bundle, in order
FIELDS = ("l2", "maxabs", "mean", "nan", "inf")

_enabled = False
_stride = DEFAULT_STRIDE
_step_seq = 0          # fallback step counter when records carry none
_pending = []          # [(names, stats, stacked)]: on the device until stride
_lock = threading.Lock()
_tls = threading.local()

_capture_dir = None
_capture_armed = False


# --- enable / disable --------------------------------------------------------

def enable(stride=None, capture_dir=None):
    """Turn the tier on.  ``stride``: materialize every N steps (env
    ``MXNET_NUMERICS_STRIDE``, default 16).  ``capture_dir``: arm the
    divergence capture (``arm_capture``).  Graphs captured while the tier
    was off stay off: their keys hold ``signature()``, so the next call
    of such a signature captures again with the taps inside."""
    global _enabled, _stride
    if stride is None:
        stride = int(os.environ.get("MXNET_NUMERICS_STRIDE", DEFAULT_STRIDE))
    _stride = max(1, int(stride))
    if capture_dir:
        arm_capture(capture_dir)
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def is_enabled():
    return _enabled


def clear():
    """Reset all state (tests).  Leaves the tier disabled."""
    global _enabled, _stride, _step_seq, _capture_dir, _capture_armed
    _enabled = False
    _stride = DEFAULT_STRIDE
    _step_seq = 0
    _capture_dir = None
    _capture_armed = False
    with _lock:
        del _pending[:]
    _tls.stack = []


def signature():
    """The graph-key token: every graph cache keys on it, so stats-on and
    stats-off each keep exactly one graph a signature."""
    return _enabled


#: alias spelling out the build-time snapshot semantics
trace_enabled = is_enabled


def harvesting():
    """Whether the statistics queued now will be materialized: the tier
    is on and the open telemetry step (or, without telemetry, the tier's
    own step counter) falls on the stride.  The Trainer keeps its copy
    of the old weights (for ``update.`` statistics) only then."""
    if not _enabled:
        return False
    tel = sys.modules.get("mxnet_tpu_torch.telemetry")
    step = tel.upcoming_step() if tel is not None else None
    if step is None:
        step = _step_seq
    return int(step) % _stride == 0


# --- stats -------------------------------------------------------------------

def stats_of(raw):
    """The statistics bundle of one tensor (an NDArray or a
    ``torch.Tensor``): a float64 tensor ``(l2, maxabs, mean, nan, inf)``
    on the tensor's device.  l2, maxabs and mean are taken in float32;
    integer and bool tensors hold no nan/inf.  Torch ops only: no host
    transfer, legal inside a CUDA graph capture."""
    import torch

    x = getattr(raw, "_data", raw)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    x = x.detach()
    from ..parallel.local import is_dtensor

    if is_dtensor(x):
        x = x.full_tensor()
    f32 = torch.float32
    if x.is_complex():
        xf = x.abs().to(f32)
        nan = torch.isnan(x).sum()
        inf = torch.isinf(x).sum()
    elif x.is_floating_point():
        # reduced to float32 inside the reductions (no f32 copy of a
        # bf16 tensor); a float64 tensor is cast first, as the reference's
        xf = x.to(f32) if x.element_size() > 4 else x
        nan = torch.isnan(x).sum()
        inf = torch.isinf(x).sum()
    else:
        xf = x.to(f32)
        nan = inf = torch.zeros((), dtype=torch.int64, device=x.device)
    if x.numel():
        l2 = torch.linalg.vector_norm(xf, dtype=f32)
        maxabs = xf.abs().amax().to(f32)
        mean = torch.mean(xf, dtype=f32)
    else:
        l2 = maxabs = mean = torch.zeros((), dtype=f32, device=x.device)
    return torch.stack([v.to(torch.float64)
                        for v in (l2, maxabs, mean, nan, inf)])


def fold(acc, cur):
    """Fold one step's bundles ``cur`` (n, 5) into ``acc`` (n, 5) in place,
    as the reference's ``_reduce_k`` reduces a K-step program's: l2 and
    mean take the latest step, maxabs the worst, nan and inf sum.  Torch
    ops only (``FusedTrainStep`` runs it inside its graph)."""
    acc[:, 0] = cur[:, 0]
    acc[:, 1] = acc[:, 1].maximum(cur[:, 1])
    acc[:, 2] = cur[:, 2]
    acc[:, 3:] += cur[:, 3:]
    return acc


def layer_of(path):
    """First integer component of a dotted stat path, or -1.
    ``decoder.7.ffn`` → 7; ``grad.decoder.3.attn.wq`` → 3."""
    for part in str(path).split("."):
        if part.isdigit():
            return int(part)
    return -1


# --- collector (capture scope) ----------------------------------------------

class _Collector:
    """The taps fired while a graph is captured (or one eager step of a
    graph's call runs): ``names`` is host metadata, ``stats`` the bundles
    that leave the graph as one stacked output."""

    __slots__ = ("names", "stats")

    def __init__(self):
        self.names = []
        self.stats = []

    def drain(self):
        """``(names, stats)``: the names as a tuple and the bundles
        stacked (n, 5) (a list when stacked bundles are among them), or
        None when nothing was tapped."""
        import torch

        names, stats = tuple(self.names), self.stats
        self.names, self.stats = [], []
        if not stats:
            return names, None
        if any(n.startswith("+") for n in names):
            return names, stats
        return names, torch.stack(stats)


@contextmanager
def collecting():
    """Scope a captured region so taps inside it land on a collector
    instead of the queue.  Re-entrant; the innermost scope wins."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    col = _Collector()
    stack.append(col)
    try:
        yield col
    finally:
        stack.pop()


#: the scope of ``muted()``: taps inside it record nothing
_MUTED = object()


@contextmanager
def muted():
    """Scope a region whose taps record nothing (a rematerialized
    forward's recompute: its taps fired in the forward).  Re-entrant."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(_MUTED)
    try:
        yield
    finally:
        stack.pop()


def _active_collector():
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def _capturing():
    """True while this thread's current stream captures a CUDA graph."""
    import torch

    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _push(entry):
    with _lock:
        if len(_pending) < PENDING_CAP:
            _pending.append(entry)


# --- taps --------------------------------------------------------------------

def tap(name, x, keep=False):
    """Record the statistics of one tensor (an NDArray or a tensor).  The
    disabled path is one boolean test.  Inside ``collecting()`` the
    bundle joins the scope (a graph output, computed on every replay).
    Eagerly it is queued on a step whose statistics will be harvested
    (``harvesting()``) and computes nothing off the stride, where it
    would be dropped; ``keep=True`` queues it whatever the stride (a
    caller that drains its own taps with ``consume``: ``Monitor``).  A
    tap inside a capture with no scope is dropped: its values would
    exist only in the graph's replays."""
    if not _enabled:
        return
    raw = getattr(x, "_data", x)
    if raw is None:
        return
    col = _active_collector()
    if col is _MUTED:
        return
    try:
        if col is not None:
            col.stats.append(stats_of(raw))
            col.names.append(str(name))
        elif (keep or harvesting()) and not _capturing():
            _push(((str(name),), stats_of(raw).reshape(1, 5), False))
    except Exception:  # noqa: BLE001 - never raises into training
        pass


def tap_stacked(name, stats):
    """Record a stacked bundle: an (L, 5) tensor, or a dict of the
    ``FIELDS`` each of shape (L,), with a leading layer axis; the
    harvest fans it out to ``name.<i>``."""
    if not _enabled:
        return
    try:
        col = _active_collector()
        if col is _MUTED:
            return
        stats = _as_rows(stats)
        if col is not None:
            col.names.append("+" + str(name))  # '+' marks stacked
            col.stats.append(stats)
        elif not _capturing():
            _push(((str(name),), stats, True))
    except Exception:  # noqa: BLE001 - never raises into training
        pass


def _as_rows(stats):
    import torch

    if isinstance(stats, dict):
        return torch.stack([torch.as_tensor(stats[k]).to(torch.float64)
                            for k in FIELDS], dim=-1)
    return stats


def record_compiled(names, stats):
    """Queue the bundles that left a captured graph: ``names`` from the
    capture's collector, ``stats`` a COPY of its output (an (n, 5) tensor,
    or a sequence of bundles when stacked ones are among them).  With an
    outer collector active (a graph's call inside a bigger capture) the
    bundles go to it instead."""
    if not _enabled or not names:
        return
    import torch

    col = _active_collector()
    if col is _MUTED:
        return
    if col is not None:
        for i, n in enumerate(names):
            col.names.append(n)
            col.stats.append(stats[i])
        return
    if _capturing():
        return
    if not any(n.startswith("+") for n in names):
        if not isinstance(stats, torch.Tensor):
            stats = torch.stack([_as_rows(s).reshape(5) for s in stats])
        _push((tuple(names), stats, False))
        return
    for i, n in enumerate(names):
        if n.startswith("+"):
            _push(((n[1:],), _as_rows(stats[i]), True))
        else:
            _push(((n,), _as_rows(stats[i]).reshape(1, 5), False))


def record_stacked(name, stats):
    """Queue one stacked entry directly."""
    if not _enabled:
        return
    _push(((str(name),), _as_rows(stats), True))


# --- harvest -----------------------------------------------------------------

def _materialize(entries):
    """The ONE host sync of the tier: every pending bundle of a device in
    one ``torch.cat`` and one copy to the host.  Returns one numpy array
    per entry, shaped as its bundles."""
    import numpy as np
    import torch

    out = [None] * len(entries)
    by_device = {}
    for i, (_, st, _) in enumerate(entries):
        if isinstance(st, np.ndarray):
            out[i] = st
        else:
            by_device.setdefault(st.device, []).append(i)
    for idx in by_device.values():
        flat = torch.cat([entries[i][1].reshape(-1) for i in idx]).cpu() \
            .numpy()
        at = 0
        for i in idx:
            st = entries[i][1]
            n = st.numel()
            out[i] = flat[at:at + n].reshape(tuple(st.shape))
            at += n
    return out


def _bundle(row):
    return {k: (int(v) if k in ("nan", "inf") else float(v))
            for k, v in zip(FIELDS, row)}


def _expand(entries, fetched):
    """Entries × host values → ordered {path: stats}, stacked entries
    fanned out to ``path.<i>``."""
    tensors = {}
    for (names, _, stacked), host in zip(entries, fetched):
        if stacked:
            for i, row in enumerate(host):
                tensors[f"{names[0]}.{i}"] = _bundle(row)
        else:
            for name, row in zip(names, host):
                tensors[name] = _bundle(row)
    return tensors


def step_summary(step=None):
    """Materialize the pending statistics if ``step`` falls on the stride
    (called from ``telemetry.step_end``, usable alone).  Returns the dict
    that step records carry as ``record["numerics"]``, or None off the
    stride, where the pending bundles are dropped without a sync."""
    global _step_seq
    if not _enabled:
        return None
    if step is None:
        step = _step_seq
    _step_seq = int(step) + 1
    with _lock:
        entries = list(_pending)
        del _pending[:]
    if int(step) % _stride != 0 or not entries:
        return None
    try:
        fetched = _materialize(entries)
    except Exception:  # noqa: BLE001 - never raises into training
        return None
    tensors = _expand(entries, fetched)
    first_nan = None
    for path, st in tensors.items():  # insertion order == forward order
        if st["nan"] or st["inf"]:
            first_nan = {"path": path, "layer": layer_of(path),
                         "nan": st["nan"], "inf": st["inf"]}
            break
    grad_sq = [st["l2"] ** 2 for p, st in tensors.items()
               if p.startswith("grad.")]
    summary = {
        "stride": _stride,
        "tensors": tensors,
        "first_nan": first_nan,
        "grad_norm": (sum(grad_sq) ** 0.5) if grad_sq else None,
    }
    _mirror_profiler(tensors)
    return summary


def _mirror_profiler(tensors):
    """Mirror each path's stats into a chrome-trace counter track while
    the profiler runs (module probed, never imported)."""
    prof = sys.modules.get("mxnet_tpu_torch.profiler")
    if prof is None or not prof.is_running():
        return
    try:
        for path, st in tensors.items():
            prof.record_counter_event(
                "numerics/" + path,
                {"l2": st["l2"], "overflow": st["nan"] + st["inf"]})
    except Exception:  # noqa: BLE001 - best-effort mirror
        pass


def consume(prefix):
    """Pop the pending bundles whose path starts with ``prefix`` and
    return them materialized as ``{path: stats}`` (one host transfer).
    ``Monitor.toc`` drains its own taps this way.  Rows of the same
    entries under other paths stay queued (as host values)."""
    with _lock:
        mine = [e for e in _pending
                if any(n.startswith(prefix) for n in e[0])]
        _pending[:] = [e for e in _pending
                       if not any(n.startswith(prefix) for n in e[0])]
    if not mine:
        return {}
    try:
        fetched = _materialize(mine)
    except Exception:  # noqa: BLE001 - never raises into training
        return {}
    out = {}
    for (names, st, stacked), host in zip(mine, fetched):
        keep = [i for i, n in enumerate(names) if not n.startswith(prefix)]
        if keep and not stacked:
            _push((tuple(names[i] for i in keep), host[keep], False))
        out.update(_expand([((n,), None, stacked) for i, n
                            in enumerate(names) if n.startswith(prefix)],
                           [host if stacked else host[i:i + 1]
                            for i, n in enumerate(names)
                            if n.startswith(prefix)]))
    return out


# --- divergence capture / replay --------------------------------------------

def arm_capture(out_dir):
    """Arm the capture: the next ``capture_step`` without ``out_dir``
    writes under ``out_dir``.  One-shot."""
    global _capture_dir, _capture_armed
    _capture_dir = str(out_dir)
    _capture_armed = True


def capture_armed():
    return _capture_armed


def capture_step(net, inputs, rng_key=None, step=0, out_dir=None,
                 reason="flagged", builder=None, builder_kwargs=None):
    """Snapshot a flagged step for eager replay: the inputs as ``.npz``,
    the parameters through the asynchronous checkpointer (training goes
    on while the copy drains), the package's random generator states
    (``random.get_state``; the reference saves its JAX key, and
    ``rng_key`` is accepted and ignored here) and a ``capture.json``
    naming the ``builder`` (``"module:function"``) that rebuilds the net.
    Returns the capture directory, or None when nothing is armed and no
    ``out_dir`` was given.  Never raises into training."""
    global _capture_armed
    out_dir = out_dir or (_capture_dir if _capture_armed else None)
    if out_dir is None:
        return None
    try:
        import pickle

        import numpy as np

        from .. import checkpoint as _ckpt
        from .. import random as _random

        step = int(step)
        cdir = os.path.join(str(out_dir), f"capture-{step}")
        os.makedirs(cdir, exist_ok=True)
        arrs = {f"input{i}": (a.asnumpy() if hasattr(a, "asnumpy")
                              else np.asarray(a))
                for i, a in enumerate(inputs)}
        np.savez(os.path.join(cdir, "inputs.npz"), **arrs)
        with open(os.path.join(cdir, "rng_state.pkl"), "wb") as f:
            pickle.dump(_random.get_state(), f)
        meta = {
            "record": "numerics_capture",
            "step": step,
            "reason": str(reason),
            "builder": builder,
            "builder_kwargs": builder_kwargs or {},
            "inputs": sorted(arrs, key=lambda k: int(k[5:])),
            "rng_key": None,
            "rng_state": "rng_state.pkl",
            "time": time.time(),
        }
        _ckpt.save_checkpoint_async(
            cdir, step, net,
            extra={"numerics_capture": {"reason": str(reason)}})
        with open(os.path.join(cdir, "capture.json"), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
        _capture_armed = False
        return cdir
    except Exception:  # noqa: BLE001 - never raises into training
        return None


def load_capture(cdir):
    """``(meta, inputs)`` of a capture directory, the inputs as numpy
    arrays in their original order.  ``meta["rng_state"]`` names the
    pickled ``random.get_state()`` (restore it with
    ``random.set_state``)."""
    import numpy as np

    with open(os.path.join(cdir, "capture.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(cdir, "inputs.npz")) as z:
        inputs = [np.asarray(z[k]) for k in meta["inputs"]]
    return meta, inputs


class BisectResult:
    """Outcome of a ``bisect`` replay: ``ops`` is the per-op journal in
    dispatch order; ``first`` names the first op whose inputs were clean
    and whose outputs went nan/inf."""

    def __init__(self):
        self.ops = []
        self.first = None


@contextmanager
def bisect():
    """Install a per-op NaN hook on ``ops.registry.apply_op`` for an
    eager replay: every dispatch is journaled with inputs-clean and
    outputs-clean verdicts, and the first clean → poisoned op is
    ``result.first``.  Forensics only: each check reads the card."""
    import torch

    from ..ops import registry as _registry

    res = BisectResult()

    def _bad(a):
        if not isinstance(a, torch.Tensor) or \
                not (a.is_floating_point() or a.is_complex()):
            return False
        return bool(torch.isnan(a).any() or torch.isinf(a).any())

    def hook(name, raws, outs):
        try:
            in_bad = any(_bad(r) for r in raws)
            out_bad = any(_bad(o) for o in outs)
            res.ops.append({"op": name or "<anonymous>",
                            "inputs_bad": in_bad, "outputs_bad": out_bad})
            if res.first is None and out_bad and not in_bad:
                res.first = {"op": name or "<anonymous>",
                             "index": len(res.ops) - 1}
        except Exception:  # noqa: BLE001 - forensics never raise
            pass

    prev = _registry._bisect_hook
    _registry._bisect_hook = hook
    try:
        yield res
    finally:
        _registry._bisect_hook = prev


if os.environ.get("MXNET_NUMERICS", "0") == "1":
    enable()

"""Runtime recapture sanitizer: post-warmup retrace detection with
structural signature diffing.

Counterpart of ``mxnet_tpu/telemetry/retrace.py``.  Every compile site
of the port (``CachedOp``'s graphs and its recorded backward,
``FusedTrainStep``, the Trainer's fused update, ``Predictor``) calls
``observe`` from its cache-MISS branch only (replays never reach it),
passing a dict of named signature components.  After a declared warmup
(``warm``, or N steps via ``warmup_steps``), a second or later
signature at the same site is a **retrace**: it is attributed to its
Python call site, diffed against the nearest prior signature at that
site (naming the exact shape, dtype, attribute, mode or address
component that diverged) and then warns or raises ``RetraceError`` by
mode.  A first signature at a site is a new program, not a retrace.

The port has one cause of a miss the reference has not: a CUDA graph
bakes in the addresses of the weights, so ``CachedOp`` and
``FusedTrainStep`` capture again when a parameter's storage moves
(``cast``, a forced re-initialization, ``load_parameters`` into new
tensors).  Their components name that as ``param_addresses``.

Null path: one module-global boolean (``_enabled``) read at each site's
miss branch.  ``MXNET_SANITIZE_RETRACE=1|warn`` observes and warns,
``=raise`` raises; ``MXNET_SANITIZE_RETRACE_WARMUP=N`` declares an N-step
warmup counted at ``telemetry.step_end``.  Every new compile lands as a
``{"record": "retrace", ...}`` line on the telemetry JSONL sink when one
is attached (the reference's ``tools/retrace_report.py`` reads them).
"""
from __future__ import annotations

import os
import sys
import threading
import traceback
import warnings

__all__ = ["RetraceError", "enable", "disable", "reset", "warm",
           "is_warm", "is_enabled", "on_step", "observe", "violations",
           "sites", "diff_components", "cachedop_components"]

#: per-site signature histories are bounded — a runaway retrace loop
#: must not turn the sanitizer into a leak
_MAX_HISTORY = 64
_MAX_VIOLATIONS = 256


class RetraceError(RuntimeError):
    """A registered compile site re-traced after warmup.  The message
    names the site, the Python call site that triggered the compile and
    the exact signature components that diverged from the nearest prior
    signature."""


def _env_mode():
    v = os.environ.get("MXNET_SANITIZE_RETRACE", "").strip().lower()
    if v in ("", "0", "off", "false", "no"):
        return None
    return "raise" if v == "raise" else "warn"


def _env_warmup():
    v = os.environ.get("MXNET_SANITIZE_RETRACE_WARMUP", "").strip()
    try:
        return int(v) if v else None
    except ValueError:
        return None


_lock = threading.Lock()
_mode = _env_mode()
_enabled = _mode is not None
_warmup_steps = _env_warmup()
_warmed = False
_steps_seen = 0
_sites = {}        # (kind, instance) -> {"site": str, "history": [entry]}
_violations = []


# -- lifecycle ---------------------------------------------------------------

def enable(mode="warn", warmup_steps=None):
    """Switch the sanitizer on.  ``mode`` is ``"warn"`` (RuntimeWarning
    per post-warmup retrace) or ``"raise"`` (RetraceError).
    ``warmup_steps`` declares an N-step warmup counted at telemetry
    step boundaries; None keeps warmup explicit via :func:`warm`."""
    global _enabled, _mode, _warmup_steps
    if mode not in ("warn", "raise"):
        raise ValueError(f"mode must be 'warn' or 'raise', got {mode!r}")
    with _lock:
        _mode = mode
        _warmup_steps = warmup_steps
        _enabled = True


def disable():
    global _enabled
    _enabled = False


def is_enabled():
    return _enabled


def reset():
    """Forget every observed signature, violation and warmup state (the
    enabled/mode flags survive — tests flip those via enable/disable)."""
    global _warmed, _steps_seen
    with _lock:
        _sites.clear()
        _violations.clear()
        _warmed = False
        _steps_seen = 0


def warm():
    """Declare warmup over: from here on, a second-or-later signature
    at any registered site is a retrace violation."""
    global _warmed
    _warmed = True


def is_warm():
    return _warmed


def on_step():
    """Telemetry step-boundary hook (called from ``step_end`` while the
    sanitizer is enabled): counts steps toward a declared
    ``warmup_steps`` warmup."""
    global _steps_seen, _warmed
    with _lock:
        _steps_seen += 1
        if _warmup_steps is not None and not _warmed and \
                _steps_seen >= _warmup_steps:
            _warmed = True


def violations():
    """Post-warmup retrace records observed so far (list of dicts with
    ``site``/``where``/``diff``/``step`` keys) — the test hook."""
    with _lock:
        return list(_violations)


def sites():
    """Snapshot: {(kind, instance): signature count} for every
    registered site that has compiled at least once."""
    with _lock:
        return {k: len(v["history"]) for k, v in _sites.items()}


# -- signature plumbing ------------------------------------------------------

def _canon(value):
    """Hashable, comparison-stable form: lists become tuples (JSONL
    round-trips arrive as lists), dicts become sorted item tuples."""
    if isinstance(value, (list, tuple)):
        return tuple(_canon(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((str(k), _canon(v)) for k, v in value.items()))
    return value


def _jsonable(value):
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return repr(value)


def _is_aval(x):
    """(shape-tuple, dtype-str[, weak-bool]) — the aval spelling every
    compile signature in this tree uses."""
    return (isinstance(x, tuple) and len(x) in (2, 3) and
            isinstance(x[0], tuple) and isinstance(x[1], str) and
            (len(x) == 2 or isinstance(x[2], bool)))


_AVAL_FIELDS = ("shape", "dtype", "weak_type")


def diff_components(old, new):
    """Structural diff of two component dicts: a list of human strings,
    one per diverging leaf, naming the exact path — e.g.
    ``args[1].shape: (8, 16) -> (8, 32)`` or
    ``rescale_grad: 1.0 -> 0.5``."""
    return _diff_dicts(old, new)


def _diff_value(path, a, b, out):
    if a == b:
        return
    if isinstance(a, tuple) and isinstance(b, tuple):
        if _is_aval(a) and _is_aval(b):
            for name, x, y in zip(_AVAL_FIELDS, a, b):
                if x != y:
                    out.append(f"{path}.{name}: {x!r} -> {y!r}"
                               if path else f"{name}: {x!r} -> {y!r}")
            if len(a) != len(b):
                out.append(f"{path}: {a!r} -> {b!r}")
            return
        if len(a) == len(b):
            for i, (x, y) in enumerate(zip(a, b)):
                _diff_value(f"{path}[{i}]", x, y, out)
            return
        out.append(f"{path}: length {len(a)} -> {len(b)} "
                   f"({a!r} -> {b!r})")
        return
    out.append(f"{path}: {a!r} -> {b!r}" if path else f"{a!r} -> {b!r}")


def _diff_dicts(old, new):
    out = []
    for key in sorted(set(old) | set(new)):
        if key not in old:
            out.append(f"{key}: <absent> -> {_canon(new[key])!r}")
        elif key not in new:
            out.append(f"{key}: {_canon(old[key])!r} -> <absent>")
        else:
            _diff_value(key, _canon(old[key]), _canon(new[key]), out)
    return out


def cachedop_components(sig):
    """Decompose a CachedOp compile key into named components for the
    differ: the reference's layout ``(arg avals, training, platform,
    param avals, mesh, numerics)``, and the port's, which adds amp's
    dtype and, on a card, the parameters' addresses."""
    names = ("args", "training", "platform", "params", "mesh", "numerics",
             "amp", "param_addresses")
    if isinstance(sig, tuple) and 6 <= len(sig) <= len(names):
        return dict(zip(names, sig))
    return {"signature": sig}


def _caller():
    """First stack frame outside the package: the Python call site this
    compile is attributed to.  Falls back to the innermost
    non-telemetry frame (worker threads dispatch from inside the
    runtime)."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fallback = None
    for fr in reversed(traceback.extract_stack()):
        fn = os.path.abspath(fr.filename)
        if fn.startswith(os.path.dirname(os.path.abspath(__file__))):
            continue  # this module / telemetry siblings
        where = "%s:%d in %s" % (
            os.path.relpath(fn, os.getcwd()) if fn.startswith(os.getcwd())
            else os.path.basename(fn), fr.lineno, fr.name)
        if fallback is None:
            fallback = where
        if not fn.startswith(pkg_root):
            return where
    return fallback or "<unknown>"


# -- the observe hook --------------------------------------------------------

def observe(kind, instance, components, site=None):
    """Record one compile at a registered site.  Call ONLY from the
    site's cache-miss branch, behind ``if _retrace._enabled:``.

    ``kind`` is the costs-registry kind string ("cachedop",
    "step_fusion", "trainer_fused", ...), ``instance`` discriminates
    live objects sharing the kind (``id(self)``), ``components`` is a
    dict of named, hashable signature parts and ``site`` the
    module-qualified compile-site identity
    ("mxnet_tpu_torch.gluon.trainer:Trainer._try_fused_update").

    Baseline compiles (pre-warmup, or the first signature a site ever
    sees) are recorded silently; a post-warmup second-or-later
    signature is a violation: warn or raise per mode."""
    if not _enabled:
        return None
    comps = {str(k): _canon(v) for k, v in components.items()}
    where = _caller()
    key = (kind, instance)
    with _lock:
        entry = _sites.get(key)
        if entry is None:
            entry = _sites[key] = {"site": site or kind, "history": []}
        history = entry["history"]
        for prior in history:
            if prior["components"] == comps:
                return None  # replay raced a concurrent miss: not new
        rec = {"components": comps, "where": where, "step": _steps_seen,
               "warm": _warmed}
        if len(history) >= _MAX_HISTORY:
            del history[0]
        history.append(rec)
        is_violation = _warmed and len(history) > 1
        diff = against = None
        if is_violation:
            candidates = [(len(_diff_dicts(p["components"], comps)), i, p)
                          for i, p in enumerate(history[:-1])]
            _, idx, nearest = min(candidates, key=lambda t: (t[0], -t[1]))
            diff = _diff_dicts(nearest["components"], comps)
            against = {"signature_index": idx, "where": nearest["where"],
                       "step": nearest["step"]}
            violation = {
                "site": entry["site"], "kind": kind, "instance": instance,
                "where": where, "step": _steps_seen, "diff": diff,
                "against": against,
                "signature_index": len(history) - 1,
            }
            if len(_violations) < _MAX_VIOLATIONS:
                _violations.append(violation)
        mode = _mode
        sig_index = len(history) - 1
    action = ("raise" if mode == "raise" else "warn") if is_violation \
        else "baseline"
    _emit_record(action, kind, instance, entry["site"], where, comps,
                 sig_index, diff, against)
    if not is_violation:
        return None
    msg = ("retrace at %s (signature #%d, compiled from %s): "
           "diverged from signature #%d [%s] in: %s"
           % (entry["site"], sig_index, where, against["signature_index"],
              against["where"], "; ".join(diff) or "<structurally equal>"))
    if mode == "raise":
        raise RetraceError(msg)
    warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return msg


def _emit_record(action, kind, instance, site, where, comps, sig_index,
                 diff, against):
    """One ``retrace`` JSONL record per new compile.  Never raises:
    observability is best-effort."""
    try:
        telemetry = sys.modules.get("mxnet_tpu_torch.telemetry")
        if telemetry is None:
            return
        rec = {"record": "retrace", "action": action, "site": site,
               "kind": kind, "instance": instance, "where": where,
               "step": _steps_seen, "signature_index": sig_index,
               "components": _jsonable(comps)}
        if diff is not None:
            rec["diff"] = list(diff)
            rec["against"] = dict(against)
        telemetry.emit(rec)
        if action != "baseline" and telemetry.fleet._enabled:
            # a retrace trips the training flight recorder
            telemetry.fleet.incident("retrace", context=rec)
    except Exception:  # noqa: BLE001 - observability is best-effort
        pass

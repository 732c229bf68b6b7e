"""Fleet-wide training observability.

Counterpart of ``mxnet_tpu/telemetry/fleet.py``, in four pieces:

* **rank-aware telemetry** — ``on_step_record`` (called from
  ``telemetry.step_end``) stamps every step record with
  ``rank``/``world_size`` and, at a stride (default every 16 steps;
  never a per-step sync), gathers a packed vector of 7 floats a rank
  (``step_ms``, allreduce wait, ``compute_ms``, ``peak_live_bytes``,
  examples/s, the first NaN layer, the duty cycle) through
  ``parallel.process_gather_hostvec`` into a ``{"record": "fleet"}``
  view.  At world size 1 there is no collective;
* **straggler and anomaly watchdog** — rolling per-rank baselines flag
  ranks whose compute or allreduce-wait skew exceeds a threshold for K
  consecutive windows, plus local detectors for NaN/Inf losses and
  tensors, gradient-norm spikes and growth, and step-time regressions,
  emitted as ``{"record": "anomaly"}`` events (warn by default, halt
  opt-in through :class:`WatchdogHalt`);
* **training flight recorder** — a bounded ring of step records, fleet
  views and anomalies, dumped (rate-limited, atomic, never raising) on
  a halt, an incident and at exit when ``MXNET_FLEET_DUMP`` names the
  path (a ``{rank}`` placeholder expands per rank);
* **live scrape** — :class:`MetricsEndpoint` exposes ``/metrics`` and
  ``/healthz`` for a training rank, rendered by ``telemetry.promtext``.

Disabled, the step hook is one module-global boolean check.  Knobs:
``MXNET_FLEET=1`` autostarts at import; ``MXNET_FLEET_STRIDE`` (16),
``MXNET_FLEET_RING`` (256), ``MXNET_FLEET_SKEW`` (1.5),
``MXNET_FLEET_WINDOWS`` (3), ``MXNET_FLEET_HALT`` (0).
"""
from __future__ import annotations

import atexit
import collections
import json
import math
import os
import statistics
import sys
import threading
import time

from .. import sanitizer as _sanitizer

from . import promtext
from .sinks import _json_default

__all__ = [
    "enable", "disable", "is_enabled", "world", "rank",
    "on_step_record", "detect_skew", "detect_nan", "detect_spike",
    "growth_streak",
    "Watchdog", "WatchdogHalt", "recent", "clear", "dump", "incident",
    "last_view", "halt_requested", "MetricsEndpoint", "metrics_url",
]

# -- defaults (env-overridable at enable() time) ------------------------

#: exchange the packed step-stats vector every N steps
DEFAULT_STRIDE = 16
#: flight-recorder depth (step records + fleet views + anomalies)
RING_CAPACITY = 256
#: a rank is skewed when value / fleet-median exceeds this
SKEW_THRESHOLD = 1.5
#: consecutive skewed exchange windows before the watchdog fires
CONSECUTIVE = 3
#: grad-norm spike = value / rolling-median above this
SPIKE_FACTOR = 10.0
#: step-time regression = value / rolling-median above this
REGRESSION_FACTOR = 2.0
#: local spike/regression detectors stay quiet until this much history
MIN_HISTORY = 8
#: grad-norm explosion = this much growth per observed window, sustained
#: for ``consecutive`` windows (same streak machinery as stragglers)
GROWTH_FACTOR = 2.0
#: per-reason minimum spacing between incident dumps
DUMP_INTERVAL_S = 5.0


class WatchdogHalt(RuntimeError):
    """Raised out of ``on_step_record`` (and therefore out of
    ``telemetry.step_end``, at a step boundary) when the watchdog sees
    an anomaly and halt was opted into."""


_enabled = False
_lock = _sanitizer.wrap_lock(threading.Lock(), "fleet._lock")
_ring = collections.deque(maxlen=RING_CAPACITY)
_ring_lock = _sanitizer.wrap_lock(threading.Lock(), "fleet._ring_lock")
_last_dump = {}      # reason -> monotonic time of last incident dump
_watchdog = None
_last_view = None    # most recent fleet-view record
_halted = False
_stride = DEFAULT_STRIDE
_on_anomaly = None
_halt = False
_endpoint = None
_world_cache = None
_atexit_installed = False


def _telemetry():
    # resolved lazily; the parent package imports this module
    return sys.modules.get("mxnet_tpu_torch.telemetry")


def _parallel():
    # never trigger the parallel import from here
    return sys.modules.get("mxnet_tpu_torch.parallel")


def world():
    """``(rank, world_size)`` via ``elastic.world_info()``, cached once
    the answer is authoritative (a live process group or the launcher's
    environment; the package always imports ``parallel``, so its import
    says nothing here)."""
    global _world_cache
    cached = _world_cache
    if cached is not None:
        return cached
    from .. import elastic
    r, n = elastic.world_info()
    pl = _parallel()
    if n > 1 or os.environ.get("MXT_NUM_PROCESSES") or \
            (pl is not None and pl.is_initialized()):
        with _lock:
            _world_cache = (r, n)
    return r, n


def rank():
    return world()[0]


# -- pure detector functions (unit-tested directly) ---------------------

def detect_skew(values, threshold=SKEW_THRESHOLD):
    """Indices whose value exceeds ``threshold`` x the median of
    ``values``. Pure; returns ``[]`` for degenerate input. ``None``
    entries (gaps in strided records) are skipped, never flagged."""
    pairs = [(i, float(v)) for i, v in enumerate(values) if v is not None]
    if len(pairs) < 2:
        return []
    med = statistics.median(v for _, v in pairs)
    if med <= 0.0:
        return []
    return [i for i, v in pairs if v / med > threshold]


def detect_nan(value):
    """True when ``value`` is NaN or +/-Inf (or not a number at all)."""
    try:
        f = float(value)
    except (TypeError, ValueError):
        return True
    return math.isnan(f) or math.isinf(f)


def detect_spike(value, history, factor=SPIKE_FACTOR,
                 min_history=MIN_HISTORY):
    """True when ``value`` exceeds ``factor`` x the median of
    ``history``; quiet until ``min_history`` samples exist. ``None``
    gaps (strided records miss metrics off-stride) are tolerated in
    both the history and the value."""
    if value is None:
        return False
    hist = [float(v) for v in history if v is not None]
    if len(hist) < min_history:
        return False
    med = statistics.median(hist)
    if med <= 0.0:
        return False
    return float(value) / med > factor


def growth_streak(history, factor=GROWTH_FACTOR):
    """Length of the trailing run of consecutive windows in ``history``
    where each value grew by more than ``factor`` x over its
    predecessor. Pure; ``None`` gaps break the streak; non-positive
    predecessors never count as growth."""
    vals = list(history)
    streak = 0
    for prev, cur in zip(reversed(vals[:-1]), reversed(vals[1:])):
        if prev is None or cur is None:
            break
        prev, cur = float(prev), float(cur)
        if prev <= 0.0 or cur <= factor * prev:
            break
        streak += 1
    return streak


class Watchdog:
    """Rolling-baseline anomaly detection.

    ``observe_step`` runs the local detectors over one step record;
    ``observe_fleet`` runs the cross-rank skew detectors over one fleet
    view, tracking per-``(metric, rank)`` consecutive-window streaks.
    Both return lists of anomaly dicts (``kind`` + detail fields); the
    caller stamps rank/step/wall-time and emits.
    """

    #: (fleet-view column, anomaly kind) pairs the streak tracker watches
    FLEET_METRICS = (("compute_ms", "straggler"),
                     ("allreduce_wait_ms", "allreduce_wait_skew"))

    def __init__(self, skew_threshold=SKEW_THRESHOLD, consecutive=CONSECUTIVE,
                 spike_factor=SPIKE_FACTOR, regression_factor=REGRESSION_FACTOR,
                 min_history=MIN_HISTORY, growth_factor=GROWTH_FACTOR):
        self.skew_threshold = float(skew_threshold)
        self.consecutive = int(consecutive)
        self.spike_factor = float(spike_factor)
        self.regression_factor = float(regression_factor)
        self.min_history = int(min_history)
        self.growth_factor = float(growth_factor)
        self._grad_hist = collections.deque(maxlen=64)
        self._step_hist = collections.deque(maxlen=64)
        self._streaks = {}   # (metric, rank) -> consecutive skewed windows

    def observe_step(self, record):
        out = []
        loss = record.get("loss")
        if loss is not None and detect_nan(loss):
            out.append({"kind": "nan_loss", "value": repr(loss)})
        num = record.get("numerics") or {}
        first_nan = num.get("first_nan")
        if first_nan:
            # layer-resolved provenance from the in-compile stats tier:
            # the anomaly names (layer, param path); _emit_anomaly
            # stamps the rank, completing "rank R, path, step S"
            out.append({"kind": "nan_tensor",
                        "path": first_nan.get("path"),
                        "layer": first_nan.get("layer"),
                        "nan": first_nan.get("nan"),
                        "inf": first_nan.get("inf")})
        gn = record.get("grad_norm")
        if gn is None:
            # the numerics tier aggregates grad.* l2 at its stride —
            # feeds the spike/explosion detectors with no extra wiring
            gn = num.get("grad_norm")
        if gn is not None:
            if detect_nan(gn):
                out.append({"kind": "nan_grad", "value": repr(gn)})
            else:
                gn = float(gn)
                if detect_spike(gn, self._grad_hist, self.spike_factor,
                                self.min_history):
                    out.append({"kind": "grad_spike", "value": gn,
                                "median": statistics.median(self._grad_hist),
                                "factor": self.spike_factor})
                self._grad_hist.append(gn)
                streak = growth_streak(self._grad_hist,
                                       self.growth_factor)
                if streak >= self.consecutive:
                    out.append({"kind": "grad_norm_explosion",
                                "value": gn, "windows": streak,
                                "factor": self.growth_factor})
        sm = record.get("step_ms")
        if sm is not None and not detect_nan(sm):
            sm = float(sm)
            if detect_spike(sm, self._step_hist, self.regression_factor,
                            self.min_history):
                out.append({"kind": "step_regression", "value": sm,
                            "median": statistics.median(self._step_hist),
                            "factor": self.regression_factor})
            self._step_hist.append(sm)
        return out

    def observe_fleet(self, step, view):
        out = []
        for metric, kind in self.FLEET_METRICS:
            values = view.get(metric)
            if not values or len(values) < 2:
                continue
            flagged = set(detect_skew(values, self.skew_threshold))
            med = statistics.median(float(v) for v in values)
            for r in range(len(values)):
                key = (metric, r)
                if r in flagged:
                    streak = self._streaks.get(key, 0) + 1
                    self._streaks[key] = streak
                    if streak >= self.consecutive:
                        out.append({
                            "kind": kind, "culprit": r, "metric": metric,
                            "value": float(values[r]),
                            "ratio": float(values[r]) / med if med else 0.0,
                            "windows": streak,
                        })
                else:
                    self._streaks.pop(key, None)
        return out


# -- flight recorder ----------------------------------------------------

def recent(n=None):
    """The last ``n`` (default: all) ring entries, oldest first."""
    with _ring_lock:
        items = list(_ring)
    if n is not None:
        items = items[-int(n):]
    return items


def clear():
    """Drop ring contents and per-run detector/dump state."""
    global _last_view, _halted, _world_cache
    with _ring_lock:
        _ring.clear()
    with _lock:
        _last_dump.clear()
        _last_view = None
        _halted = False
        _world_cache = None


def _dump_path():
    tmpl = os.environ.get("MXNET_FLEET_DUMP")
    if tmpl:
        return tmpl.replace("{rank}", str(world()[0]))
    return "fleet_record_%d.json" % os.getpid()


def dump(path=None, reason="manual", context=None):
    """Write the flight-recorder ring as a single JSON document.

    Atomic (tmp + rename) so a kill mid-write never clobbers the
    previous good dump. Returns the path written."""
    r, n = world()
    if path is None:
        path = _dump_path()
    doc = {
        "record": "flight_recorder",
        "kind": "fleet",
        "reason": reason,
        "wall_time": time.time(),
        "rank": r,
        "world_size": n,
        "context": context or {},
        "records": recent(),
    }
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(doc, f, default=_json_default)
        f.write("\n")
    os.replace(tmp, path)
    return path


def incident(reason, context=None, path=None):
    """Rate-limited :func:`dump`; never raises. Returns the path
    written, or ``None`` when disabled, throttled, or failed."""
    if not _enabled:
        return None
    try:
        now = time.monotonic()
        with _lock:
            last = _last_dump.get(reason)
            if last is not None and now - last < DUMP_INTERVAL_S:
                return None
            _last_dump[reason] = now
        return dump(path, reason, context)
    except Exception:
        return None   # the flight recorder never raises into training


def _atexit_dump():
    # SIGTERM-drain / normal-exit dump; SIGKILL relies on the periodic
    # stride dumps instead. Gated on the env var so plain local runs
    # never litter the cwd.
    if _enabled and os.environ.get("MXNET_FLEET_DUMP"):
        try:
            dump(reason="exit")
        except Exception:
            pass


# -- the step hook ------------------------------------------------------

def on_step_record(record):
    """Called from ``telemetry.step_end`` for every step record.

    Disabled cost is this one boolean check. Mutates ``record`` in
    place (adds ``rank``/``world_size``) before the sinks see it."""
    if not _enabled:
        return
    try:
        _observe(record)
    except WatchdogHalt:
        raise
    except Exception:
        pass   # fleet telemetry never raises into training


def _observe(record):
    global _last_view
    tel = _telemetry()
    r, n = world()
    record["rank"] = r
    record["world_size"] = n
    with _ring_lock:
        _ring.append(dict(record))
    wd = _watchdog
    anomalies = list(wd.observe_step(record)) if wd is not None else []
    step = record.get("step")
    if step is not None and _stride > 0 and step % _stride == 0:
        view = _fleet_exchange(record)
        with _lock:
            _last_view = view
        with _ring_lock:
            _ring.append(view)
        if tel is not None:
            tel.count("fleet.exchange")
            tel.gauge("fleet.exchange_ms", view["exchange_ms"])
            tel.emit(view)
        if wd is not None:
            anomalies.extend(wd.observe_fleet(step, view))
        if os.environ.get("MXNET_FLEET_DUMP"):
            incident("stride", context={"step": step})
    for a in anomalies:
        _emit_anomaly(a, record)


def _fleet_exchange(record):
    """Allgather the packed per-rank stats vector and build the
    ``{"record": "fleet"}`` view. Stride-gated from ``_observe`` —
    never a per-step sync; single-process runs build a one-row view
    with no collective at all."""
    r, n = world()
    counters = record.get("counters") or {}
    phases = record.get("phases_ms") or {}
    step_ms = float(record.get("step_ms") or 0.0)
    wait_ms = float(counters.get("trainer.allreduce_wait_ms")
                    or phases.get("trainer.allreduce") or 0.0)
    # with a per-step allreduce barrier every rank's step_ms equalizes;
    # the straggler is the rank with high COMPUTE and low wait, so the
    # exchange carries compute_ms explicitly
    compute_ms = max(step_ms - wait_ms, 0.0)
    # nan provenance rides the exchange as a layer index (-1 = clean):
    # every rank learns WHO diverged and WHERE from one allgather
    first_nan = (record.get("numerics") or {}).get("first_nan") or {}
    nan_layer = float(first_nan.get("layer", -1) if first_nan else -1)
    # duty cycle (compute_ms / step_ms) rides as a 7th float: the
    # fleet's MFU proxy, so one allgather also answers "which rank is
    # spending its step on something other than compute"
    from . import capacity as _cap
    duty = _cap.duty_cycle(compute_ms, step_ms)
    vec = [step_ms, wait_ms, compute_ms,
           float(record.get("peak_live_bytes") or 0.0),
           float(record.get("examples_per_sec") or 0.0),
           nan_layer, duty]
    t0 = time.perf_counter()
    rows = None
    pl = _parallel()
    if pl is not None and n > 1:
        rows = [[float(x) for x in row]
                for row in pl.process_gather_hostvec(vec)]
    if rows is None:
        rows = [vec]
    exchange_ms = (time.perf_counter() - t0) * 1e3
    cols = list(zip(*rows))
    with _lock:
        # already paying an allgather here; snapshot config consistently
        wd = _watchdog
        stride = _stride
    thresh = wd.skew_threshold if wd is not None else SKEW_THRESHOLD
    view = {
        "record": "fleet",
        "step": record.get("step"),
        "stride": stride,
        "rank": r,
        "world_size": len(rows),
        "wall_time": time.time(),
        "step_ms": list(cols[0]),
        "allreduce_wait_ms": list(cols[1]),
        "compute_ms": list(cols[2]),
        "peak_live_bytes": list(cols[3]),
        "examples_per_sec": list(cols[4]),
        # per-rank first-NaN layer indices (-1 = clean); older peers'
        # 5-column vectors simply omit the column
        "first_nan_layer": ([int(v) for v in cols[5]]
                            if len(cols) > 5 else [-1] * len(rows)),
        # per-rank duty cycle (compute_ms / step_ms in [0, 1]); rows
        # gathered from older 6-column peers render as 0.0 (unknown)
        "duty_cycle": ([round(float(v), 4) for v in cols[6]]
                       if len(cols) > 6 else [0.0] * len(rows)),
        "exchange_ms": exchange_ms,
    }
    view["stragglers"] = detect_skew(view["compute_ms"], thresh)
    return view


def _emit_anomaly(anomaly, record):
    global _halted
    tel = _telemetry()
    r, n = world()
    evt = {"record": "anomaly", "step": record.get("step"),
           "rank": r, "world_size": n, "wall_time": time.time()}
    evt.update(anomaly)
    with _ring_lock:
        _ring.append(evt)
    if tel is not None:
        tel.count("fleet.anomaly")
        tel.count("fleet.anomaly." + evt["kind"])
        tel.emit(evt)
    with _lock:
        # anomalies are rare; snapshot the callback + halt opt-in
        # consistently against a concurrent configure()
        cb = _on_anomaly
        halt = _halt
    if cb is not None:
        try:
            cb(evt)
        except Exception:
            pass
    else:
        print("[mxnet_tpu_torch.fleet] anomaly %s at step %s (rank %d/%d): %s"
              % (evt["kind"], evt.get("step"), r, n,
                 {k: v for k, v in anomaly.items() if k != "kind"}),
              file=sys.stderr)
    if halt:
        with _lock:
            _halted = True
        incident("watchdog_halt", context={"anomaly": evt})
        raise WatchdogHalt("watchdog halt: %s at step %s"
                           % (evt["kind"], evt.get("step")))


def halt_requested():
    """True once the watchdog has halted this process (surfaced as 503
    on ``/healthz``)."""
    with _lock:
        return _halted


def last_view():
    """The most recent fleet-view record, or ``None``."""
    with _lock:
        return _last_view


# -- live /metrics + /healthz for a training rank -----------------------

class MetricsEndpoint:
    """Tiny stdlib HTTP endpoint for a TRAINING rank: ``/metrics``
    renders the process's telemetry snapshot via the shared
    ``promtext`` renderer (the serving stack's exact conventions) plus
    fleet gauges; ``/healthz`` returns 200, or 503 once the watchdog
    has halted. ``port=0`` picks a free port (see :attr:`url`)."""

    def __init__(self, port=0, host="127.0.0.1"):
        self._host = host
        self._port = int(port)
        self._server = None
        self._thread = None

    def start(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):   # noqa: N802 - stdlib API
                try:
                    if self.path.startswith("/metrics"):
                        body = prometheus_text().encode()
                        ctype = "text/plain; version=0.0.4"
                        code = 200
                    elif self.path.startswith("/healthz"):
                        r, n = world()
                        view = last_view()
                        halted = halt_requested()
                        payload = {
                            "status": "halted" if halted else "ok",
                            "rank": r, "world_size": n,
                            "step": view.get("step") if view else None,
                        }
                        body = json.dumps(payload).encode()
                        ctype = "application/json"
                        code = 503 if halted else 200
                    else:
                        body, ctype, code = b"not found\n", "text/plain", 404
                except Exception as e:   # scrape failure is a 500, never a crash
                    body = ("scrape error: %s\n" % e).encode()
                    ctype, code = "text/plain", 500
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # keep rank stderr clean
                pass

        self._server = ThreadingHTTPServer((self._host, self._port), _Handler)
        self._server.daemon_threads = True
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="mxt-fleet-metrics", daemon=True)
        self._thread.start()
        return self

    @property
    def port(self):
        return self._port

    @property
    def url(self):
        return "http://%s:%d" % (self._host, self._port)

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def prometheus_text():
    """The training rank's scrape body: telemetry counters/gauges/hists
    plus fleet identity gauges, rendered by ``telemetry.promtext``."""
    r, n = world()
    extra = {"fleet.rank": r, "fleet.world_size": n}
    view = last_view()
    if view is not None and view.get("step") is not None:
        extra["fleet.step"] = view["step"]
    with _ring_lock:
        extra["fleet.ring_depth"] = len(_ring)
    return promtext.prometheus_text(extra_gauges=extra)


def metrics_url():
    """URL of the live endpoint, or ``None`` when not serving."""
    ep = _endpoint
    return ep.url if ep is not None else None


# -- lifecycle ----------------------------------------------------------

def enable(stride=None, ring=None, skew_threshold=None, consecutive=None,
           spike_factor=None, regression_factor=None, min_history=None,
           growth_factor=None, on_anomaly=None, halt=None,
           http_port=None):
    """Turn the fleet layer on. ``None`` args fall back to
    ``MXNET_FLEET_*`` env knobs, then module defaults. ``on_anomaly``
    replaces the default one-line stderr warning; ``halt=True`` makes
    anomalies raise :class:`WatchdogHalt` out of ``step_end``;
    ``http_port`` (0 = auto) starts :class:`MetricsEndpoint`."""
    global _enabled, _stride, _ring, _watchdog, _on_anomaly, _halt
    global _endpoint, _atexit_installed
    env = os.environ
    if stride is None:
        stride = int(env.get("MXNET_FLEET_STRIDE", DEFAULT_STRIDE))
    if ring is None:
        ring = int(env.get("MXNET_FLEET_RING", RING_CAPACITY))
    if skew_threshold is None:
        skew_threshold = float(env.get("MXNET_FLEET_SKEW", SKEW_THRESHOLD))
    if consecutive is None:
        consecutive = int(env.get("MXNET_FLEET_WINDOWS", CONSECUTIVE))
    if spike_factor is None:
        spike_factor = SPIKE_FACTOR
    if regression_factor is None:
        regression_factor = REGRESSION_FACTOR
    if min_history is None:
        min_history = MIN_HISTORY
    if growth_factor is None:
        growth_factor = float(env.get("MXNET_FLEET_GROWTH", GROWTH_FACTOR))
    if halt is None:
        halt = env.get("MXNET_FLEET_HALT", "0") == "1"
    with _lock:
        _stride = int(stride)
        _on_anomaly = on_anomaly
        _halt = bool(halt)
        _watchdog = Watchdog(skew_threshold=skew_threshold,
                             consecutive=consecutive,
                             spike_factor=spike_factor,
                             regression_factor=regression_factor,
                             min_history=min_history,
                             growth_factor=growth_factor)
    with _ring_lock:
        if int(ring) != _ring.maxlen:
            _ring = collections.deque(_ring, maxlen=int(ring))
    if not _atexit_installed:
        atexit.register(_atexit_dump)
        _atexit_installed = True
    if http_port is not None and _endpoint is None:
        _endpoint = MetricsEndpoint(http_port).start()
    _enabled = True


def disable():
    """Turn the fleet layer off (ring contents survive for post-mortem
    reads until :func:`clear`)."""
    global _enabled, _endpoint
    _enabled = False
    ep = _endpoint
    _endpoint = None
    if ep is not None:
        try:
            ep.stop()
        except Exception:
            pass


def is_enabled():
    return _enabled


if os.environ.get("MXNET_FLEET", "0") == "1":
    enable()

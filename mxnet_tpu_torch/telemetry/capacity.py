"""Capacity observability: lane duty cycle, saturation, headroom.

Counterpart of ``mxnet_tpu/telemetry/capacity.py`` (the same arithmetic,
number for number).  It turns stamps the serving lanes already take into
four signal families:

* **duty cycle** — per-lane busy/idle interval ledgers.  The prefill and
  decode lanes hand over the ``perf_counter`` stamps they take anyway
  (``lane_busy`` / ``note_tick``); ``utilization`` is the busy fraction
  of a sliding window (default 10 s).  On a card a decode tick's stamps
  close after the host has the tick's tokens (the lane's own sync), so
  an interval covers the card's work and not just its launch.
* **occupancy** — decode batch occupancy (active slots ÷ slot capacity,
  EWMA-smoothed per tick) and speculative verify efficiency (accepted ÷
  drafted tokens).
* **KV pressure** — blocks free ÷ total from the paged pool, plus a
  fragmentation trend (EWMA of fragmentation deltas).
* **queue theory** — EWMA arrival rate (λ, from inter-arrival gaps at
  ``Replica.offer``) and the service rate μ from the utilization law
  ``U = X/μ`` → ``μ = X/U`` (completion throughput ÷ busy fraction, over
  the SAME sliding window).  ``ρ = λ/μ`` is the saturation measure and
  ``headroom_rps = μ − λ`` the live admission budget.

A saturation watch runs inside the note hooks: when
a replica's ρ crosses the threshold (default 0.85) with enough
completions behind it, ONE ``{"record": "saturation"}`` JSONL event is
emitted, ``capacity.saturation`` is counted and the flight recorder is
armed (``tracing.incident("saturation")``); the watch re-arms once ρ
falls below threshold × 0.8.  The training side folds a duty-cycle float
(``compute_ms ÷ step_ms``, :func:`duty_cycle`) into the fleet exchange.

Disabled, every hook is one module-global boolean test.  Enabled, each
is a few float ops under one lock; recording never touches the device.
Knobs, read at ``enable()``: ``MXNET_CAPACITY=1`` autostarts with the
parent package; ``MXNET_CAPACITY_WINDOW`` (10 s), ``MXNET_CAPACITY_ALPHA``
(0.2), ``MXNET_CAPACITY_RHO`` (0.85), ``MXNET_CAPACITY_MIN_COMPLETIONS``
(8).
"""
from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque

from .. import sanitizer as _sanitizer

__all__ = [
    "enable", "disable", "is_enabled", "reset",
    "EWMA", "RateEstimator", "EventWindow", "IntervalLedger",
    "queue_metrics", "service_rate", "duty_cycle",
    "note_arrival", "note_completion", "note_tick", "note_spec",
    "note_kv", "lane_busy",
    "utilization", "snapshot", "saturated",
]

# -- defaults (env-overridable at enable() time) ------------------------

#: sliding window for busy-fraction accounting, seconds
DEFAULT_WINDOW_S = 10.0
#: EWMA smoothing factor for rates / occupancy / spec efficiency
DEFAULT_ALPHA = 0.2
#: saturation fires when rho crosses this
DEFAULT_RHO_THRESHOLD = 0.85
#: rho must fall below threshold * this factor to re-arm the watch
REARM_FACTOR = 0.8
#: completions a replica needs before its mu estimate is trusted
DEFAULT_MIN_COMPLETIONS = 8
#: mu is not estimated below this busy fraction (the utilization law
#: divides by U; an idle replica's U is noise, not a denominator)
MIN_BUSY_FRACTION = 0.02
#: busy intervals kept per lane ledger (oldest age out)
LEDGER_CAP = 2048

_enabled = False
_lock = _sanitizer.wrap_lock(threading.Lock(), "capacity._lock")
_replicas = {}            # index -> _ReplicaCapacity
_window_s = DEFAULT_WINDOW_S
_alpha = DEFAULT_ALPHA
_rho_threshold = DEFAULT_RHO_THRESHOLD
_min_completions = DEFAULT_MIN_COMPLETIONS


def _telemetry():
    # resolved lazily; the parent package imports this module
    return sys.modules.get("mxnet_tpu_torch.telemetry")


# -- pure estimator pieces (unit-tested without the serving stack) ------

class EWMA:
    """Exponentially-weighted moving average; ``None`` until fed."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha=DEFAULT_ALPHA):
        self.alpha = float(alpha)
        self.value = None

    def update(self, x):
        x = float(x)
        if self.value is None:
            self.value = x
        else:
            self.value = self.alpha * x + (1.0 - self.alpha) * self.value
        return self.value


class RateEstimator:
    """Events/second from EWMA-smoothed inter-event gaps.

    Pure: the caller supplies every timestamp, so tests drive it with
    synthetic clocks.  ``rate`` is ``None`` until two events arrive;
    a long silence decays the estimate through :meth:`rate_at` (the
    open gap since the last event counts as a sample floor, so a
    stopped arrival stream reads as a falling λ, not a frozen one).
    """

    __slots__ = ("_gap", "_last", "count")

    def __init__(self, alpha=DEFAULT_ALPHA):
        self._gap = EWMA(alpha)
        self._last = None
        self.count = 0

    def observe(self, t):
        t = float(t)
        if self._last is not None and t > self._last:
            self._gap.update(t - self._last)
        self._last = t
        self.count += 1

    @property
    def rate(self):
        g = self._gap.value
        return (1.0 / g) if g else None

    def rate_at(self, now):
        """Rate estimate at ``now``: if the open gap since the last
        event already exceeds the smoothed gap, it bounds the rate."""
        g = self._gap.value
        if g is None:
            return None
        if self._last is not None and now - self._last > g:
            g = self._gap.alpha * (now - self._last) \
                + (1.0 - self._gap.alpha) * g
        return 1.0 / g if g > 0 else None


class EventWindow:
    """Events/second over the same sliding window the interval
    ledgers use: timestamps in a bounded ring, rate = count ÷ span
    (ramp-up aware).  μ divides a throughput by a busy fraction — the
    operational law ``U = X/μ`` only holds when X and U are measured
    over the SAME period, so the completion rate must be windowed like
    the utilization, not EWMA-smoothed like λ (an EWMA X right after
    an idle gap reads "recent burst pace" against a window-diluted U
    and inflates μ several-fold)."""

    __slots__ = ("window_s", "_cap", "_times", "_opened", "count")

    def __init__(self, window_s=DEFAULT_WINDOW_S, cap=LEDGER_CAP):
        self.window_s = float(window_s)
        self._cap = int(cap)
        self._times = deque()
        self._opened = None
        self.count = 0

    def observe(self, t):
        t = float(t)
        if self._opened is None:
            self._opened = t
        self._times.append(t)
        self.count += 1
        self._prune(t - self.window_s)

    def _prune(self, lo):
        # hot-path discipline: expired timestamps leave as they expire,
        # so no call ever scans the window (amortized O(1) — each event
        # is appended once and popped once)
        times = self._times
        while times and times[0] <= lo:
            times.popleft()
        while len(times) > self._cap:
            times.popleft()

    def rate(self, now):
        """Events/sec over ``[now - window, now]``; ``None`` before
        the first event, 0.0 for a gone-quiet stream.  Queries must be
        monotone in ``now`` (expired events are dropped for O(1) cost)
        — true for wall-clock callers by construction."""
        if self._opened is None:
            return None
        self._prune(now - self.window_s)
        span = min(self.window_s, max(now - self._opened, 1e-9))
        times = self._times
        n = len(times)
        if n and times[-1] > now:
            n = sum(1 for t in times if t <= now)
        return n / span


class IntervalLedger:
    """Bounded ring of busy ``(t0, t1)`` intervals → busy fraction
    over a sliding window.  Intervals are appended retroactively from
    stamps the caller already took; nothing here reads a clock."""

    __slots__ = ("window_s", "_cap", "_intervals", "_opened", "_busy")

    def __init__(self, window_s=DEFAULT_WINDOW_S, cap=LEDGER_CAP):
        self.window_s = float(window_s)
        self._cap = int(cap)
        self._intervals = deque()
        self._opened = None     # first t0 ever seen: ramp-up horizon
        self._busy = 0.0        # running sum over retained intervals

    def add(self, t0, t1):
        if t1 <= t0:
            return
        if self._opened is None:
            self._opened = t0
        self._intervals.append((t0, t1))
        self._busy += t1 - t0
        self._prune(t1 - self.window_s)

    def _prune(self, lo):
        # amortized O(1): each interval enters and leaves the running
        # sum exactly once, so utilization never scans the window
        iv = self._intervals
        while iv and iv[0][1] <= lo:
            a, b = iv.popleft()
            self._busy -= b - a
        while len(iv) > self._cap:
            a, b = iv.popleft()
            self._busy -= b - a

    def utilization(self, now):
        """Busy fraction of ``[now - window, now]``; the denominator
        ramps from first observation so a 1 s-old ledger reports its
        1 s truth instead of diluting into an empty 10 s window.
        Queries must be monotone in ``now`` (expired intervals are
        dropped) — true for wall-clock callers by construction."""
        if self._opened is None:
            return 0.0
        lo = now - self.window_s
        span = min(self.window_s, max(now - self._opened, 1e-9))
        self._prune(lo)
        busy = self._busy
        iv = self._intervals
        if iv:
            # at most the oldest retained interval straddles the window
            # start (a lane's intervals are sequential), and at most
            # the newest runs past ``now``: clamp both, scan neither
            a0, b0 = iv[0]
            if a0 < lo:
                busy -= lo - a0
            an, bn = iv[-1]
            if bn > now > an:
                busy -= bn - now
        return max(0.0, min(1.0, busy / span))


def queue_metrics(lam, mu):
    """``(rho, headroom_rps)`` from arrival and service rates; either
    input ``None``/non-positive → ``(None, None)``."""
    if not lam or not mu or lam <= 0 or mu <= 0:
        return (None, None)
    return (lam / mu, max(0.0, mu - lam))


def service_rate(completion_rate, busy_fraction,
                 floor=MIN_BUSY_FRACTION):
    """μ via the operational utilization law ``U = X/μ`` → ``μ = X/U``
    (completion throughput ÷ busy fraction): what the replica would
    complete at 100 % duty cycle.  ``None`` until the replica has been
    measurably busy (below ``floor`` the denominator is noise)."""
    if completion_rate is None or busy_fraction is None:
        return None
    if completion_rate <= 0 or busy_fraction < floor:
        return None
    return completion_rate / min(1.0, busy_fraction)


def duty_cycle(compute_ms, step_ms):
    """Training-side duty cycle, ``compute_ms ÷ step_ms`` clamped to
    [0, 1] — the float ``telemetry.fleet`` folds into the stride
    exchange (0.0 when the step time is unknown)."""
    try:
        s = float(step_ms)
        c = float(compute_ms)
    except (TypeError, ValueError):
        return 0.0
    if s <= 0:
        return 0.0
    return max(0.0, min(1.0, c / s))


# -- per-replica accounting ---------------------------------------------

class _ReplicaCapacity:
    __slots__ = ("index", "lanes", "arrivals", "completions",
                 "occupancy", "slot_capacity", "spec_drafted",
                 "spec_accepted", "kv_free", "kv_total",
                 "kv_fragmentation", "kv_frag_trend", "saturated",
                 "saturation_events")

    def __init__(self, index, window_s, alpha):
        self.index = index
        self.lanes = {"prefill": IntervalLedger(window_s),
                      "decode": IntervalLedger(window_s)}
        self.arrivals = RateEstimator(alpha)
        self.completions = EventWindow(window_s)
        self.occupancy = EWMA(alpha)
        self.slot_capacity = None
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.kv_free = None
        self.kv_total = None
        self.kv_fragmentation = EWMA(alpha)
        self.kv_frag_trend = EWMA(alpha)   # EWMA of frag deltas
        self.saturated = False
        self.saturation_events = 0

    def lane(self, name):
        led = self.lanes.get(name)
        if led is None:
            led = self.lanes[name] = IntervalLedger(
                self.lanes["decode"].window_s)
        return led

    def rates(self, now):
        """(lambda, X, mu) at ``now`` — arrival rate, completion
        throughput, and the utilization-law service rate."""
        lam = self.arrivals.rate_at(now)
        x = self.completions.rate(now)
        busy = self.lanes["decode"].utilization(now)
        # prefill-only traffic (max_new_tokens == 1) never ticks the
        # decode lane; fold both lanes so mu reflects the server's
        # actual busy fraction, capped at 1.
        busy = min(1.0, busy + self.lanes["prefill"].utilization(now))
        return lam, x, service_rate(x, busy)

    def view(self, now):
        lam, x, mu = self.rates(now)
        rho, headroom = queue_metrics(lam, mu)
        spec_eff = (self.spec_accepted / self.spec_drafted
                    if self.spec_drafted else None)
        kv_free_frac = (self.kv_free / self.kv_total
                        if self.kv_total else None)
        return {
            "replica": self.index,
            "utilization": round(
                self.lanes["decode"].utilization(now), 6),
            "prefill_utilization": round(
                self.lanes["prefill"].utilization(now), 6),
            "occupancy": self.occupancy.value,
            "slot_capacity": self.slot_capacity,
            "spec_efficiency": spec_eff,
            "kv_free_frac": kv_free_frac,
            "kv_fragmentation": self.kv_fragmentation.value,
            "kv_fragmentation_trend": self.kv_frag_trend.value,
            "arrival_rate_rps": lam,
            "completion_rate_rps": x,
            "service_rate_rps": mu,
            "predicted_max_rate_rps": mu,
            "rho": rho,
            "headroom_rps": headroom,
            "completions": self.completions.count,
            "saturated": self.saturated,
            "saturation_events": self.saturation_events,
        }


def _replica(index):
    rc = _replicas.get(index)
    if rc is None:
        rc = _replicas[index] = _ReplicaCapacity(
            index, _window_s, _alpha)
    return rc


# -- the saturation watch ------------------------------------------------

def _check_saturation(rc, now):
    """Edge-triggered under ``_lock``: returns the event record to emit
    (the caller emits it after releasing the lock — telemetry and
    tracing take their own locks) or ``None``."""
    if rc.completions.count < _min_completions:
        return None
    lam, x, mu = rc.rates(now)
    rho, headroom = queue_metrics(lam, mu)
    if rho is None:
        return None
    if rc.saturated:
        if rho < _rho_threshold * REARM_FACTOR:
            rc.saturated = False
        return None
    if rho < _rho_threshold:
        return None
    rc.saturated = True
    rc.saturation_events += 1
    return {
        "record": "saturation",
        "replica": rc.index,
        "wall_time": time.time(),
        "rho": round(rho, 4),
        "threshold": _rho_threshold,
        "arrival_rate_rps": round(lam, 3),
        "service_rate_rps": round(mu, 3),
        "headroom_rps": round(headroom, 3),
        "utilization": round(
            rc.lanes["decode"].utilization(now), 6),
        "occupancy": rc.occupancy.value,
        "kv_free_frac": (rc.kv_free / rc.kv_total
                         if rc.kv_total else None),
        "completions": rc.completions.count,
    }


def _emit_saturation(event):
    tel = _telemetry()
    if tel is not None and tel.is_enabled():
        tel.count("capacity.saturation")
        tel.count(f"capacity.saturation|replica={event['replica']}")
        tel.emit(event)
    # arm the flight recorder BEFORE goodput degrades: the ring
    # holds the traces leading up to the crossing
    try:
        from . import tracing
        tracing.incident("saturation",
                         context={k: event[k] for k in
                                  ("replica", "rho", "headroom_rps",
                                   "arrival_rate_rps",
                                   "service_rate_rps")})
    except Exception:
        pass    # the watch never raises into a lane thread


# -- hot-path hooks (one boolean when disabled) --------------------------

def note_arrival(index, t=None):
    """A request entered replica ``index``'s queue (called from
    ``Replica.offer`` on accepted offers only — rejects never arrive)."""
    if not _enabled:
        return
    now = time.perf_counter() if t is None else t
    with _lock:
        rc = _replica(index)
        rc.arrivals.observe(now)
        event = _check_saturation(rc, now)
    if event is not None:
        _emit_saturation(event)


def note_completion(index, t=None):
    """A request finished on replica ``index`` (``Replica.finish``)."""
    if not _enabled:
        return
    now = time.perf_counter() if t is None else t
    with _lock:
        rc = _replica(index)
        rc.completions.observe(now)
        event = _check_saturation(rc, now)
    if event is not None:
        _emit_saturation(event)


def note_tick(index, active, slot_capacity, t0, t1):
    """One decode tick: ``active`` slots of ``slot_capacity`` were
    advanced between the stamps the lane already took."""
    if not _enabled:
        return
    with _lock:
        rc = _replica(index)
        rc.lanes["decode"].add(t0, t1)
        rc.slot_capacity = int(slot_capacity)
        if slot_capacity:
            rc.occupancy.update(active / slot_capacity)


def note_spec(index, drafted, accepted):
    """Speculative verify outcome for one tick (token totals)."""
    if not _enabled:
        return
    with _lock:
        rc = _replica(index)
        rc.spec_drafted += int(drafted)
        rc.spec_accepted += int(accepted)


def note_kv(index, free_blocks, total_blocks, fragmentation=None):
    """Paged-pool pressure.  ``fragmentation`` rides along where the
    caller already computed ``mgr.stats()`` (the summary path); the
    per-tick caller passes only the allocator's free/total counters."""
    if not _enabled:
        return
    with _lock:
        rc = _replica(index)
        rc.kv_free = int(free_blocks)
        rc.kv_total = int(total_blocks)
        if fragmentation is not None:
            prev = rc.kv_fragmentation.value
            cur = rc.kv_fragmentation.update(fragmentation)
            if prev is not None:
                rc.kv_frag_trend.update(cur - prev)


def lane_busy(index, lane, t0, t1):
    """Record a retroactive busy interval for ``lane`` (``"prefill"``
    forwards hand over their existing ``t_start``/``t_first`` stamps)."""
    if not _enabled:
        return
    with _lock:
        _replica(index).lane(lane).add(t0, t1)


# -- queries -------------------------------------------------------------

def utilization(index, lane="decode", now=None):
    """Busy fraction of ``lane`` on replica ``index`` over the sliding
    window; 0.0 when disabled or unseen."""
    if not _enabled:
        return 0.0
    if now is None:
        now = time.perf_counter()
    with _lock:
        rc = _replicas.get(index)
        if rc is None:
            return 0.0
        led = rc.lanes.get(lane)
        return led.utilization(now) if led is not None else 0.0


def saturated(index=None):
    """Whether ``index`` (or, with ``None``, any replica) currently
    sits above the ρ threshold."""
    if not _enabled:
        return False
    with _lock:
        if index is not None:
            rc = _replicas.get(index)
            return bool(rc is not None and rc.saturated)
        return any(rc.saturated for rc in _replicas.values())


def snapshot(index=None, now=None):
    """Capacity view: one dict for replica ``index``, or
    ``{index: view}`` for every tracked replica.  ``{}``/``None`` when
    disabled — the serving surfaces skip the block entirely."""
    if not _enabled:
        return None if index is not None else {}
    if now is None:
        now = time.perf_counter()
    with _lock:
        if index is not None:
            rc = _replicas.get(index)
            return rc.view(now) if rc is not None else None
        return {i: rc.view(now) for i, rc in _replicas.items()}


# -- lifecycle -----------------------------------------------------------

def enable(window_s=None, alpha=None, rho_threshold=None,
           min_completions=None):
    """Arm capacity accounting (idempotent).  Usually reached through
    ``telemetry.enable(capacity=True)`` or ``MXNET_CAPACITY=1``."""
    global _enabled, _window_s, _alpha, _rho_threshold, _min_completions
    env = os.environ.get
    _window_s = float(window_s if window_s is not None
                      else env("MXNET_CAPACITY_WINDOW",
                               DEFAULT_WINDOW_S))
    _alpha = float(alpha if alpha is not None
                   else env("MXNET_CAPACITY_ALPHA", DEFAULT_ALPHA))
    _rho_threshold = float(
        rho_threshold if rho_threshold is not None
        else env("MXNET_CAPACITY_RHO", DEFAULT_RHO_THRESHOLD))
    _min_completions = int(
        min_completions if min_completions is not None
        else env("MXNET_CAPACITY_MIN_COMPLETIONS",
                 DEFAULT_MIN_COMPLETIONS))
    with _lock:
        _replicas.clear()
    _enabled = True


def disable():
    global _enabled
    _enabled = False
    with _lock:
        _replicas.clear()


def is_enabled():
    return _enabled


def reset():
    """Forget every replica's ledgers/estimators (keeps the switch)."""
    with _lock:
        _replicas.clear()


if os.environ.get("MXNET_CAPACITY", "0") == "1":
    enable()

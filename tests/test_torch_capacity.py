"""Capacity observability of the port (``telemetry.capacity``) against the
reference's.

* **Equal arithmetic.**  The same explicit timestamps and values go
  through both packages' ``EWMA``, ``RateEstimator``, ``EventWindow``,
  ``IntervalLedger``, ``queue_metrics``, ``service_rate`` and
  ``duty_cycle``, and through the per-replica ledgers (``note_*`` with
  explicit stamps, ``snapshot``): every number is equal, not close.
* **The saturation watch.**  One ``{"record": "saturation"}`` event per
  crossing, re-armed below threshold × 0.8, gated on completions, with
  the flight recorder's ``saturation`` dump where ``MXNET_TRACE_DUMP``
  says.
* **The null path.**  Disabled, no hook takes the lock and 40k hook
  calls stay under the reference's bound.
* **A served run.**  The paged server's ``stats()["capacity"]``,
  ``/healthz`` and ``serving.latency`` summaries carry the view with the
  reference's keys; the decode and prefill busy intervals come from the
  lanes' own stamps.
"""
import json
import math
import time
import urllib.request

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu.telemetry import capacity as jcap
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.telemetry import capacity as tcap
from mxnet_tpu_torch.telemetry import tracing
from mxnet_tpu_torch.telemetry.sinks import ListSink

CPU = tmx.cpu()
PKGS = (jcap, tcap)


@pytest.fixture(autouse=True)
def _off():
    yield
    for cap in PKGS:
        cap.disable()
        cap.reset()
    telemetry.disable()
    telemetry.reset()
    tracing.disable()
    tracing.clear()


def _both(fn):
    """``fn(capacity_module)`` in each package; the two results."""
    return [fn(cap) for cap in PKGS]


def _equal(a, b):
    """Equal, NaN-aware, through nested dicts and lists."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b and type(a) is type(b)


# --- equal arithmetic ----------------------------------------------------------

STAMPS = np.cumsum(np.random.RandomState(3).exponential(0.01, 300)) + 1000.0


def _ewma(cap):
    e = cap.EWMA(alpha=0.3)
    return [e.value] + [e.update(float(x)) for x in STAMPS[:50] % 7.0]


def _rate(cap):
    r = cap.RateEstimator(alpha=0.2)
    out = [r.rate, r.rate_at(1000.0)]
    for t in STAMPS:
        r.observe(float(t))
        out.append(r.rate)
    out += [r.rate_at(float(STAMPS[-1]) + d) for d in (0.001, 0.5, 2.0,
                                                        9.0)]
    return out + [r.count]


def _window(cap):
    w = cap.EventWindow(window_s=1.0, cap=128)
    out = [w.rate(999.0)]
    for t in STAMPS:
        w.observe(float(t))
        out.append(w.rate(float(t) + 0.001))
    return out + [w.rate(float(STAMPS[-1]) + 5.0), w.count]


def _ledger(cap):
    led = cap.IntervalLedger(window_s=1.0, cap=64)
    out = [led.utilization(999.0)]
    for a, b in zip(STAMPS[::2], STAMPS[1::2]):
        led.add(float(a), float(a) + (float(b) - float(a)) * 0.7)
        out.append(led.utilization(float(b)))
    led.add(5.0, 5.0)
    led.add(6.0, 4.0)
    return out + [led.utilization(float(STAMPS[-1]) + 0.5)]


def _queue_theory(cap):
    pairs = [(50.0, 100.0), (120.0, 100.0), (None, 100.0), (50.0, 0.0),
             (0.0, 3.0), (3.3, 7.1)]
    rates = [(50.0, 0.5), (80.0, 1.0), (50.0, 0.001), (None, 0.5),
             (0.0, 0.5), (33.3, 0.25), (5.0, 1.7)]
    duty = [(8.0, 10.0), (12.0, 10.0), (-1.0, 10.0), (5.0, 0.0),
            (None, None), ("x", "y"), (3.7, 11.3)]
    return ([cap.queue_metrics(a, b) for a, b in pairs],
            [cap.service_rate(a, b) for a, b in rates],
            [cap.service_rate(1.0, 0.1, floor=0.5)],
            [cap.duty_cycle(a, b) for a, b in duty])


@pytest.mark.parametrize("fn", [_ewma, _rate, _window, _ledger,
                                _queue_theory],
                         ids=["EWMA", "RateEstimator", "EventWindow",
                              "IntervalLedger", "queue_theory"])
def test_estimators_give_equal_numbers(fn):
    ref, port = _both(fn)
    assert _equal(ref, port), (ref, port)


def _drive_steady(cap, index, t0, n=100, period=0.01, busy=0.5):
    for i in range(n):
        now = t0 + i * period
        cap.note_arrival(index, t=now)
        cap.note_completion(index, t=now + period * 0.4)
        cap.note_tick(index, 4, 8, now, now + period * busy)


def _ledgers(cap):
    """The per-replica ledgers on a synthetic clock: a steady stream, a
    burst past the threshold, KV and speculation notes, prefill busy
    intervals; the view at several instants and the saturation events
    (their wall time dropped)."""
    events = []
    cap.enable(window_s=2.0, alpha=0.25, rho_threshold=0.85,
               min_completions=8)
    emit, cap._emit_saturation = cap._emit_saturation, events.append
    try:
        _drive_steady(cap, 3, 1000.0, n=200)
        cap.note_kv(3, 60, 100, fragmentation=0.25)
        cap.note_kv(3, 50, 100, fragmentation=0.35)
        cap.note_spec(3, 40, 25)
        cap.lane_busy(3, "prefill", 1001.0, 1001.3)
        views = [cap.snapshot(3, now=1001.99)]
        t = 1002.0
        for i in range(200):
            cap.note_arrival(3, t=t + i * 0.0025)
            if i % 2 == 0:
                now = t + i * 0.0025
                cap.note_completion(3, t=now + 0.004)
                cap.note_tick(3, 8, 8, now, now + 0.0049)
        views.append(cap.snapshot(3, now=1002.6))
        _drive_steady(cap, 3, 1003.0, n=300, period=0.05, busy=0.1)
        views.append(cap.snapshot(now=1018.0))
        util = [cap.utilization(3, lane, now=1018.0)
                for lane in ("decode", "prefill", "none")]
        return (views, util, cap.saturated(3), cap.saturated(),
                [{k: v for k, v in e.items() if k != "wall_time"}
                 for e in events])
    finally:
        cap._emit_saturation = emit


def test_replica_ledgers_and_saturation_events_are_equal():
    ref, port = _both(_ledgers)
    assert _equal(ref, port), (ref, port)
    views, _, _, _, events = port
    assert len(events) == 1 and events[0]["rho"] >= 0.85
    assert views[0]["spec_efficiency"] == 25 / 40
    assert views[0]["kv_fragmentation_trend"] > 0


# --- the saturation watch --------------------------------------------------------

def test_saturation_record_counter_and_one_flight_dump(tmp_path,
                                                       monkeypatch):
    """The watch's real emit: one ``saturation`` JSONL record, the
    counters, and the flight recorder armed with ``reason="saturation"``
    in the directory the environment names."""
    monkeypatch.setenv("MXNET_TRACE_DUMP", str(tmp_path / "flight.json"))
    telemetry.enable(memory=False, cost=False, trace=True)
    sink = ListSink()
    telemetry.add_sink(sink)
    tcap.enable(rho_threshold=0.85, min_completions=8)
    _drive_steady(tcap, 0, 1000.0)
    assert not tcap.saturated()
    t = 1001.0
    for i in range(200):
        tcap.note_arrival(0, t=t + i * 0.0025)
        if i % 2 == 0:
            now = t + i * 0.0025
            tcap.note_completion(0, t=now + 0.004)
            tcap.note_tick(0, 8, 8, now, now + 0.0049)
    sats = [r for r in sink.records if r.get("record") == "saturation"]
    assert len(sats) == 1 and sats[0]["replica"] == 0
    assert telemetry.counters()["capacity.saturation|replica=0"] == 1
    report = json.loads((tmp_path / "flight.json").read_text())
    assert report["reason"] == "saturation"
    assert report["context"]["rho"] >= 0.85
    assert tcap.saturated(0) and tcap.saturated()


def test_saturation_gated_on_min_completions(monkeypatch):
    fired = []
    tcap.enable(rho_threshold=0.5, min_completions=50)
    monkeypatch.setattr(tcap, "_emit_saturation", fired.append)
    _drive_steady(tcap, 0, 1000.0, n=40, busy=0.9)
    assert fired == []


def test_enable_reads_the_environment_knobs(monkeypatch):
    for k, v in (("WINDOW", "3.5"), ("ALPHA", "0.4"), ("RHO", "0.7"),
                 ("MIN_COMPLETIONS", "3")):
        monkeypatch.setenv("MXNET_CAPACITY_" + k, v)
    tcap.enable()
    assert (tcap._window_s, tcap._alpha, tcap._rho_threshold,
            tcap._min_completions) == (3.5, 0.4, 0.7, 3)
    telemetry.enable(memory=False, cost=False, capacity=True)
    assert tcap.is_enabled()
    telemetry.disable()
    assert not tcap.is_enabled()


# --- the null path -----------------------------------------------------------------

class _PoisonLock:
    def __enter__(self):
        raise AssertionError("a disabled capacity hook took the lock")

    def __exit__(self, *a):
        return False


def test_disabled_hooks_never_lock_or_record(monkeypatch):
    tcap.disable()
    monkeypatch.setattr(tcap, "_lock", _PoisonLock())
    tcap.note_arrival(0)
    tcap.note_completion(0, t=1.0)
    tcap.note_tick(0, 4, 8, 0.0, 1.0)
    tcap.note_spec(0, 4, 2)
    tcap.note_kv(0, 5, 10)
    tcap.lane_busy(0, "prefill", 0.0, 1.0)
    assert tcap.utilization(0) == 0.0
    assert tcap.saturated() is False
    assert tcap.snapshot(0) is None and tcap.snapshot() == {}


def test_disabled_overhead_bounded():
    tcap.disable()
    t0 = time.perf_counter()
    for i in range(10_000):
        tcap.note_arrival(0, t=float(i))
        tcap.note_completion(0, t=float(i))
        tcap.note_tick(0, 4, 8, float(i), float(i) + 0.5)
        tcap.lane_busy(0, "prefill", float(i), float(i) + 0.1)
    assert time.perf_counter() - t0 < 0.5


# --- a served run --------------------------------------------------------------------

def test_served_run_carries_the_capacity_view():
    """Two replicas in this process (``mesh={'dp': 2}``): the stats,
    the health rows, the scrape and the ``serving.latency`` summaries
    carry each replica's view, with the reference's keys; the busy
    intervals are the lanes' own stamps, so the decode utilization is
    in (0, 1] and the prefill one too."""
    from mxnet_tpu_torch.models.llama import llama_tiny

    net = llama_tiny()
    net.initialize(ctx=CPU)
    telemetry.enable(memory=False, cost=False, capacity=True)
    sink = ListSink()
    telemetry.add_sink(sink)
    rs = np.random.RandomState(7)
    cfg = serving.ServerConfig(max_batch=2, max_length=64, min_length=8,
                               num_slots=2, summary_every=2, http_port=0)
    with serving.GenerativeServer(net, cfg, mesh={"dp": 2}) as srv:
        futs = [srv.submit(rs.randint(1, 250, size=6), max_new_tokens=4)
                for _ in range(8)]
        [f.result(120) for f in futs]
        stats = srv.stats()
        health = json.loads(urllib.request.urlopen(
            srv.metrics_url + "/healthz").read())
        scrape = urllib.request.urlopen(
            srv.metrics_url + "/metrics").read().decode()
    jkeys = set(jcap._ReplicaCapacity(0, 10.0, 0.2).view(1.0))
    caps = stats["capacity"]
    assert [c["replica"] for c in caps] == [0, 1]
    for c in caps:
        assert set(c) == jkeys
        assert 0.0 < c["utilization"] <= 1.0
        assert 0.0 < c["prefill_utilization"] <= 1.0
        assert c["slot_capacity"] == 2 and c["kv_free_frac"] is not None
        assert c["completions"] >= 1
    assert sum(c["completions"] for c in caps) == 8
    assert all("rho" in r and "headroom_rps" in r
               for r in health["replicas"])
    assert health["status"] in ("ok", "saturated")
    for fam in ("mxt_serving_utilization", "mxt_serving_kv_free_frac"):
        assert fam in scrape
    summaries = [r for r in sink.records
                 if r.get("record") == "serving.latency"]
    assert summaries and all(set(s["capacity"]) == jkeys
                             for s in summaries)

"""The fleet watchdog of the port (``telemetry.fleet``) against the
reference's.

* **Detectors and the watchdog.**  ``detect_skew``, ``detect_nan``,
  ``detect_spike``, ``growth_streak`` and ``Watchdog``'s anomaly lists
  are equal in both packages on the same inputs (the reference's cases
  and a seeded stream of step records and fleet views).
* **The stride exchange on a 2-rank gloo group.**  Off-stride steps make
  no collective (counted); a rank slowed by a sleep is named a straggler
  after ``consecutive`` windows in both ranks' views and anomaly
  streams; NaN poisoned into ``decoder.1`` on one rank gives
  ``first_nan_layer`` 1 for that rank in every rank's view.  The
  reference's ``tools/fleet_report.py`` reads the ranks' JSONL streams
  and names the straggler.
* **The flight recorder.**  Dumps are atomic and rate-limited per reason,
  go where ``MXNET_FLEET_DUMP`` or ``path=`` says, never raise, and the
  reference's ``fleet_report.py`` reads a port dump (the preemption
  drain's).
* **The numerics fleet cases** of the reference's
  ``tests/test_numerics.py``: the NaN in layer 1 attributed with its
  rank, and the grad-norm growth detectors.
"""
import json
import math
import os
import sys
import time
import urllib.request

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import spawn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(tmp):
    """One rank of the 2-rank gloo group (no JAX): the straggler phase at
    stride 2, then the NaN phase at stride 1."""
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import nd, parallel, telemetry
    from mxnet_tpu_torch.models import llama
    from mxnet_tpu_torch.telemetry import fleet, numerics

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)
    r = parallel.rank()
    calls = []
    real = torch.distributed.all_reduce

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    torch.distributed.all_reduce = counting
    out = {}
    anomalies = []
    telemetry.enable(jsonl_path=str(tmp / f"fleet.rank{r}.jsonl"),
                     memory=False, cost=False)
    fleet.enable(stride=2, consecutive=2, on_anomaly=anomalies.append)
    per_step = []
    for _ in range(12):
        n0 = len(calls)
        telemetry.step_begin()
        time.sleep(0.04 if r == 1 else 0.002)
        telemetry.count("trainer.allreduce_wait_ms", 0.5)
        telemetry.step_end(examples=4, loss=0.5)
        per_step.append(len(calls) - n0)
    out["per_step_collectives"] = np.array(per_step)
    out["straggler_anomalies"] = json.dumps(anomalies)
    out["view"] = json.dumps(fleet.last_view())
    telemetry.disable()
    fleet.clear()

    # the NaN phase: rank 1 poisons decoder layer 1
    anomalies.clear()
    telemetry.enable(memory=False, cost=False)
    numerics.enable(stride=1)
    fleet.enable(stride=1, on_anomaly=anomalies.append)
    net = llama.llama_tiny()
    net.initialize(tmx.init.Xavier(), ctx=cpu)
    if r == 1:
        victim = next(iter(net.model.layers[1].collect_params().values()))
        host = victim.data().asnumpy()
        host.flat[0] = float("nan")
        victim.set_data(nd.array(host, ctx=cpu))
    ids = nd.array(np.ones((2, 8), dtype="int32"), ctx=cpu)
    with telemetry.step(examples=2):
        net(ids)
    out["nan_view"] = json.dumps(fleet.last_view())
    out["nan_anomalies"] = json.dumps(anomalies)
    telemetry.disable()
    numerics.clear()
    fleet.clear()
    torch.distributed.all_reduce = real
    np.savez(tmp / f"rank{r}.npz", **out)


@pytest.fixture(autouse=True)
def _clean():
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import fleet

    telemetry.disable()
    telemetry.reset()
    fleet.clear()
    yield
    telemetry.disable()
    telemetry.reset()
    fleet.clear()
    telemetry.numerics.clear()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet2")
    return tmp, spawn(2, tmp, __file__, timeout=150)


def _fleets():
    from mxnet_tpu.telemetry import fleet as jfleet
    from mxnet_tpu_torch.telemetry import fleet as tfleet

    return jfleet, tfleet


def _fleet_report():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import fleet_report
    return fleet_report


# --- detectors and the watchdog: equal in both packages ----------------------

def _detectors(fl):
    nan = float("nan")
    return (
        [fl.detect_skew(v, 1.5) for v in (
            [10.0, 10.0, 25.0, 10.0], [10.0, 10.0, 10.0], [10.0, 50.0],
            [7.0], [], [0.0, 0.0, 0.0], [10.0, None, 40.0, 10.0],
            [None, None, None], [3.1, 4.7, 9.9, 2.2])],
        [fl.detect_nan(v) for v in (nan, float("inf"), float("-inf"),
                                    "not-a-number", 3.5, 0, None)],
        [fl.detect_spike(v, h, factor=f, min_history=m) for v, h, f, m in (
            (100.0, [1.0] * 7, 10, 8), (100.0, [1.0] * 8, 10, 8),
            (5.0, [1.0] * 8, 10, 8), (100.0, [0.0] * 8, 10, 8),
            (100.0, [5.0, None, 5.0, 5.0, None, 5.0], 3.0, 4),
            (None, [5.0] * 8, 3.0, 4))],
        [fl.growth_streak(h, 2.0) for h in (
            [1.0, 3.0, 7.0, 20.0], [10.0, 3.0, 7.0, 20.0],
            [1.0, 3.0, None, 20.0], [1.0, None, 3.0, 20.0], [], [5.0],
            [-1.0, 5.0], [0.0, 5.0])])


def test_detectors_are_equal_in_both_packages():
    jfleet, tfleet = _fleets()
    assert _detectors(tfleet) == _detectors(jfleet)
    assert _detectors(tfleet)[3] == [3, 2, 0, 1, 0, 0, 0, 0]


def _watchdog_run(fl):
    """A seeded stream of step records and fleet views through one
    Watchdog: every anomaly list it returns."""
    rng = np.random.RandomState(4)
    wd = fl.Watchdog(skew_threshold=1.5, consecutive=2, min_history=4,
                     spike_factor=5.0, regression_factor=2.0,
                     growth_factor=2.0)
    out = []
    gn = 1.0
    for step in range(1, 41):
        gn = gn * 2.5 if 20 <= step < 25 else 1.0 + rng.rand()
        rec = {"step": step, "loss": float("nan") if step == 13 else 0.5,
               "grad_norm": gn, "step_ms": 40.0 if step == 30 else
               10.0 + rng.rand()}
        if step == 33:
            rec["numerics"] = {"first_nan": {"path": "decoder.1",
                                             "layer": 1, "nan": 3,
                                             "inf": 0}}
        out.append(wd.observe_step(rec))
        if step % 4 == 0:
            slow = 1 if 8 <= step <= 20 else None
            comp = [10.0 + rng.rand() for _ in range(3)]
            wait = [2.0 + rng.rand() for _ in range(3)]
            if slow is not None:
                comp[slow] *= 3.0
            if step == 36:
                wait[2] *= 5.0
            out.append(wd.observe_fleet(step, {"compute_ms": comp,
                                               "allreduce_wait_ms": wait}))
    return out


def test_watchdog_anomaly_lists_are_equal():
    jfleet, tfleet = _fleets()
    want, got = _watchdog_run(jfleet), _watchdog_run(tfleet)

    def canon(lists):
        return json.dumps(lists, sort_keys=True, default=repr)

    assert canon(got) == canon(want)
    kinds = {a["kind"] for lst in got for a in lst}
    assert {"nan_loss", "straggler", "grad_norm_explosion",
            "step_regression", "nan_tensor"} <= kinds


# --- the 2-rank gloo exchange -----------------------------------------------------

def test_exchange_runs_at_the_stride_only(ranks):
    _, outs = ranks
    for o in outs:
        per = o["per_step_collectives"].tolist()
        # steps 1..12 at stride 2: one gather at each even step, none off
        assert per[0::2] == [0] * 6, per
        assert all(n >= 1 for n in per[1::2]), per
        view = json.loads(str(o["view"]))
        assert view["world_size"] == 2 and view["stride"] == 2
        assert len(view["duty_cycle"]) == 2 and view["step"] == 12
        assert all(0.0 < d <= 1.0 for d in view["duty_cycle"])


def test_slow_rank_is_named_a_straggler_in_every_view(ranks):
    tmp, outs = ranks
    for o in outs:
        view = json.loads(str(o["view"]))
        assert view["stragglers"] == [1]
        anomalies = json.loads(str(o["straggler_anomalies"]))
        strag = [a for a in anomalies if a["kind"] == "straggler"]
        # consecutive=2: first named at the second exchange (step 4)
        assert strag and strag[0]["step"] == 4
        assert all(a["culprit"] == 1 and a["windows"] >= 2 for a in strag)
    fleet_report = _fleet_report()
    rep = tmp / "report.txt"
    assert fleet_report.main([str(tmp / "fleet.rank*.jsonl"),
                              "--out", str(rep)]) == 0
    text = rep.read_text()
    line = next(ln for ln in text.splitlines()
                if ln.startswith("stragglers"))
    assert "rank 1 (" in line, text


def test_nan_layer_rides_the_exchange_to_every_rank(ranks):
    _, outs = ranks
    for r, o in enumerate(outs):
        view = json.loads(str(o["nan_view"]))
        assert view["first_nan_layer"] == [-1, 1]
        nan = [a for a in json.loads(str(o["nan_anomalies"]))
               if a["kind"] == "nan_tensor"]
        if r == 1:
            assert nan and nan[0]["path"] == "decoder.1"
            assert nan[0]["layer"] == 1 and nan[0]["rank"] == 1
        else:
            assert nan == []


# --- single-process behaviour ---------------------------------------------------

def test_disabled_fleet_never_locks_or_mutates(monkeypatch):
    _, tfleet = _fleets()

    class _Poison:
        def __enter__(self):
            raise AssertionError("the disabled fleet path took a lock")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tfleet, "_lock", _Poison())
    monkeypatch.setattr(tfleet, "_ring_lock", _Poison())
    rec = {"step": 1, "step_ms": 5.0, "loss": float("nan")}
    tfleet.on_step_record(rec)
    assert "rank" not in rec and tfleet.incident("anything") is None
    t0 = time.perf_counter()
    for _ in range(10_000):
        tfleet.on_step_record(rec)
    assert time.perf_counter() - t0 < 0.5


def test_records_gain_rank_and_views_emit_at_stride(tmp_path):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry.sinks import ListSink

    _, tfleet = _fleets()
    telemetry.enable(memory=False, cost=False)
    sink = ListSink()
    telemetry.add_sink(sink)
    tfleet.enable(stride=3)
    for _ in range(7):
        telemetry.step_begin()
        telemetry.step_end(examples=2, loss=1.0)
    steps = [r for r in sink.records if "step_ms" in r]
    views = [r for r in sink.records if r.get("record") == "fleet"]
    assert all((r["rank"], r["world_size"]) == (0, 1) for r in steps)
    assert [v["step"] for v in views] == [3, 6]
    assert all(v["world_size"] == 1 and len(v["duty_cycle"]) == 1
               for v in views)
    assert telemetry.counters()["fleet.exchange"] == 2
    text = tfleet.prometheus_text()
    assert "mxt_fleet_rank 0" in text and "mxt_fleet_step 6" in text


def test_halt_dump_rate_limit_and_metrics_endpoint(tmp_path, monkeypatch):
    from mxnet_tpu_torch import telemetry

    _, tfleet = _fleets()
    monkeypatch.setenv("MXNET_FLEET_DUMP", str(tmp_path / "fd.{rank}.json"))
    telemetry.enable(memory=False, cost=False)
    tfleet.enable(stride=100, halt=True, http_port=0)
    url = tfleet.metrics_url()
    telemetry.step_begin()
    with pytest.raises(tfleet.WatchdogHalt, match="nan_loss"):
        telemetry.step_end(loss=float("nan"))
    doc = json.loads((tmp_path / "fd.0.json").read_text())
    assert doc["reason"] == "watchdog_halt" and doc["kind"] == "fleet"
    assert any(r.get("kind") == "nan_loss" for r in doc["records"])
    # rate-limited per reason, never raising
    assert tfleet.incident("watchdog_halt") is None
    assert tfleet.incident("other", path=str(tmp_path / "x" / "y.json")) \
        is None
    health = urllib.request.urlopen(url + "/metrics")
    assert health.status == 200
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(url + "/healthz")
    assert ei.value.code == 503
    tfleet.disable()
    assert tfleet.metrics_url() is None
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_drain_dump_is_read_by_the_reference_report(tmp_path, monkeypatch,
                                                    capsys):
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import checkpoint, gluon, nd, telemetry
    from mxnet_tpu_torch.gluon import trainer as trainer_mod

    _, tfleet = _fleets()
    tmpl = str(tmp_path / "drain.rank{rank}.json")
    monkeypatch.setenv("MXNET_FLEET_DUMP", tmpl)
    telemetry.enable(memory=False, cost=False)
    tfleet.enable(stride=2)
    net = gluon.nn.Dense(2)
    net.initialize(ctx=tmx.cpu())
    net(nd.ones((1, 3), ctx=tmx.cpu()))
    for _ in range(6):
        telemetry.step_begin()
        telemetry.count("trainer.allreduce_wait_ms", 1.0)
        telemetry.step_end(examples=4, loss=0.25)
    with pytest.raises(SystemExit) as ei:
        checkpoint.drain_checkpoint_and_exit(str(tmp_path / "ck"), 6, net)
    assert ei.value.code == trainer_mod.PREEMPTED_EXIT_CODE
    path = tmpl.replace("{rank}", "0")
    doc = json.loads(open(path).read())
    assert doc["reason"] == "preemption_drain"
    assert doc["context"] == {"step": 6}
    fleet_report = _fleet_report()
    assert fleet_report.main([path]) == 0
    out = capsys.readouterr().out
    assert "fleet heatmap" in out
    assert "6 step, 3 fleet view, 0 anomaly" in out
    chrome_out = str(tmp_path / "tl.json")
    assert fleet_report.main([path, "--format", "chrome",
                              "--out", chrome_out]) == 0
    tl = json.loads(open(chrome_out).read())
    assert sum(1 for e in tl["traceEvents"] if e["ph"] == "X") == 6


def test_oom_postmortem_embeds_recent_steps(tmp_path):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import memwatch

    _, tfleet = _fleets()
    telemetry.enable(memory=False, cost=False)
    tfleet.enable(stride=100)
    for _ in range(3):
        telemetry.step_begin()
        telemetry.step_end(loss=1.0)
    path = memwatch.write_postmortem(path=str(tmp_path / "oom.json"),
                                     context="test", error="OOM")
    report = json.loads(open(path).read())
    assert [r["step"] for r in report["recent_steps"]] == [1, 2, 3]


def test_a_retrace_trips_the_fleet_flight_recorder(tmp_path, monkeypatch):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import retrace

    _, tfleet = _fleets()
    monkeypatch.setenv("MXNET_FLEET_DUMP", str(tmp_path / "fd.json"))
    telemetry.enable(memory=False, cost=False, retrace="warn")
    tfleet.enable(stride=100)
    retrace.observe("site", 1, {"shape": (2,)})
    retrace.warm()
    assert not (tmp_path / "fd.json").exists()
    with pytest.warns(RuntimeWarning):
        retrace.observe("site", 1, {"shape": (3,)})
    doc = json.loads((tmp_path / "fd.json").read_text())
    assert doc["reason"] == "retrace"
    assert doc["context"]["diff"]
    retrace.disable()
    retrace.reset()


# --- the numerics fleet cases of tests/test_numerics.py ---------------------------

def test_nan_injected_at_layer1_attributed_with_rank(tmp_path):
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import nd, telemetry
    from mxnet_tpu_torch.models import llama
    from mxnet_tpu_torch.telemetry import numerics

    _, tfleet = _fleets()
    cpu = tmx.cpu()
    telemetry.enable(memory=False, cost=False)
    tfleet.enable(stride=1, on_anomaly=lambda e: None)
    numerics.enable(stride=1)
    net = llama.llama_tiny()
    net.initialize(tmx.init.Xavier(), ctx=cpu)
    victim = next(iter(net.model.layers[1].collect_params().values()))
    host = victim.data().asnumpy()
    host.flat[0] = float("nan")
    victim.set_data(nd.array(host, ctx=cpu))
    with telemetry.step(examples=2):
        net(nd.array(np.ones((2, 8), dtype="int32"), ctx=cpu))
    evt = [r for r in tfleet.recent() if r.get("record") == "anomaly"
           and r.get("kind") == "nan_tensor"][-1]
    assert (evt["path"], evt["layer"], evt["rank"]) == ("decoder.1", 1, 0)
    assert evt["nan"] > 0
    assert telemetry.counters()["fleet.anomaly.nan_tensor"] >= 1
    assert tfleet.last_view()["first_nan_layer"] == [1]
    doc = json.loads(open(tfleet.dump(str(tmp_path / "fd.json"),
                                      reason="test")).read())
    dumped = [r for r in doc["records"] if r.get("kind") == "nan_tensor"]
    assert dumped[-1]["path"] == "decoder.1"


def test_watchdog_grad_norm_explosion_and_numerics_fallback():
    jfleet, tfleet = _fleets()
    got = {}
    for name, fl in (("jax", jfleet), ("torch", tfleet)):
        wd = fl.Watchdog(consecutive=3, growth_factor=2.0, min_history=100)
        fired = [wd.observe_step({"grad_norm": gn})
                 for gn in (1.0, 3.0, 9.0, 27.0)]
        wd2 = fl.Watchdog(consecutive=2, growth_factor=2.0,
                          min_history=100)
        fallback = [wd2.observe_step({"numerics": {"grad_norm": gn,
                                                   "first_nan": None}})
                    for gn in (1.0, 3.0, 9.0)]
        got[name] = (fired, fallback)
    assert got["torch"] == got["jax"]
    fired, fallback = got["torch"]
    assert fired[:3] == [[], [], []]
    assert fired[3][0]["kind"] == "grad_norm_explosion"
    assert fired[3][0]["windows"] == 3
    assert any(a["kind"] == "grad_norm_explosion" for a in fallback[2])
    assert not math.isnan(fired[3][0]["value"])

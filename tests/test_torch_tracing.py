"""Request tracing and the flight recorder of the port
(``telemetry.tracing``, ``serving.metrics``) against the reference's.

The reference's nine ``tests/test_tracing.py`` cases run against the
port: the ``Trace`` object, the inert disabled path, the SLO goodput
arithmetic (equal in both packages), the Prometheus text (equal in both
packages for the same recorded state), one connected span tree per
request across the three serving threads of an in-process dp = 2 server
with ``/metrics``, ``/healthz`` and ``/requests`` live, the flight dumps
on a replica failure and on overload, the OOM post-mortem's traces, and
the reference's ``tools/trace_report.py`` reading the port's stream and
dumps.

Beyond them: an overloaded server (``queue_capacity=2``, 16 submits)
writes exactly one dump, holding the recent traces, and only where the
environment says; and on 2-rank gloo groups at tp = 2 and dp = 2 every
request has exactly one trace and one completion record, tagged with
its replica, a tensor-parallel follower emits nothing per request, and
the ``serving.completed|replica=<i>`` counters sum to the requests.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import spawn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [np.random.RandomState(5).randint(1, 250, size=n)
           for n in (5, 9, 12, 7)]


def _config(serving, **kw):
    return serving.ServerConfig(max_batch=2, max_length=64, min_length=8,
                                num_slots=2, **kw)


def _worker(tmp):
    """One rank of a 2-rank gloo group (no JAX): a tp = 2 replica (rank 0
    leads, rank 1 follows) and then two dp replicas, one a rank, each
    with tracing on and a JSONL stream of its own."""
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import parallel, serving, telemetry
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.models import llama

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)
    r = parallel.rank()
    net = llama.llama_tiny()
    load_numpy_params(net, dict(np.load(tmp / "weights.npz")), ctx=cpu)
    out = {}
    for name, shape in (("tp2", {"tp": 2}), ("dp2", {"dp": 2})):
        telemetry.enable(jsonl_path=str(tmp / f"{name}.rank{r}.jsonl"),
                         memory=False, cost=False, trace=True)
        mesh = parallel.make_mesh(shape)
        srv = serving.GenerativeServer(net, _config(serving), mesh=mesh)
        with srv:
            if srv.serves_requests:
                dp = mesh.get_local_rank("dp") if "dp" in shape else 0
                mine = [i for i in range(len(PROMPTS))
                        if i % shape.get("dp", 1) == dp]
                futs = {i: srv.submit(PROMPTS[i], max_new_tokens=4)
                        for i in mine}
                for i, f in futs.items():
                    out[f"{name}.reply{i}"] = f.result(120)
        out[name + ".counters"] = json.dumps(telemetry.counters())
        telemetry.disable()
        telemetry.tracing.clear()
    parallel.set_mesh(None)
    np.savez(tmp / f"rank{r}.npz", **out)


@pytest.fixture(autouse=True)
def _clean():
    yield
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import tracing

    telemetry.disable()
    telemetry.reset()
    tracing.disable()
    tracing.clear()


def _telemetry_on():
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry.sinks import ListSink

    telemetry.enable(memory=False, cost=False, trace=True)
    sink = ListSink()
    telemetry.add_sink(sink)
    return sink


def _trace_report():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import trace_report
    return trace_report


def _tiny_net():
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.models.llama import llama_tiny

    net = llama_tiny()
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    return net


def _assert_connected_tree(t, decode_steps=2):
    names = [s["name"] for s in t["spans"]]
    for need in ("queue", "prefill", "handoff", "evict", "request"):
        assert need in names, names
    assert names.count("decode.step") >= decode_steps
    ids = {s["id"] for s in t["spans"]}
    roots = [s for s in t["spans"] if s["parent"] is None]
    assert len(roots) == 1 and roots[0]["name"] == "request"
    assert all(s["parent"] in ids for s in t["spans"]
               if s["parent"] is not None)


# --- unit: the Trace object -----------------------------------------------------

def test_trace_structure_and_finish_record():
    from mxnet_tpu_torch.telemetry import tracing

    tracing.enable()
    tr = tracing.start_trace(request_id=7, tenant="acme")
    assert tr is not None and tr.request_id == 7
    t0 = time.perf_counter()
    sid = tr.add("queue", t0, t0 + 0.001)
    tr.add("prefill", t0 + 0.001, t0 + 0.002, parent=sid, replica=0)
    tr.event("evict", slot=3)
    with tr.span("extra"):
        pass
    rec = tracing.finish(tr, status="ok", lane="decode")
    assert rec["record"] == "trace" and rec["tenant"] == "acme"
    spans = rec["spans"]
    assert [s["name"] for s in spans] == \
        ["queue", "prefill", "evict", "extra", "request"]
    root = spans[-1]
    assert root["id"] == tr.root_id and root["parent"] is None
    assert root["tags"] == {"lane": "decode"}
    by_name = {s["name"]: s for s in spans}
    assert by_name["queue"]["parent"] == root["id"]
    assert by_name["prefill"]["parent"] == sid
    assert by_name["evict"]["dur_ms"] == 0.0
    assert tracing.recent()[-1]["trace_id"] == rec["trace_id"]
    assert tracing.RECORDER_CAPACITY == 64


def test_tracing_disabled_is_inert(tmp_path):
    from mxnet_tpu_torch.telemetry import tracing

    tracing.disable()
    tracing.clear()
    assert tracing.start_trace(request_id=1) is None
    assert tracing.finish(None) is None
    assert tracing.incident("overload_rejection",
                            path=str(tmp_path / "f.json")) is None
    assert tracing.recent() == []
    assert not (tmp_path / "f.json").exists()


# --- unit: SLO goodput and the Prometheus text, equal in both packages ---------

def _slo_run(SLOTracker):
    s = SLOTracker({"ttft_ms": 100.0, "tpot_ms": 10.0}, window=4)
    out = [s.target_for(None)]
    for ttft, tpot in ((50.0, 5.0), (150.0, 5.0), (50.0, 50.0)):
        out.append(s.observe(ttft_ms=ttft, tpot_ms=tpot))
    out.append(s.goodput())
    for _ in range(4):
        s.observe(ttft_ms=1.0, tpot_ms=1.0)
    out.append(s.snapshot())
    m = SLOTracker({"default": {"ttft_ms": 10.0}, "gold": {"ttft_ms": 1.0}})
    out += [m.observe(tenant="gold", ttft_ms=5.0),
            m.observe(tenant="bronze", ttft_ms=5.0),
            m.observe(tenant="gold", tpot_ms=99.0), m.goodput("gold"),
            m.goodput("nobody"), m.snapshot()]
    return out


def test_slo_tracker_goodput_math():
    from mxnet_tpu.serving.metrics import SLOTracker as JSLO
    from mxnet_tpu_torch.serving.metrics import SLOTracker

    got = _slo_run(SLOTracker)
    assert got == _slo_run(JSLO)
    snap = got[5]["tenants"]["default"]
    assert snap["window_goodput"] == 1.0
    assert snap["total"] == 7 and snap["goodput"] == pytest.approx(5 / 7)
    assert got[4] == pytest.approx(1 / 3)


def _prom(tel, prometheus_text):
    tel.enable(memory=False, cost=False)
    try:
        tel.count("serving.completed", 3)
        tel.count("serving.completed|replica=1", 2)
        for v in (4.0, 8.0, 1.5, 3.25):
            tel.hist("serving.ttft_ms|replica=1", v)
        tel.hist("serving.tpot_ms", 0.1)
        tel.gauge("serving.kv_occupancy", 0.375)
        return prometheus_text(extra_gauges={"serving.queue_depth": 5,
                                             "9lives": 1e20})
    finally:
        tel.disable()
        tel.reset()


def test_prometheus_text_labels_and_types():
    from mxnet_tpu import telemetry as jtel
    from mxnet_tpu.serving.metrics import prometheus_text as jprom
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving.metrics import prometheus_text

    txt = _prom(telemetry, prometheus_text)
    assert txt == _prom(jtel, jprom)
    lines = txt.strip().splitlines()
    for ln in lines:
        if ln.startswith("#"):
            assert ln.startswith("# TYPE mxt_")
            continue
        name, value = ln.rsplit(" ", 1)
        float(value)
        assert name.startswith("mxt_")
    assert "mxt_serving_completed_total 3" in lines
    assert 'mxt_serving_completed_total{replica="1"} 2' in lines
    assert "mxt_serving_queue_depth 5" in lines
    assert 'mxt_serving_ttft_ms{quantile="0.5",replica="1"} 3.25' in lines
    assert 'mxt_serving_ttft_ms_count{replica="1"} 4' in lines
    assert telemetry.promtext.prometheus_text is prometheus_text


# --- acceptance: one trace across the three lane threads (dp2) -------------------

def test_generative_trace_tree_metrics_endpoint_dp2():
    """Two replicas in this process: one connected span tree per request
    (queue → prefill → handoff → decode steps → evict) over at least two
    threads; the live scrape parses and agrees with ``stats()``;
    ``/healthz`` and ``/requests`` answer; the reference's
    ``trace_report.py`` rebuilds the tree and the chrome trace."""
    from mxnet_tpu_torch import serving, telemetry

    trace_report = _trace_report()
    net = _tiny_net()
    cfg = _config(serving, summary_every=4, http_port=0,
                  slo={"acme": {"ttft_ms": 1e6, "tpot_ms": 1e6}})
    sink = _telemetry_on()
    srv = serving.GenerativeServer(net, cfg, mesh={"dp": 2})
    with srv:
        url = srv.metrics_url
        assert url is not None and url.startswith("http://127.0.0.1:")
        futs = [srv.submit(p, max_new_tokens=6, tenant="acme")
                for p in PROMPTS]
        for f in futs:
            f.result(120)
        mtxt = urllib.request.urlopen(url + "/metrics").read().decode()
        health = json.loads(urllib.request.urlopen(url + "/healthz").read())
        reqs = json.loads(urllib.request.urlopen(url + "/requests").read())
        stats = srv.stats()
    assert srv.metrics_url is None   # the endpoint stops with the server
    assert not [t for t in threading.enumerate()
                if t.name == "mxt-metrics"]

    traces = [r for r in sink.records if r.get("record") == "trace"]
    assert len(traces) == 4
    for t in traces:
        assert t["status"] == "ok" and t["tenant"] == "acme"
        _assert_connected_tree(t)
        assert len({s["thread"] for s in t["spans"]}) >= 2
        pre = next(s for s in t["spans"] if s["name"] == "prefill")
        assert pre["tags"]["replica"] in (0, 1)
        assert "slot" in pre["tags"] and "kv_blocks" in pre["tags"]
        step = next(s for s in t["spans"] if s["name"] == "decode.step")
        assert step["tags"]["batch"] >= 1
    recs = [r for r in sink.records if r.get("record") == "serving.request"]
    assert len(recs) == 4
    for r in recs:
        assert r["status"] == "ok" and r["lane"] == "decode"
        assert r["replica"] in (0, 1)
        assert r["trace_id"] in {t["trace_id"] for t in traces}
        assert r["tpot_ms"] > 0 and r["ttft_ms"] > 0
        assert r["slo_met"] is True
    hists = telemetry.hists()
    assert "serving.ttft_ms" in hists and "serving.tpot_ms" in hists
    assert any(h.startswith("serving.ttft_ms|replica=") for h in hists)

    lines = [ln for ln in mtxt.splitlines() if ln]
    for ln in lines:
        if not ln.startswith("#"):
            float(ln.rsplit(" ", 1)[1])
    done = next(ln for ln in lines
                if ln.startswith("mxt_serving_completed_total "))
    assert int(float(done.rsplit(" ", 1)[1])) == stats["completed"] == 4
    assert any(ln.startswith("mxt_serving_kv_occupancy") for ln in lines)
    assert any('tenant="acme"' in ln for ln in lines)
    assert health["status"] == "ok" and len(health["replicas"]) == 2
    for rep in health["replicas"]:
        assert rep["prefill_alive"] and rep["decode_alive"]
    assert isinstance(reqs, list)
    slo = stats["slo"]["tenants"]["acme"]
    assert slo["total"] == 4 and slo["window_goodput"] == 1.0

    t = traces[0]
    text = trace_report.render_tree(t)
    assert t["trace_id"] in text and "decode.step" in text
    roots = trace_report.build_tree(t)
    assert len(roots) == 1
    assert {c["span"]["name"] for c in roots[0]["children"]} >= \
        {"queue", "prefill", "handoff", "decode.step", "evict"}
    chrome = trace_report.chrome_trace(traces)
    evs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert len(evs) == sum(len(t["spans"]) for t in traces)
    assert all(e["dur"] >= 0 and "trace_id" in e["args"] for e in evs)


def test_in_flight_shows_trace_ids_while_decoding():
    from mxnet_tpu_torch import serving

    net = _tiny_net()
    _telemetry_on()
    srv = serving.GenerativeServer(net, _config(serving))
    seen = []
    with srv:
        futs = [srv.submit(p, max_new_tokens=24) for p in PROMPTS[:2]]
        deadline = time.time() + 60
        while time.time() < deadline and not seen:
            seen = [r for r in srv.in_flight() if r["state"] == "decoding"]
        [f.result(120) for f in futs]
    assert seen and all(r["trace_id"] for r in seen)


# --- the flight recorder -----------------------------------------------------------

def test_flight_recorder_dump_on_replica_failure(tmp_path, monkeypatch):
    from mxnet_tpu_torch import serving

    dump_path = tmp_path / "flight.json"
    monkeypatch.setenv("MXNET_TRACE_DUMP", str(dump_path))
    net = _tiny_net()
    sink = _telemetry_on()
    srv = serving.GenerativeServer(net, _config(serving,
                                                summary_every=1 << 30))
    with srv:
        srv.generate(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)

        def boom(*a, **k):
            raise RuntimeError("injected prefill failure")

        monkeypatch.setattr(srv.replicas[0].engine, "prefill_rows", boom)
        fut = srv.submit(np.arange(1, 8, dtype=np.int32), max_new_tokens=2)
        with pytest.raises(RuntimeError, match="injected"):
            fut.result(60)
    report = json.loads(dump_path.read_text())
    assert report["record"] == "flight_recorder"
    assert report["reason"] == "replica_exception"
    assert report["context"]["lane"] == "prefill"
    assert report["context"]["replica"] == 0
    assert len(report["traces"]) >= 1
    errs = [r for r in sink.records if r.get("record") == "serving.request"
            and r.get("status") == "error"]
    assert len(errs) == 1
    assert errs[0]["lane"] == "prefill" and errs[0]["replica"] == 0
    assert "injected" in errs[0]["error"]
    bad = [t for t in sink.records if t.get("record") == "trace"
           and t.get("status") == "error"]
    assert len(bad) == 1
    assert srv.replicas[0].failed == 1


def test_flight_recorder_dump_on_overload(tmp_path, monkeypatch):
    """The overloaded server of section C: ``queue_capacity=2`` and 16
    submits against a blocked model write exactly one dump (an overload
    storm is one report), holding the recent traces, in the directory
    the environment names; each rejection is a tagged record with its
    sealed trace."""
    from mxnet_tpu_torch import serving, telemetry

    dump_path = tmp_path / "flight.json"
    monkeypatch.setenv("MXNET_TRACE_DUMP", str(dump_path))
    gate = threading.Event()
    gate.set()

    def model(batch):
        gate.wait(30)
        return [batch["data"]]

    sink = _telemetry_on()
    cfg = serving.ServerConfig(max_batch=1, max_length=16, min_length=8,
                               queue_capacity=2, batch_window_ms=0.0)
    srv = serving.InferenceServer(model, cfg)
    rejected = 0
    with srv:
        for _ in range(2):     # two served requests fill the ring
            srv.infer(np.zeros((4, 3), np.float32))
        gate.clear()
        futs = []
        for _ in range(16):
            try:
                futs.append(srv.submit(np.zeros((4, 3), np.float32)))
            except serving.ServerOverloadedError:
                rejected += 1
        gate.set()
        [f.result(60) for f in futs]
    assert rejected >= 12
    assert os.listdir(tmp_path) == ["flight.json"]
    report = json.loads(dump_path.read_text())
    assert report["reason"] == "overload_rejection"
    assert report["context"]["queue_capacity"] == 2
    assert len(report["traces"]) >= 2
    assert all(t["status"] == "ok" for t in report["traces"][:2])
    rej = [r for r in sink.records if r.get("record") == "serving.request"
           and r.get("status") == "rejected"]
    assert len(rej) == rejected
    assert all(r["lane"] == "queue" and "trace_id" in r for r in rej)
    sealed = [t for t in sink.records if t.get("record") == "trace"
              and t.get("status") == "rejected"]
    assert len(sealed) == rejected
    assert telemetry.counters().get("tracing.flight_dump") == 1
    assert telemetry.counters().get("serving.rejected") == rejected


def test_stateless_server_traces_and_summaries():
    """``InferenceServer``: a ``queue`` and a ``batch`` span a request
    and the ``serving.latency`` summary with the reference's keys every
    ``summary_every`` completions."""
    from mxnet_tpu_torch import serving

    sink = _telemetry_on()
    cfg = serving.ServerConfig(max_batch=2, max_length=16, min_length=8,
                               summary_every=2)
    with serving.InferenceServer(lambda b: [b["data"] * 2], cfg) as srv:
        futs = [srv.submit(np.full((4, 3), i, np.float32))
                for i in range(4)]
        outs = [f.result(30) for f in futs]
    # the rows past the true length are the bucket's padding
    assert all(np.all(o[:4] == 2 * i) for i, o in enumerate(outs))
    traces = [r for r in sink.records if r.get("record") == "trace"]
    assert len(traces) == 4
    for t in traces:
        assert [s["name"] for s in t["spans"]] == ["queue", "batch",
                                                   "request"]
    sums = [r for r in sink.records if r.get("record") == "serving.latency"]
    assert [s["completed"] for s in sums] == [2, 4]
    ref_keys = {"record", "completed", "failed", "batches", "rejected",
                "queue_wait_ms", "total_ms", "ttft_ms", "batch_size"}
    assert all(set(s) == ref_keys for s in sums)


def test_memwatch_postmortem_embeds_recent_traces(tmp_path):
    from mxnet_tpu_torch.telemetry import memwatch, tracing

    tracing.enable()
    tr = tracing.start_trace(request_id=9)
    tracing.finish(tr, status="ok")
    path = memwatch.write_postmortem(path=str(tmp_path / "oom.json"),
                                     context="test",
                                     error="CUDA out of memory")
    report = json.loads(open(path).read())
    assert [t["request_id"] for t in report["recent_traces"]] == [9]


def test_trace_report_cli_roundtrip(tmp_path):
    """The reference's ``trace_report.py`` reads the port's JSONL stream
    and its flight dump, selects by trace and request id, and its CLI
    renders the tree and the chrome trace."""
    from mxnet_tpu_torch.telemetry import tracing

    trace_report = _trace_report()
    sink = _telemetry_on()
    for rid in (1, 2):
        tr = tracing.start_trace(request_id=rid)
        t0 = time.perf_counter()
        tr.add("queue", t0, t0 + 0.001)
        tr.add("decode.step", t0 + 0.001, t0 + 0.002, step=1)
        tracing.finish(tr, status="ok")
    stream = tmp_path / "stream.jsonl"
    with open(stream, "w") as f:
        for r in sink.records:
            f.write(json.dumps(r) + "\n")
    dump = tracing.dump(path=str(tmp_path / "dump.json"), reason="test")
    got = trace_report.load_traces(str(stream))
    assert [t["request_id"] for t in got] == [1, 2]
    assert [t["request_id"] for t in trace_report.load_traces(dump)] == \
        [1, 2]
    tid = got[0]["trace_id"]
    assert [t["trace_id"] for t in
            trace_report.select(got, trace_id=tid)] == [tid]
    assert [t["request_id"] for t in
            trace_report.select(got, request_id=2)] == [2]
    tool = os.path.join(REPO, "tools", "trace_report.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, tool, str(stream), "--trace-id",
                          tid], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0 and tid in out.stdout
    chrome_out = tmp_path / "chrome.json"
    out = subprocess.run([sys.executable, tool, str(stream), "--format",
                          "chrome", "--out", str(chrome_out)],
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0
    doc = json.loads(chrome_out.read_text())
    assert {e["ph"] for e in doc["traceEvents"]} == {"M", "X"}


# --- one request, one trace, on every replica layout (gloo) ------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import mxnet_tpu as jmx
    from mxnet_tpu.models import llama as jllama

    net = jllama.llama_tiny()
    net.initialize(jmx.init.Xavier())
    weights = {k: p.data().asnumpy()
               for k, p in net._collect_params_with_prefix().items()}
    tmp = tmp_path_factory.mktemp("tracing2")
    np.savez(tmp / "weights.npz", **weights)
    return tmp, spawn(2, tmp, __file__, timeout=200)


@pytest.mark.parametrize("layout", ["tp2", "dp2"])
def test_one_trace_and_one_record_per_request(ranks, layout):
    from mxnet_tpu_torch.telemetry.sinks import read_jsonl

    tmp, outs = ranks
    streams = [read_jsonl(str(tmp / f"{layout}.rank{r}.jsonl"))
               for r in range(2)]
    traces = [[x for x in s if x.get("record") == "trace"]
              for s in streams]
    recs = [[x for x in s if x.get("record") == "serving.request"]
            for s in streams]
    if layout == "tp2":
        # the leader (rank 0) traces every request; its follower nothing
        assert len(traces[0]) == len(recs[0]) == len(PROMPTS)
        assert traces[1] == [] and recs[1] == []
        assert all(r["replica"] == 0 for r in recs[0])
    else:
        # one replica a rank, each request on the rank that took it
        assert [len(t) for t in traces] == [2, 2]
        assert [len(r) for r in recs] == [2, 2]
        for rank, rs in enumerate(recs):
            assert {r["replica"] for r in rs} == {rank}
    all_traces = traces[0] + traces[1]
    all_recs = recs[0] + recs[1]
    assert len({t["trace_id"] for t in all_traces}) == len(PROMPTS)
    assert sorted(r["trace_id"] for r in all_recs) == \
        sorted(t["trace_id"] for t in all_traces)
    for t in all_traces:
        _assert_connected_tree(t)
    done = 0
    for o in outs:
        counters = json.loads(str(o[layout + ".counters"]))
        done += sum(v for k, v in counters.items()
                    if k.startswith("serving.completed|replica="))
    assert done == len(PROMPTS)
    replies = {i: o[f"{layout}.reply{i}"] for o in outs
               for i in range(len(PROMPTS)) if f"{layout}.reply{i}" in o}
    assert sorted(replies) == list(range(len(PROMPTS)))

"""The serving observability surface of the port against the reference's.

* ``ServerConfig``'s five keywords (``summary_every``, ``http_port``,
  ``http_host``, ``slo``, ``slo_window``) take the reference's defaults
  and each has its effect.
* ``/metrics`` over HTTP parses as Prometheus text and agrees with
  ``stats()``; ``MetricsServer.stop()`` joins its thread and frees its
  port.
* The replicas' ``emit_summary`` records carry the reference's keys.
* Trap 2: with the numerics tier on, the engine's decode and verify
  programs also return ``stats_of(logits)`` (inside the graphed tick on
  a card); one program a mode, keyed apart; the tokens are bit-equal
  with observability on and off, the same requests submitted in one
  batch; the harvested ``serving.logits`` bundle is finite and equals
  the reference's statistics of the same logits.
* Trap 1: a decode tick's stamps close after the host has the tick's
  tokens, so the ``decode.step`` spans and the capacity ledger cover
  the work behind the tick (simulated here by a slow step).
"""
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models.llama import llama_tiny
from mxnet_tpu_torch.telemetry import capacity, numerics, tracing
from mxnet_tpu_torch.telemetry.sinks import ListSink

CPU = tmx.cpu()
PROMPTS = [np.random.RandomState(5).randint(1, 250, size=n)
           for n in (5, 9, 12, 7)]


@pytest.fixture(autouse=True)
def _clean():
    yield
    telemetry.disable()
    telemetry.reset()
    tracing.disable()
    tracing.clear()
    numerics.clear()
    capacity.disable()


@pytest.fixture(scope="module")
def weights():
    from mxnet_tpu.models import llama as jllama

    net = jllama.llama_tiny()
    net.initialize(jmx.init.Xavier())
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def net(weights):
    n = llama_tiny()
    load_numpy_params(n, weights, ctx=CPU)
    return n


def _config(**kw):
    return serving.ServerConfig(max_batch=4, max_length=64, min_length=8,
                                num_slots=4, **kw)


def _serve_together(srv, new=6):
    """Every prompt submitted at once (one prefill batch), the replies."""
    with srv:
        futs = [srv.submit(p, max_new_tokens=new) for p in PROMPTS]
        return [f.result(120) for f in futs]


# --- ServerConfig ------------------------------------------------------------------

def test_server_config_keywords_take_the_reference_defaults():
    from mxnet_tpu.serving import ServerConfig as JConfig

    jc, tc = JConfig(), serving.ServerConfig()
    for kw in ("summary_every", "http_port", "http_host", "slo",
               "slo_window"):
        assert getattr(tc, kw) == getattr(jc, kw), kw
    assert (tc.summary_every, tc.http_port, tc.http_host, tc.slo,
            tc.slo_window) == (32, None, "127.0.0.1", None, 256)


def test_each_keyword_has_its_effect(net):
    sink = ListSink()
    telemetry.enable(memory=False, cost=False)
    telemetry.add_sink(sink)
    cfg = _config(summary_every=2, http_port=0, http_host="127.0.0.1",
                  slo={"gold": {"ttft_ms": 1e6}, "default": {"ttft_ms": 0}},
                  slo_window=3)
    srv = serving.GenerativeServer(net, cfg)
    assert srv.metrics_url is None          # not started
    with srv:
        url = srv.metrics_url
        assert url.startswith("http://127.0.0.1:")
        futs = [srv.submit(p, max_new_tokens=3,
                           tenant="gold" if i % 2 else None)
                for i, p in enumerate(PROMPTS)]
        [f.result(120) for f in futs]
        stats = srv.stats()
    slo = stats["slo"]
    assert slo["window"] == 3
    assert slo["tenants"]["gold"]["goodput"] == 1.0
    assert slo["tenants"]["default"]["goodput"] == 0.0
    sums = [r for r in sink.records if r.get("record") == "serving.latency"]
    assert [s["completed"] for s in sums] == [2, 4]
    off = serving.GenerativeServer(net, _config())
    with off:
        assert off.metrics_url is None and off.slo is None


# --- /metrics over HTTP --------------------------------------------------------------

def _parse(text):
    """Prometheus text → {sample name with labels: value}; every line
    either a ``# TYPE`` comment or ``name{labels} value``."""
    out = {}
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("#"):
            assert ln.startswith("# TYPE mxt_")
            continue
        name, value = ln.rsplit(" ", 1)
        out[name] = float(value)
    return out


def test_metrics_endpoint_agrees_with_stats_and_stops_clean(net):
    telemetry.enable(memory=False, cost=False, capacity=True)
    srv = serving.GenerativeServer(net, _config(http_port=0,
                                                slo={"ttft_ms": 1e6}))
    with srv:
        port = int(srv.metrics_url.rsplit(":", 1)[1])
        _ = [f.result(120) for f in
             [srv.submit(p, max_new_tokens=3) for p in PROMPTS]]
        scrape = _parse(urllib.request.urlopen(
            srv.metrics_url + "/metrics").read().decode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.metrics_url + "/nope")
        assert ei.value.code == 404
        stats = srv.stats()
    assert scrape["mxt_serving_completed_total"] == stats["completed"] == 4
    assert scrape['mxt_serving_completed_total{replica="0"}'] == 4
    assert scrape["mxt_serving_queue_depth"] == 0
    assert scrape['mxt_serving_goodput{tenant="default"}'] == 1.0
    assert 'mxt_serving_utilization{replica="0"}' in scrape
    assert scrape['mxt_serving_ttft_ms_count{replica="0"}'] == 4
    # the endpoint's thread is joined and its port is free again
    assert not [t for t in threading.enumerate() if t.name == "mxt-metrics"]
    with socket.socket() as s:
        # the listener is closed (the scrape's own connection may linger
        # in TIME_WAIT, which a reusing bind ignores, as the server's does)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))


def test_metrics_server_renders_an_owner_without_a_server():
    """``MetricsServer`` is owner-agnostic: ``health()``, ``in_flight()``
    and optional ``metrics_gauges()`` and ``slo``; 503 when degraded."""
    from mxnet_tpu_torch.serving.metrics import MetricsServer, SLOTracker

    class Owner:
        slo = SLOTracker({"ttft_ms": 5.0})
        status = "degraded"

        def health(self):
            return {"status": self.status}

        def in_flight(self):
            return [{"request_id": 1, "trace_id": "t-1"}]

        def metrics_gauges(self):
            return {"serving.queue_depth": 3}

    owner = Owner()
    owner.slo.observe(ttft_ms=1.0)
    ms = MetricsServer(owner, port=0).start()
    try:
        text = urllib.request.urlopen(ms.url + "/metrics").read().decode()
        assert _parse(text) == {"mxt_serving_queue_depth": 3.0,
                                'mxt_serving_goodput{tenant="default"}':
                                1.0}
        assert json.loads(urllib.request.urlopen(
            ms.url + "/requests").read()) == owner.in_flight()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(ms.url + "/healthz")
        assert ei.value.code == 503
        owner.status = "saturated"
        assert urllib.request.urlopen(ms.url + "/healthz").status == 200
    finally:
        ms.stop()
    assert ms.url is None and ms.port is None


# --- emit_summary ----------------------------------------------------------------------

def test_replica_summaries_carry_the_reference_keys(net, weights):
    from mxnet_tpu import serving as jserving, telemetry as jtel
    from mxnet_tpu.models import llama as jllama
    from mxnet_tpu.telemetry.sinks import ListSink as JSink

    keys = {}
    for name, srv_mod, tel, sink_cls, n in (
            ("torch", serving, telemetry, ListSink, net),
            ("jax", jserving, jtel, JSink, None)):
        if n is None:
            n = jllama.llama_tiny()
            n.initialize()
            for k, p in n._collect_params_with_prefix().items():
                p.set_data(jmx.nd.array(weights[k]))
        sink = sink_cls()
        tel.enable(memory=False, cost=False, capacity=True)
        tel.add_sink(sink)
        cfg = srv_mod.ServerConfig(max_batch=4, max_length=64,
                                   min_length=8, num_slots=4,
                                   summary_every=4, radix_cache=True)
        with srv_mod.GenerativeServer(n, cfg) as srv:
            [f.result(120) for f in
             [srv.submit(p, max_new_tokens=3) for p in PROMPTS]]
        tel.disable()
        sums = [r for r in sink.records
                if r.get("record") == "serving.latency"]
        assert len(sums) == 1, name
        keys[name] = (set(sums[0]), set(sums[0]["capacity"]),
                      set(sums[0]["kv_cache"]))
        reqs = [r for r in sink.records
                if r.get("record") == "serving.request"]
        keys[name + ".request"] = set().union(*map(set, reqs))
    assert keys["torch"] == keys["jax"]
    assert keys["torch.request"] == keys["jax.request"]


# --- trap 2: the serving numerics taps --------------------------------------------------

def test_tokens_are_bit_equal_with_observability_on_and_off(net):
    off = _serve_together(serving.GenerativeServer(net, _config()))
    sink = ListSink()
    telemetry.enable(memory=False, cost=False, trace=True, capacity=True,
                     numerics=True, retrace="raise")
    telemetry.add_sink(sink)
    srv = serving.GenerativeServer(net, _config(http_port=0,
                                                slo={"ttft_ms": 1e6}))
    assert srv.engine._numerics is True
    assert srv.engine._step_key[-1] == "numerics"
    on = _serve_together(srv)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    summary = numerics.step_summary(0)
    st = summary["tensors"]["serving.logits"]
    assert st["nan"] == 0 and st["inf"] == 0 and st["l2"] > 0
    assert telemetry.retrace.violations() == []
    assert telemetry.counters()["serving.engine_compile"] >= 2


def test_one_program_a_numerics_mode(net):
    """The mode is fixed when the engine is built: a graph captured (on a
    card) in one mode never replays in the other, so each mode keys its
    own step program; on and off the decode program's tokens agree."""
    from mxnet_tpu_torch.serving.generative import LlamaServingEngine

    eng_off = LlamaServingEngine(net, max_len=64, num_slots=2,
                                 kv_mode="paged")
    numerics.enable(stride=1)
    eng_on = LlamaServingEngine(net, max_len=64, num_slots=2,
                                kv_mode="paged")
    numerics.disable()
    assert eng_off._numerics is False and eng_on._numerics is True
    assert eng_on._step_key == eng_off._step_key + ("numerics",)
    state = eng_on._host_state()
    state[:, 0] = [3, 7]
    import torch

    t = torch.from_numpy(state)
    with torch.inference_mode():
        toks_on, stats = eng_on._step_program(t)
        toks_off = eng_off._step_program(t)
    assert torch.equal(toks_on, toks_off)
    assert stats.shape == (5,) and stats.dtype == torch.float64


def test_logit_stats_equal_the_reference_stats_of_the_same_logits(net):
    """The harvested bundle is ``stats_of`` of the decode program's
    logits: recomputed from the same logits with the reference's
    ``stats_of``, the numbers agree."""
    import torch

    from mxnet_tpu.telemetry import numerics as jnum
    from mxnet_tpu_torch.serving.generative import LlamaServingEngine

    numerics.enable(stride=1)
    eng = LlamaServingEngine(net, max_len=64, num_slots=2, kv_mode="paged")
    state = torch.from_numpy(eng._host_state())
    state[:, 0] = torch.tensor([3, 7])
    with torch.inference_mode():
        _, stats = eng._step_program(state)
        # the step writes its K/V rows first, so the same logits again
        logits = eng._dec._step_blocks_impl(eng._w, eng._pool,
                                            state[:, 2:], state[:, 0],
                                            state[:, 1])
    ref = jnum.stats_of(logits.numpy())
    want = np.array([float(ref[k]) for k in numerics.FIELDS])
    np.testing.assert_allclose(stats.numpy(), want, rtol=1e-5, atol=1e-6)


# --- trap 1: the tick's stamps bracket its work -------------------------------------------

def test_decode_stamps_close_after_the_tokens_reach_the_host(net,
                                                             monkeypatch):
    """A step whose tokens reach the host 30 ms after its launch (as a
    graphed tick's do on a card): every ``decode.step`` span and the
    ledger's busy intervals cover the 30 ms, with no sync added."""
    telemetry.enable(memory=False, cost=False, trace=True, capacity=True)
    sink = ListSink()
    telemetry.add_sink(sink)
    srv = serving.GenerativeServer(net, _config())
    eng = srv.engine
    real = eng.step

    def slow_step(active):
        out = real(active)
        time.sleep(0.03)          # the host read of the tokens
        return out

    monkeypatch.setattr(eng, "step", slow_step)
    _serve_together(srv, new=5)
    steps = [s for r in sink.records if r.get("record") == "trace"
             for s in r["spans"] if s["name"] == "decode.step"]
    assert steps and min(s["dur_ms"] for s in steps) >= 30.0
    rep = srv.replicas[0]
    assert min(rep.tick_ms) >= 30.0
    led = capacity._replicas[0].lanes["decode"]
    assert min(b - a for a, b in led._intervals) >= 0.03

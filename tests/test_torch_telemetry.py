"""The telemetry core of the PyTorch/CUDA port (``mxnet_tpu_torch.
telemetry``) against the JAX package's, on the CPU.

Mirrors ``tests/test_telemetry.py``: the disabled path is one boolean
(the null-singleton span, no lock, a bounded cost), spans nest and sum
into the step's phases, counters keep cumulative and per-step values,
the rolling histograms give the reference's nearest-rank percentiles,
recording is thread-safe, ``host_sync`` counts ``asnumpy`` and
``wait_to_read``, the JSONL records carry the reference's keys, spans and
op events share one chrome trace, the kvstore, the Trainer, step fusion,
the prefetcher and the checkpoints emit under the reference's names, and
``MXNET_TELEMETRY=1`` starts recording at import.  The added case runs
the same eager and hybridized tiny-Llama loop in both packages and holds
the records' key sets and counter keys equal, step by step.  Numbers
compared with the reference (percentiles, byte counts) are exact.  The
memory-budget keys (``remat_policy``, ``predicted_peak_bytes``,
``offload_bytes``), which the records carry once anything in the process
used the memory package, are held to the reference's too: every test
starts with both packages' memory state reset, and
``test_memory_budget_keys_match_the_reference`` sets them in both.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import memory as jmemory
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.models import llama as jllama
from mxnet_tpu_torch import autograd, gluon, memory, nd, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models import llama as tllama
from mxnet_tpu_torch.telemetry.sinks import ListSink

CPU = tmx.cpu()
BATCH = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset_memory():
    """Both packages' memory state as at import: no policy decision, no
    plan, nothing offloaded (other tests of the process may have set
    them)."""
    for mem in (memory, jmemory):
        mem.policy.reset()
        mem.planner.set_budget(None)
        mem.planner._last_plan = None
        mem.planner._last_prescription = None
        mem.offload.reset()


@pytest.fixture(autouse=True)
def _clean():
    for t in (telemetry, jtel):
        t.disable()
        t.reset()
        t.numerics.clear()
    _reset_memory()
    yield
    for t in (telemetry, jtel):
        t.disable()
        t.reset()
        t.numerics.clear()
    _reset_memory()


def _net(units=(8, 4), in_dim=6):
    net = gluon.nn.HybridSequential()
    for u in units[:-1]:
        net.add(gluon.nn.Dense(u, activation="relu"))
    net.add(gluon.nn.Dense(units[-1]))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net(nd.ones((1, in_dim), ctx=CPU))  # resolve deferred shapes
    return net


# --- disabled path ----------------------------------------------------------

def test_disabled_span_is_shared_null_singleton():
    assert not telemetry.is_enabled()
    s = telemetry.span("trainer.step")
    assert s is telemetry.span("anything.else")
    with s as inner:
        assert inner is s


class _PoisonLock:
    def __enter__(self):
        raise AssertionError("disabled telemetry path took the lock")

    def __exit__(self, *exc):
        return False

    acquire = __enter__


def test_disabled_recorders_never_lock_or_record(monkeypatch):
    monkeypatch.setattr(telemetry, "_lock", _PoisonLock())
    telemetry.count("cachedop.cache_miss", 3)
    telemetry.gauge("g", 1.0)
    telemetry.hist("h", 1.0)
    telemetry.step_begin()
    assert telemetry.step_end(examples=8) is None
    with telemetry.span("x"):
        pass
    with telemetry.step():
        pass
    assert telemetry.emit({"a": 1}) is None
    monkeypatch.undo()
    assert telemetry.counters() == {}
    assert telemetry.gauges() == {}


def test_disabled_overhead_bounded():
    """1e4 disabled span+count pairs are effectively free (the
    reference's bound)."""
    t0 = time.perf_counter()
    for _ in range(10_000):
        with telemetry.span("trainer.step"):
            telemetry.count("host_sync")
    assert time.perf_counter() - t0 < 0.5


# --- spans / counters / step records ----------------------------------------

def test_span_nesting_and_phase_accumulation():
    telemetry.enable()
    with telemetry.span("outer") as outer:
        assert telemetry.current_span() is outer
        with telemetry.span("inner") as inner:
            assert telemetry.current_span() is inner
            time.sleep(0.002)
        assert telemetry.current_span() is outer
    assert telemetry.current_span() is None
    with telemetry.span("inner"):
        pass
    ph = telemetry.phases()
    assert set(ph) == {"outer", "inner"}
    assert ph["outer"] >= ph["inner"] > 0


def test_counter_aggregation_cumulative_vs_per_step():
    telemetry.enable()
    sink = ListSink()
    telemetry.add_sink(sink)
    telemetry.step_begin()
    telemetry.count("cachedop.cache_miss")
    telemetry.count("host_sync", 2)
    r1 = telemetry.step_end()
    telemetry.step_begin()
    telemetry.count("host_sync")
    r2 = telemetry.step_end()
    assert r1["step"] == 1 and r2["step"] == 2
    assert r1["counters"]["host_sync"] == 2
    assert r2["counters"]["host_sync"] == 1
    assert "cachedop.cache_miss" not in r2["counters"]
    assert telemetry.counters()["host_sync"] == 3
    assert sink.records == [r1, r2]


@pytest.mark.parametrize("values", [[7.5], [7.5, 2.5],
                                    [5.0, 1.0, 4.0, 2.0, 3.0],
                                    list(np.random.RandomState(0).rand(37))])
def test_hist_summary_matches_the_reference(values):
    """Nearest-rank percentiles over the window, equal to the
    reference's summary of the same stream (exactly)."""
    for t in (telemetry, jtel):
        t.enable()
        for v in values:
            t.hist("lat", v)
    got = telemetry.hist_summary("lat", percentiles=(50, 90, 99))
    assert got == jtel.hist_summary("lat", percentiles=(50, 90, 99))
    assert got["p99"] <= got["max"]


def test_span_thread_safety():
    telemetry.enable()
    errs = []

    def worker(name):
        try:
            for _ in range(200):
                with telemetry.span(name) as s:
                    assert telemetry.current_span() is s
                telemetry.count(name)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(f"t{i}",))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs and not any(t.is_alive() for t in threads)
    counters = telemetry.counters()
    assert all(counters[f"t{i}"] == 200 for i in range(4))


def test_host_sync_counter_on_asnumpy_and_wait():
    telemetry.enable()
    a = nd.array([1.0, 2.0], ctx=CPU)
    a.asnumpy()
    a.wait_to_read()
    (a + a).asnumpy()
    assert telemetry.counters()["host_sync"] == 3


def test_nbytes_of_matches_the_reference():
    for shape in ((8, 4), (3,), ()):
        a, j = nd.ones(shape, ctx=CPU), jmx.nd.ones(shape)
        assert telemetry.nbytes_of(a) == jtel.nbytes_of(j) == \
            int(np.prod(shape)) * 4
    a = nd.ones((8, 4), ctx=CPU)
    assert telemetry.nbytes_of([a, a]) == 2 * telemetry.nbytes_of(a)
    assert telemetry.nbytes_of(object()) == 0
    rs = nd.sparse.row_sparse_array(([[1.0, 2.0], [3.0, 4.0]], [0, 3]),
                                    shape=(5, 2), ctx=CPU)
    assert telemetry.nbytes_of(rs) == 2 * 2 * 4 + 2 * 8


# --- JSONL sink -------------------------------------------------------------

def test_jsonl_schema_has_the_reference_keys(tmp_path):
    """Records of the same empty steps carry the same keys in both
    packages (the memory and cost keys included)."""
    recs = {}
    for name, t in (("port", telemetry), ("ref", jtel)):
        path = str(tmp_path / f"{name}.jsonl")
        t.enable(jsonl_path=path)
        for _ in range(3):
            with t.step(examples=BATCH, epoch=0):
                with t.span("trainer.step"):
                    t.count("host_sync")
        t.disable()
        recs[name] = t.read_jsonl(path)
    assert len(recs["port"]) == 3
    for i, (rec, ref) in enumerate(zip(recs["port"], recs["ref"])):
        assert set(rec) == set(ref)
        assert rec["step"] == i + 1
        assert rec["step_ms"] > 0 and rec["phases_ms"]["trainer.step"] > 0
        assert rec["host_sync"] == 1 and rec["epoch"] == 0
        assert rec["examples"] == BATCH and rec["examples_per_sec"] > 0
        assert rec["bulk_flush"] == 0 and rec["bulk_async_wait_ms"] == 0
    with open(str(tmp_path / "port.jsonl")) as f:
        for line in f:
            json.loads(line)


def test_jsonl_append_mode(tmp_path):
    path = str(tmp_path / "t.jsonl")
    telemetry.enable(jsonl_path=path)
    with telemetry.step():
        pass
    telemetry.disable()
    telemetry.enable(jsonl_path=path, append=True)
    with telemetry.step():
        pass
    telemetry.disable()
    assert [r["step"] for r in telemetry.read_jsonl(path)] == [1, 1]


def test_left_out_parts_raise_naming_slice_19():
    # ported in slice 20: each keyword switches its tier on, disable()
    # switches it off again, and the submodules resolve
    mods = {"trace": telemetry.tracing, "fleet": telemetry.fleet,
            "capacity": telemetry.capacity}
    try:
        for kw, mod in mods.items():
            telemetry.enable(memory=False, cost=False, **{kw: True})
            assert mod.is_enabled(), kw
            telemetry.disable()
            assert not mod.is_enabled(), kw
    finally:
        telemetry.disable()
        telemetry.tracing.clear()
        telemetry.fleet.clear()
    assert callable(telemetry.promtext.prometheus_text)
    with pytest.raises(AttributeError):
        telemetry.no_such_name


# --- profiler bridge --------------------------------------------------------

def test_chrome_trace_shares_timeline_with_op_events(tmp_path):
    """Telemetry spans and op-dispatch events land in ONE traceEvents
    list, on one clock."""
    from mxnet_tpu_torch import profiler

    trace = str(tmp_path / "profile.json")
    profiler.set_config(filename=trace)
    profiler.dump(finished=True)
    telemetry.enable()
    profiler.set_state("run")
    try:
        net = _net()
        net.hybridize()
        with telemetry.span("trainer.step", attrs={"batch": BATCH}):
            net(nd.ones((BATCH, 6), ctx=CPU)).asnumpy()
    finally:
        profiler.dump(finished=True)
        telemetry.disable()
    events = json.load(open(trace))["traceEvents"]
    cats = {e.get("cat") for e in events}
    assert "telemetry" in cats and "operator" in cats, cats
    span_evt = next(e for e in events if e.get("cat") == "telemetry"
                    and e["name"].endswith("trainer.step"))
    in_span = [e for e in events if e.get("cat") == "operator" and
               span_evt["ts"] <= e["ts"] <=
               span_evt["ts"] + span_evt["dur"]]
    assert in_span
    assert span_evt["args"]["batch"] == str(BATCH)


# --- instrumented subsystems ------------------------------------------------

def test_kvstore_push_pull_instrumented():
    telemetry.enable()
    kv = tmx.kv.create("local")
    v = nd.ones((16,), ctx=CPU)
    kv.init("w", v)
    telemetry.step_begin()
    kv.push("w", nd.ones((16,), ctx=CPU))
    out = nd.zeros((16,), ctx=CPU)
    kv.pull("w", out)
    kv.row_sparse_pull("w", out=out, row_ids=nd.array([1, 3], ctx=CPU))
    rec = telemetry.step_end()
    assert rec["phases_ms"]["kvstore.push"] > 0
    assert rec["phases_ms"]["kvstore.pull"] > 0
    assert rec["counters"]["kvstore.push_bytes"] == 16 * 4
    # the dense pull's target and the two rows pulled with their ids
    assert rec["counters"]["kvstore.pull_bytes"] == 16 * 4 + 2 * 4 + 2 * 8


def test_e2e_hybridized_trainer_jsonl(tmp_path):
    """A hybridized training loop over the local store gives per-step
    records with the phase breakdown, cache hit/miss, host syncs and the
    gradients' bytes as allreduce bytes."""
    path = str(tmp_path / "train.jsonl")
    net = _net()
    net.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05}, kvstore="device")
    rng = np.random.RandomState(0)
    telemetry.enable(jsonl_path=path)
    for _ in range(3):
        x = nd.array(rng.randn(BATCH, 6).astype(np.float32), ctx=CPU)
        y = nd.array(rng.randint(0, 4, (BATCH,)), ctx=CPU)
        with telemetry.step(examples=BATCH):
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(BATCH)
            loss.asnumpy()
    telemetry.disable()
    records = telemetry.read_jsonl(path)
    first, later = records[0], records[1:]
    for key in ("trainer.step", "trainer.allreduce", "trainer.update"):
        assert first["phases_ms"].get(key, 0) > 0, (key, first["phases_ms"])
    assert first["cachedop_cache_miss"] >= 1 and first["compile_count"] >= 1
    for rec in later:
        assert rec["cachedop_cache_hit"] >= 1
        assert rec["cachedop_cache_miss"] == 0 and rec["compile_count"] == 0
    grad_bytes = sum(telemetry.nbytes_of(p.grad())
                     for p in net.collect_params().values())
    for rec in records:
        assert rec["host_sync"] >= 1
        assert rec["allreduce_bytes"] == grad_bytes
        assert rec["counters"]["trainer.allreduce_wait_ms"] > 0


def test_e2e_step_fusion_build_compile_replay():
    k = 2
    net = _net()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05})
    fused = gluon.FusedTrainStep(
        net, trainer, lambda n, x, y: loss_fn(n(x), y),
        steps_per_execution=k, batch_size=BATCH, stacked_inputs=True)
    rng = np.random.RandomState(1)
    xs = nd.array(rng.randn(k, BATCH, 6).astype(np.float32), ctx=CPU)
    ys = nd.array(rng.randint(0, 4, (k, BATCH)), ctx=CPU)
    telemetry.enable()
    sink = ListSink()
    telemetry.add_sink(sink)
    for _ in range(2):
        with telemetry.step(examples=k * BATCH):
            fused(xs, ys)
    telemetry.disable()
    first, second = sink.records
    assert first["counters"]["step_fusion.cache_miss"] == 1
    assert first["phases_ms"]["step_fusion.build"] > 0
    assert first["phases_ms"]["step_fusion.compile"] > 0
    assert first["compile_count"] >= 1
    assert second["counters"].get("step_fusion.cache_miss", 0) == 0
    assert second["phases_ms"]["step_fusion.replay"] > 0
    assert "step_fusion.compile" not in second["phases_ms"]
    assert second["gauges"]["step_fusion.steps_per_execution"] == k
    assert first["counters"]["step_fusion.steps"] == k


def test_monitor_toc_single_batched_sync():
    from mxnet_tpu_torch.monitor import Monitor

    net = _net()
    mon = Monitor(interval=1, pattern=".*")
    mon.install(net)
    telemetry.enable()
    mon.tic()
    net(nd.ones((2, 6), ctx=CPU))
    rows = mon.toc()
    mon.uninstall()
    assert rows and all(isinstance(s, str) for _, _, s in rows)
    assert telemetry.counters().get("host_sync", 0) == 1


def test_prefetcher_and_checkpoint_emit_the_reference_names(tmp_path):
    """``data.wait_ms``/``data.prefetch_depth``/``data.overlap_dispatch``
    from the prefetcher, the ``ckpt.*`` spans and counters from a
    synchronous and an asynchronous save."""
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.data import DevicePrefetcher

    telemetry.enable()
    telemetry.step_begin()
    source = [np.ones((2, 3), np.float32) * i for i in range(4)]
    with DevicePrefetcher(source, depth=2, ctx=CPU) as pf:
        got = [b.asnumpy()[0, 0] for b in pf]
    assert got == [0.0, 1.0, 2.0, 3.0]
    net = _net()
    checkpoint.save_checkpoint(str(tmp_path / "a"), 1, net)
    checkpoint.save_checkpoint_async(str(tmp_path / "b"), 2, net)
    checkpoint.wait_async()
    rec = telemetry.step_end()
    c = rec["counters"]
    assert c["data.wait_ms"] >= 0 and "data.prefetch_depth" in rec["gauges"]
    assert c["ckpt.save"] == 2 and c["ckpt.bytes"] > 0
    assert c["ckpt.async_overlap_ms"] > 0
    for span in ("ckpt.snapshot", "ckpt.write"):
        assert rec["phases_ms"][span] > 0
    assert rec["ckpt_saves"] == 2


def test_env_autostart(tmp_path):
    """MXNET_TELEMETRY=1 enables at import; MXNET_TELEMETRY_JSONL names
    the log."""
    path = str(tmp_path / "auto.jsonl")
    env = dict(os.environ, MXNET_TELEMETRY="1", MXNET_TELEMETRY_JSONL=path,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    code = ("from mxnet_tpu_torch import telemetry\n"
            "assert telemetry.is_enabled()\n"
            "with telemetry.step():\n"
            "    pass\n"
            "telemetry.disable()\n")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(telemetry.read_jsonl(path)) == 1


# --- the same loop in both packages ------------------------------------------

def _tiny(llama_mod):
    """A 2-layer tiny Llama with a fixed prefix (its parameter names, and
    so the stat paths, do not depend on what the process built before)."""
    cfg = {**llama_mod.LLAMA_CONFIGS["llama_tiny"], "num_layers": 2}
    return llama_mod.LlamaForCausalLM(llama_mod.LlamaConfig(**cfg),
                                      prefix="tl_")


def _llama_loop(pkg, tel, llama_mod, hybridize, arrays, ids, labels):
    """Three recorded steps of a 2-layer tiny Llama under telemetry with
    numerics at stride 1 → the records."""
    kw = {"ctx": CPU} if pkg is tmx else {}
    net = _tiny(llama_mod)
    if pkg is tmx:
        net.initialize(ctx=CPU)
        load_numpy_params(net, arrays, ctx=CPU)
    else:
        net.initialize(jmx.init.Zero())
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(pkg.nd.array(arrays[k]))
    if hybridize:
        net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    sink = (ListSink if pkg is tmx else jtel.sinks.ListSink)()
    tel.enable(numerics=True)
    tel.numerics.enable(stride=1)
    tel.add_sink(sink)
    x = pkg.nd.array(ids, **kw)
    y = pkg.nd.array(labels, **kw)
    for _ in range(3):
        with tel.step(examples=ids.shape[0]):
            with pkg.autograd.record():
                loss = loss_fn(net(x), y).mean()
            loss.backward()
            trainer.step(ids.shape[0])
    tel.disable()
    return sink.records


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
def test_same_tiny_llama_loop_gives_equal_keys(hybridize):
    """Each step's record has the reference's key set, its counters the
    reference's counter keys and its numerics block the reference's
    paths, in order."""
    rs = np.random.RandomState(7)
    ids = rs.randint(0, 256, (2, 8)).astype(np.int32)
    labels = rs.randint(0, 256, (2, 8)).astype(np.int32)
    tnet = _tiny(tllama)
    tnet.initialize(tmx.init.Xavier(), ctx=CPU)
    arrays = {k: p.data().asnumpy()
              for k, p in tnet._collect_params_with_prefix().items()}
    port = _llama_loop(tmx, telemetry, tllama, hybridize, arrays, ids,
                       labels)
    ref = _llama_loop(jmx, jtel, jllama, hybridize, arrays, ids, labels)
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        assert set(p["counters"]) == set(r["counters"])
        assert list(p["numerics"]["tensors"]) == \
            list(r["numerics"]["tensors"])


def _memory_loop(pkg, tel, mem):
    """Two recorded steps of a small MLP hybridized with ``remat="layer"``
    under a host-offloading trainer, after a plan of it → the records."""
    kw = {"ctx": CPU} if pkg is tmx else {}
    pkg.random.seed(5)
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, activation="relu"),
            pkg.gluon.nn.Dense(4))
    net.initialize(pkg.init.Xavier(), **kw)
    net(pkg.nd.ones((1, 6), **kw))
    net.hybridize(remat="layer")
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9},
                                offload="host")
    mem.plan_model(net.collect_params(), optimizer=trainer._optimizer,
                   batch_bytes=BATCH * 6 * 4, remat="layer",
                   offload="host", use_registry=False)
    sink = (ListSink if pkg is tmx else jtel.sinks.ListSink)()
    tel.enable()
    tel.add_sink(sink)
    x = pkg.nd.array(np.ones((BATCH, 6), np.float32), **kw)
    for _ in range(2):
        with tel.step(examples=BATCH):
            with pkg.autograd.record():
                loss = (net(x) ** 2).mean()
            loss.backward()
            trainer.step(BATCH)
    tel.disable()
    return sink.records


def test_memory_budget_keys_match_the_reference():
    """With a remat tier forced, a plan made and optimizer state
    offloaded, every record carries ``remat_policy``,
    ``predicted_peak_bytes`` and ``offload_bytes`` with the reference's
    values."""
    port = _memory_loop(tmx, telemetry, memory)
    _reset_memory()
    ref = _memory_loop(jmx, jtel, jmemory)
    keys = ("remat_policy", "predicted_peak_bytes", "offload_bytes")
    assert len(port) == len(ref) == 2
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        assert [p[k] for k in keys] == [r[k] for k in keys]
    assert port[0]["remat_policy"] == "layer"
    assert port[0]["offload_bytes"] == 4 * (6 * 8 + 8 + 8 * 4 + 4)

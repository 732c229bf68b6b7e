"""The live-storage ledger and the OOM post-mortem of the PyTorch/CUDA
port (``mxnet_tpu_torch.telemetry.memwatch``), with the cost registry's
per-step fields, on the CPU.

Mirrors ``tests/test_memwatch.py`` without its bulk-engine and ``tools/``
lowering cases (the port has no bulked segments and no lowering): the
ledger equals the storages the reachable arrays hold, training steps
neither leak nor lose entries, the per-step peak keeps its high-water
mark, the cost registry analyzes a signature once and replays are hits,
the JSONL records carry ``live_bytes``/``peak_live_bytes``/
``model_flops``/``bytes_accessed``/``mfu`` with no host sync added, ``mfu``
is null without a peak, the profiler gets a live-memory counter track,
an allocation failure raises ``OOMError`` naming the largest buffer by
parameter while any other error passes through unchanged, ``read_jsonl``
tolerates a truncated last line, and the disabled hooks never lock.

Trap 6, torch's aliasing: views, ``reshape`` and ``_data`` rebinds share
one storage, counted once (its whole ``nbytes``), and a storage leaves
the ledger when the storage is freed, not when a view goes.
"""
import gc
import json
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, gluon, nd, telemetry
from mxnet_tpu_torch.telemetry import costs, memwatch
from mxnet_tpu_torch.telemetry.sinks import ListSink

CPU = tmx.cpu()
BATCH = 4
IN_DIM = 6


@pytest.fixture(autouse=True)
def _clean():
    telemetry.disable()
    telemetry.reset()
    costs.set_peak_flops(None)
    yield
    telemetry.disable()
    telemetry.reset()
    costs.set_peak_flops(None)


def _net(units=(8, 4), in_dim=IN_DIM):
    net = gluon.nn.HybridSequential()
    for u in units[:-1]:
        net.add(gluon.nn.Dense(u, activation="relu"))
    net.add(gluon.nn.Dense(units[-1]))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net(nd.ones((1, in_dim), ctx=CPU))  # resolve deferred shapes
    return net


def _storage_bytes(arrays):
    seen = {}
    for a in arrays:
        st = a._data.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values()), len(seen)


def _train_steps(net, trainer, loss_fn, x, y, n):
    for _ in range(n):
        with telemetry.step():
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(BATCH)
        del loss
        gc.collect()


# --- the ledger --------------------------------------------------------------

def test_ledger_matches_reachable_buffers_exactly():
    """live_bytes == the storages of every reachable array, a shared
    storage counted once."""
    telemetry.enable()
    net = _net()
    net.hybridize()
    with autograd.record():
        out = net(nd.ones((BATCH, IN_DIM), ctx=CPU))
    out.backward()
    x = nd.ones((BATCH, IN_DIM), ctx=CPU)
    out = net(x)
    gc.collect()
    arrays = [x, out]
    for p in net.collect_params().values():
        arrays += [p.data(), p.grad()]
    nbytes, n = _storage_bytes(arrays)
    assert memwatch.ledger_size() == n
    assert memwatch.live_bytes() == nbytes
    before = memwatch.live_bytes()
    alias = out.detach()
    assert memwatch.live_bytes() == before
    del alias


def test_views_reshape_and_rebinds_count_one_storage():
    """Trap 6: a view, a reshape and a rebind to a view of the same
    storage add nothing (the rebound holder's old storage leaves with its
    last reference); a copy adds its own storage."""
    telemetry.enable()
    a = nd.ones((8, 4), ctx=CPU)
    base = memwatch.live_bytes()
    assert base == 8 * 4 * 4 and memwatch.ledger_size() == 1
    v = a.reshape((4, 8))
    s = a[2:4]
    b = nd.zeros((1,), ctx=CPU)
    assert memwatch.live_bytes() == base + 4
    b._data = a._data.view(-1)
    memwatch.track(b._data)
    assert memwatch.live_bytes() == base and memwatch.ledger_size() == 1
    c = a.copy()
    assert memwatch.live_bytes() == 2 * base
    del c, v, s
    gc.collect()
    assert memwatch.live_bytes() == base


def test_release_follows_the_storage_not_the_view():
    telemetry.enable()
    a = nd.ones((16, 16), ctx=CPU)
    view = a.reshape((256,))
    n = memwatch.live_bytes()
    del a
    gc.collect()
    assert memwatch.live_bytes() == n  # the view keeps the storage
    del view
    gc.collect()
    assert memwatch.live_bytes() == n - 16 * 16 * 4


def test_no_leak_across_train_steps():
    telemetry.enable()
    net = _net()
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9})
    loss_fn = gluon.loss.L2Loss()
    x = nd.ones((BATCH, IN_DIM), ctx=CPU)
    y = nd.ones((BATCH, 4), ctx=CPU)
    _train_steps(net, trainer, loss_fn, x, y, 3)
    at3, n3 = memwatch.live_bytes(), memwatch.ledger_size()
    _train_steps(net, trainer, loss_fn, x, y, 7)
    assert memwatch.live_bytes() == at3
    assert memwatch.ledger_size() == n3


def test_peak_watermark_survives_the_intermediates():
    telemetry.enable()
    x = nd.ones((64, 64), ctx=CPU)
    gc.collect()
    memwatch.step_mark(1)
    base = memwatch.live_bytes()
    y = x + 1.0
    z = y * 2.0
    w = z - 3.0
    grown = memwatch.live_bytes()
    assert grown == base + 3 * 64 * 64 * 4
    del y, z, w
    gc.collect()
    assert memwatch.live_bytes() == base
    assert memwatch.peak_live_bytes() >= grown


# --- the cost registry -------------------------------------------------------

def test_cost_registry_hit_on_cachedop_replay():
    telemetry.enable()
    net = _net()
    net.hybridize()
    x = nd.ones((BATCH, IN_DIM), ctx=CPU)
    net(x)
    s0 = costs.stats()
    assert s0["analyzed"] >= 1
    net(x)
    s1 = costs.stats()
    assert s1["analyzed"] == s0["analyzed"]
    assert s1["hits"] == s0["hits"] + 1
    arts = [a for a in costs.snapshot() if a["kind"] == "cachedop"]
    assert len(arts) == 1 and arts[0]["executions"] == 2
    assert arts[0]["error"] is None
    # two Dense products: 2·B·(6·8 + 8·4) flops
    assert arts[0]["flops"] == 2 * BATCH * (6 * 8 + 8 * 4)
    assert arts[0]["site"] == "mxnet_tpu_torch.gluon.block:CachedOp." \
        "__call__ (" + net.name + ")"


def test_registry_covers_fused_trainer_and_backward():
    telemetry.enable()
    net = _net()
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01})
    _train_steps(net, trainer, gluon.loss.L2Loss(),
                 nd.ones((BATCH, IN_DIM), ctx=CPU),
                 nd.ones((BATCH, 4), ctx=CPU), 2)
    kinds = {a["kind"] for a in costs.snapshot()}
    assert {"cachedop", "cachedop_bwd", "trainer_fused"} <= kinds
    bwd = next(a for a in costs.snapshot() if a["kind"] == "cachedop_bwd")
    assert bwd["flops"] > 0 and bwd["executions"] == 2


def test_e2e_jsonl_memory_and_cost_fields():
    """The records carry the ledger's and the registry's fields;
    model_flops is the executed entries' flops exactly; recording adds
    no host sync."""
    telemetry.enable()
    costs.set_peak_flops(1e12)
    sink = ListSink()
    telemetry.add_sink(sink)
    net = _net()
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01})
    loss_fn = gluon.loss.L2Loss()
    x = nd.ones((BATCH, IN_DIM), ctx=CPU)
    y = nd.ones((BATCH, 4), ctx=CPU)
    _train_steps(net, trainer, loss_fn, x, y, 3)
    before = {(a["kind"], a["key"]): a["executions"]
              for a in costs.snapshot()}
    _train_steps(net, trainer, loss_fn, x, y, 1)
    last = sink.records[-1]
    assert last["live_bytes"] >= memwatch.live_bytes() > 0
    assert last["peak_live_bytes"] >= last["live_bytes"]
    assert last["live_bytes_by_device"] == {"cpu:0": last["live_bytes"]}
    expected = sum(a["flops"] * (a["executions"] -
                                 before.get((a["kind"], a["key"]), 0))
                   for a in costs.snapshot())
    assert last["model_flops"] == pytest.approx(expected)
    assert last["model_flops"] > 0 and last["bytes_accessed"] > 0
    assert last["mfu"] == pytest.approx(
        last["model_flops"] / (last["step_ms"] / 1e3 * 1e12), rel=1e-6)
    assert last["host_sync"] == 0


def test_mfu_null_without_peak():
    telemetry.enable()
    sink = ListSink()
    telemetry.add_sink(sink)
    assert costs.peak_flops() is None  # no card, no override
    with telemetry.step():
        nd.ones((2, 2), ctx=CPU) + 1.0
    assert sink.records[-1]["mfu"] is None


def test_profiler_counter_track(tmp_path):
    from mxnet_tpu_torch import profiler

    telemetry.enable()
    path = str(tmp_path / "trace.json")
    profiler.set_config(profile_all=True, filename=path)
    profiler.set_state("run")
    a = nd.ones((16, 16), ctx=CPU)
    profiler.dump(finished=True)
    events = json.load(open(path))["traceEvents"]
    counters = [e for e in events if e.get("ph") == "C" and
                e["name"] == "memwatch.live_bytes"]
    assert counters and counters[-1]["args"]["total"] > 0
    del a


# --- OOM post-mortem ---------------------------------------------------------

def test_oom_postmortem_names_largest_buffer(tmp_path, monkeypatch):
    """An allocation failure inside an op raises ``OOMError`` naming the
    report and the largest live buffer by parameter name."""
    report = str(tmp_path / "oom.json")
    telemetry.enable()
    memwatch.enable(report_path=report)
    net = _net(units=(16, 4))
    x = nd.ones((BATCH, IN_DIM), ctx=CPU)
    net(x)

    def boom(*a, **k):
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 99.00 GiB")

    monkeypatch.setattr(torch.nn.functional, "linear", boom)
    monkeypatch.setattr(torch, "matmul", boom)
    with pytest.raises(memwatch.OOMError) as ei:
        net(x)
    assert report in str(ei.value)
    assert isinstance(ei.value.__cause__, torch.cuda.OutOfMemoryError)
    rep = json.load(open(report))
    assert rep["n_live_buffers"] == memwatch.ledger_size()
    buffers = rep["buffers"]
    assert buffers == sorted(buffers, key=lambda b: -b["nbytes"])
    params = net.collect_params()
    largest = max(params.values(), key=lambda p: np.prod(p.shape))
    assert buffers[0]["owner"] in (largest.name, largest.name + ".grad")
    assert buffers[0]["nbytes"] == int(np.prod(largest.shape)) * 4
    assert largest.name in str(ei.value)


def test_non_oom_errors_pass_through():
    telemetry.enable()
    with pytest.raises(ValueError, match="shape mismatch"):
        try:
            raise ValueError("shape mismatch")
        except ValueError as e:
            memwatch.annotate_oom(e, context="test")
            raise
    net = _net()
    with pytest.raises(Exception) as ei:
        net(nd.ones((BATCH, IN_DIM + 1), ctx=CPU))
    assert not isinstance(ei.value, memwatch.OOMError)


# --- read_jsonl truncation tolerance -----------------------------------------

def test_read_jsonl_tolerates_truncated_final_line(tmp_path):
    p = tmp_path / "crashed.jsonl"
    with open(p, "w") as f:
        f.write(json.dumps({"step": 0, "step_ms": 1.0}) + "\n")
        f.write(json.dumps({"step": 1, "step_ms": 1.1}) + "\n")
        f.write('{"step": 2, "step_m')
    records = telemetry.read_jsonl(str(p))
    assert [r["step"] for r in records] == [0, 1]
    assert records.truncated is True
    corrupt = tmp_path / "corrupt.jsonl"
    with open(corrupt, "w") as f:
        f.write('{"step": 0, "ste\n')
        f.write(json.dumps({"step": 1}) + "\n")
    with pytest.raises(json.JSONDecodeError):
        telemetry.read_jsonl(str(corrupt))


# --- disabled path -----------------------------------------------------------

class _PoisonLock:
    def __enter__(self):
        raise AssertionError("disabled recorder acquired the lock")

    def __exit__(self, *exc):
        return False

    acquire = __enter__


def test_disabled_hooks_never_lock_or_record(monkeypatch):
    assert not memwatch._enabled and not costs._enabled
    size_before = costs.stats()["size"]
    monkeypatch.setattr(memwatch, "_lock", _PoisonLock())
    monkeypatch.setattr(costs, "_lock", _PoisonLock())
    raw = nd.ones((4,), ctx=CPU)._data
    memwatch.track(raw)
    memwatch.donated((raw,))
    memwatch.adopt(nd.ones((1,), ctx=CPU), "x")
    memwatch.step_mark(7)
    memwatch.annotate_oom(RuntimeError("CUDA out of memory"), "test")
    assert costs.note("k", 1) is None
    with costs.first("k", 1) as c:
        assert c.flops is None
    monkeypatch.undo()
    assert memwatch.ledger_size() == 0
    assert costs.stats()["size"] == size_before


def test_disabled_overhead_bounded():
    raw = nd.ones((4,), ctx=CPU)._data
    t0 = time.perf_counter()
    for _ in range(10_000):
        memwatch.track(raw)
        memwatch.donated((raw,))
        costs.note("k", 1)
        costs.kernel(None)
    assert time.perf_counter() - t0 < 0.5

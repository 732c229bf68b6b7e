"""The port's deferred imperative dispatch (``engine.bulk``) against the
JAX package, case by case as the reference's ``tests/test_engine_bulk.py``.

With bulking on, ``apply_op`` appends to a thread-local pending segment;
every flush trigger (size, a read of the value, a record boundary, a
``CachedOp`` or kvstore dispatch, an explicit ``flush``) resolves the
pending arrays; the segment cache counts as the reference's does; the
NaiveEngine and the disabled path bypass deferral.  On the CPU a segment
runs its ops in order, so every bulked result equals the port's eager
one bit for bit; each is also held against the reference's eager result
on the same numpy inputs (within 1e-6 relative, 1e-6 absolute: the two
packages' f32 kernels round transcendental functions differently), and
where a case counts (cache hits and misses, pending ops, flush counts,
telemetry keys) the port's counts equal the reference's for the same
program.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import engine as jengine

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import engine, gluon, nd, telemetry
from mxnet_tpu_torch.engine import _PendingArray

CPU = mx.cpu()
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_engine():
    prev = []
    for eng in (engine, jengine):
        eng.flush()
        eng.clear_segment_cache()
        prev.append(eng.set_bulk_size(15))
    with CPU:
        yield
    for eng, p in zip((engine, jengine), prev):
        eng.flush()
        eng.set_bulk_size(p)


def _pending(a):
    return a._raw.__class__ is _PendingArray


def _np(shape=(3, 4), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _arr(shape=(3, 4), seed=0):
    return nd.array(_np(shape, seed), ctx=CPU)


def _jarr(shape=(3, 4), seed=0):
    return jmx.nd.array(_np(shape, seed))


# --- numerical identity across the op sweep ---------------------------------

def _sweep(pkg):
    n = pkg.nd
    return [
        ("add", lambda a, b: a + b),
        ("add_scalar", lambda a, b: a + 1.25),
        ("radd_scalar", lambda a, b: 1.25 + a),
        ("sub", lambda a, b: a - b),
        ("rsub_scalar", lambda a, b: 2.5 - a),
        ("mul", lambda a, b: a * b),
        ("mul_scalar", lambda a, b: a * 1.001),
        ("div", lambda a, b: a / (b + 3.0)),
        ("div_scalar", lambda a, b: a / 1.002),
        ("rdiv_scalar", lambda a, b: 1.7 / (a + 3.0)),
        ("pow_scalar", lambda a, b: (a + 3.0) ** 1.5),
        ("neg", lambda a, b: -a),
        ("exp", lambda a, b: n.exp(a)),
        ("log", lambda a, b: n.log(a + 3.0)),
        ("sqrt", lambda a, b: n.sqrt(a + 3.0)),
        ("rsqrt", lambda a, b: n.rsqrt(a + 3.0)),
        ("tanh", lambda a, b: n.tanh(a)),
        ("sigmoid", lambda a, b: n.sigmoid(a)),
        ("relu", lambda a, b: n.relu(a)),
        ("abs", lambda a, b: n.abs(a)),
        ("square", lambda a, b: n.square(a)),
        ("floor", lambda a, b: n.floor(a)),
        ("sign", lambda a, b: n.sign(a)),
        ("maximum", lambda a, b: n.maximum(a, b)),
        ("minimum", lambda a, b: n.minimum(a, b)),
        ("clip", lambda a, b: n.clip(a, -0.5, 0.5)),
        ("sum", lambda a, b: n.sum(a)),
        ("sum_axis", lambda a, b: n.sum(a, axis=1)),
        ("mean", lambda a, b: n.mean(a, axis=0)),
        ("max", lambda a, b: n.max(a, axis=1)),
        ("dot", lambda a, b: n.dot(a, b.T)),
        ("reshape", lambda a, b: a.reshape((4, 3))),
        ("transpose", lambda a, b: n.transpose(a)),
        ("softmax", lambda a, b: n.softmax(a, axis=-1)),
        ("norm", lambda a, b: n.norm(a)),
    ]


SWEEP = dict(_sweep(mx))
JSWEEP = dict(_sweep(jmx))


def _check_sweep(name, size):
    fn = SWEEP[name]
    a, b = _arr(seed=1), _arr(seed=2)
    eager = fn(a, b).asnumpy()
    with engine.bulk(size):
        out = fn(a, b)
        got = out.asnumpy()
    np.testing.assert_array_equal(got, eager)
    assert got.dtype == eager.dtype
    ref = np.asarray(JSWEEP[name](_jarr(seed=1), _jarr(seed=2)).asnumpy())
    np.testing.assert_allclose(got, ref.astype(got.dtype), **TOL)


@pytest.mark.parametrize("name", list(SWEEP))
def test_bulked_bit_identical_to_eager(name):
    _check_sweep(name, 8)


def test_chained_segment_matches_eager():
    a, b = _arr(seed=3), _arr(seed=4)
    ref = nd.tanh(nd.relu(a * b) + a).sum(axis=0).asnumpy()
    with engine.bulk(16):
        out = nd.tanh(nd.relu(a * b) + a).sum(axis=0)
        assert _pending(out)
        got = out.asnumpy()
    np.testing.assert_array_equal(ref, got)
    ja, jb = _jarr(seed=3), _jarr(seed=4)
    jref = jmx.nd.tanh(jmx.nd.relu(ja * jb) + ja).sum(axis=0).asnumpy()
    np.testing.assert_allclose(got, jref, **TOL)


def _scalar_replay(pkg, eng, arr):
    a = arr(seed=5)
    eng.clear_segment_cache()
    with eng.bulk(8):
        r1 = (a * 2.5 + 0.1).asnumpy()
    with eng.bulk(8):
        r2 = (a * 3.5 + 0.7).asnumpy()
    s = eng.segment_cache_stats()
    return r1, r2, (s["miss"], s["hit"])


def test_scalar_attr_change_replays_cached_segment():
    r1, r2, stats = _scalar_replay(mx, engine, _arr)
    j1, j2, jstats = _scalar_replay(jmx, jengine, _jarr)
    assert stats == jstats == (1, 1)
    a = _arr(seed=5)
    np.testing.assert_array_equal(r1, (a * 2.5 + 0.1).asnumpy())
    np.testing.assert_array_equal(r2, (a * 3.5 + 0.7).asnumpy())
    np.testing.assert_allclose(r1, j1, **TOL)
    np.testing.assert_allclose(r2, j2, **TOL)


# --- flush triggers ---------------------------------------------------------

def test_flush_on_asnumpy():
    a = _arr()
    with engine.bulk(8):
        c = a + 1.0
        assert _pending(c) and engine.pending_ops() == 1
        c.asnumpy()
        assert engine.pending_ops() == 0
        assert not _pending(c)


def test_flush_on_wait_to_read():
    a = _arr()
    with engine.bulk(8):
        c = a * 2.0
        assert _pending(c)
        c.wait_to_read()
        assert engine.pending_ops() == 0


def test_flush_on_item():
    a = nd.array(np.float32([[41.0]]), ctx=CPU)
    with engine.bulk(8):
        c = a + 1.0
        assert _pending(c)
        assert c.item() == 42.0
        assert engine.pending_ops() == 0


def test_flush_on_getitem():
    a = _arr()
    with engine.bulk(8):
        c = a + 1.0
        assert _pending(c)
        seg = c._raw._segment
        row = c[0]
        assert seg.results is not None
        np.testing.assert_array_equal(row.asnumpy(), (a + 1.0).asnumpy()[0])


def test_flush_on_bulk_size():
    a = _arr()
    with engine.bulk(3):
        c = a + 1.0
        c = c * 2.0
        assert engine.pending_ops() == 2
        c = c - 3.0
        assert engine.pending_ops() == 0
        if engine.async_enabled():
            assert c._raw._segment.submitted
        else:
            assert not _pending(c)
    got = c.asnumpy()
    np.testing.assert_array_equal(got, ((a + 1.0) * 2.0 - 3.0).asnumpy())
    ja = _jarr()
    np.testing.assert_allclose(got, ((ja + 1.0) * 2.0 - 3.0).asnumpy(),
                               **TOL)


def test_flush_on_bulk_size_sync_mode():
    prev = engine.set_async_enabled(False)
    try:
        a = _arr()
        with engine.bulk(3):
            c = a + 1.0
            c = c * 2.0
            c = c - 3.0
            assert engine.pending_ops() == 0
            assert not _pending(c)
        np.testing.assert_array_equal(
            c.asnumpy(), ((a + 1.0) * 2.0 - 3.0).asnumpy())
    finally:
        engine.set_async_enabled(prev)


def _record_grads(pkg, eng, arr, bulked):
    a = arr()
    w = pkg.nd.array(np.ones((3, 4), np.float32))
    w.attach_grad()
    if not bulked:
        with pkg.autograd.record():
            (w * (a + 1.0)).sum().backward()
        return w.grad.asnumpy(), None
    with eng.bulk(16):
        pre = a + 1.0
        pending = pre._raw.__class__ is eng._PendingArray
        with pkg.autograd.record():
            flushed = (eng.pending_ops(), pre._raw._segment.results
                       is not None if hasattr(pre._raw, "_segment")
                       else True)
            loss = (w * pre).sum()
            inside = eng.pending_ops()
        loss.backward()
    return w.grad.asnumpy(), (pending, flushed, inside)


def test_flush_on_record_boundary_and_grads_match():
    ref, _ = _record_grads(mx, engine, _arr, False)
    got, seen = _record_grads(mx, engine, _arr, True)
    jgot, jseen = _record_grads(jmx, jengine, _jarr, True)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, jgot, **TOL)
    assert seen == jseen == (True, (0, True), 0)


def test_pause_does_not_flush():
    a = _arr()
    with engine.bulk(8):
        c = a + 1.0
        with ag.pause():
            assert engine.pending_ops() == 1
        assert _pending(c)


def test_explicit_flush_returns_count():
    counts = []
    for eng, arr in ((engine, _arr), (jengine, _jarr)):
        a = arr()
        with eng.bulk(8):
            _ = a + 1.0
            _ = a * 2.0
            counts.append((eng.flush(), eng.flush()))
    assert counts[0] == counts[1] == (2, 0)


def test_flush_on_cachedop_dispatch():
    net = gluon.nn.Dense(4)
    net.initialize(ctx=CPU)
    x = _arr((2, 3))
    net(x)
    net.hybridize()
    net(x)
    with engine.bulk(8):
        y = x + 1.0
        assert _pending(y)
        net(x)
        assert engine.pending_ops() == 0


def test_flush_on_kvstore_dispatch():
    kv = mx.kv.create("local")
    kv.init("w", nd.zeros((3, 4), ctx=CPU))
    g = _arr(seed=7)
    with engine.bulk(8):
        scaled = g * 0.5
        assert _pending(scaled)
        kv.push("w", scaled)
        assert engine.pending_ops() == 0
    out = nd.zeros((3, 4), ctx=CPU)
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), (g * 0.5).asnumpy())


def test_read_of_a_pending_input_flushes_before_an_inplace_write():
    a = _arr(seed=13)
    before = a.asnumpy().copy()
    with engine.bulk(8):
        c = a * 2.0
        assert _pending(c)
        a._data.mul_(0.0)  # the read runs the segment first
        assert engine.pending_ops() == 0
    np.testing.assert_array_equal(c.asnumpy(), before * 2.0)


# --- sanitizer through a deferred segment -----------------------------------

def test_sanitizer_stale_read_through_deferred_segment():
    from mxnet_tpu_torch import sanitizer

    sanitizer.enable()
    try:
        a = _arr()
        sanitizer.donate([a._data], "test_donating_site")
        with engine.bulk(8):
            c = a + 1.0
            assert _pending(c)
            with pytest.raises(sanitizer.DonatedBufferError,
                               match="test_donating_site"):
                engine.flush()
    finally:
        sanitizer.reset()
        sanitizer.disable()
        engine._TLS.segment = None


# --- bypasses ---------------------------------------------------------------

def test_naive_engine_bypasses_bulking():
    prev = engine.engine_type()
    engine.set_engine_type("NaiveEngine")
    try:
        a = _arr()
        with engine.bulk(8):
            c = a + 1.0
            assert not _pending(c)
            assert engine.pending_ops() == 0
    finally:
        engine.set_engine_type(prev)


def test_bulk_size_one_disables_deferral():
    a = _arr()
    with engine.bulk(1):
        c = a + 1.0
        assert not _pending(c)


def test_disabled_path_never_reaches_maybe_defer(monkeypatch):
    assert not engine._bulk_on

    def boom(*a, **k):  # pragma: no cover - must not run
        raise AssertionError("maybe_defer called with bulking off")

    monkeypatch.setattr(engine, "maybe_defer", boom)
    a = _arr()
    np.testing.assert_array_equal((a + 1.0).asnumpy(), a.asnumpy() + 1.0)


def test_recording_forces_eager_inside_bulk():
    a = _arr()
    with engine.bulk(8):
        with ag.record():
            c = a + 1.0
            assert not _pending(c)


def test_profiler_bypasses_deferral():
    from mxnet_tpu_torch import profiler

    a = _arr()
    profiler.set_state("run")
    try:
        with engine.bulk(8):
            assert not _pending(a + 1.0)
    finally:
        profiler.set_state("stop")


# --- cache accounting -------------------------------------------------------

def _cache_counts(eng, arr):
    a = arr(seed=8)
    eng.clear_segment_cache()
    out = []
    with eng.bulk(8):
        (eng_nd(eng).tanh(a) + a).asnumpy()
    s = eng.segment_cache_stats()
    out.append((s["miss"], s["hit"], s["size"]))
    with eng.bulk(8):
        (eng_nd(eng).tanh(a) + a).asnumpy()
    s = eng.segment_cache_stats()
    out.append((s["miss"], s["hit"], s["size"]))
    b = arr((5, 2), seed=9)
    with eng.bulk(8):
        (eng_nd(eng).tanh(b) + b).asnumpy()
    s = eng.segment_cache_stats()
    out.append((s["miss"], s["hit"], s["size"]))
    return out


def eng_nd(eng):
    return nd if eng is engine else jmx.nd


def test_segment_cache_hit_miss_accounting():
    got = _cache_counts(engine, _arr)
    assert got == _cache_counts(jengine, _jarr)
    assert got == [(1, 0, 1), (1, 1, 1), (2, 1, 2)]


def test_cross_segment_pending_input_materializes():
    a = _arr(seed=10)
    with engine.bulk(2):
        c = a + 1.0
        d = c * 2.0
        e = d - 0.5
        assert _pending(e)
        got = e.asnumpy()
    np.testing.assert_array_equal(got, ((a + 1.0) * 2.0 - 0.5).asnumpy())


def test_key_intern_stats_count_hits_after_first_sight():
    a = _arr(seed=14)
    s0 = engine.key_intern_stats()
    with engine.bulk(8):
        for _ in range(3):
            a = nd.tanh(a)
        a.asnumpy()
    s1 = engine.key_intern_stats()
    assert s1["hit"] - s0["hit"] >= 2 and s1["sites"] >= 1


# --- env vars + telemetry ---------------------------------------------------

def _run_py(code, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, "-c", code], env=full,
                          capture_output=True, text=True, timeout=120)


def test_env_bulk_size_honoured_at_startup():
    r = _run_py(
        "from mxnet_tpu_torch import engine;"
        "assert engine._bulk_size == 7, engine._bulk_size;"
        "assert engine.bulk_size() == 7",
        MXNET_ENGINE_BULK_SIZE="7")
    assert r.returncode == 0, r.stderr


def test_env_bulk_size_train_infer_variants():
    r = _run_py(
        "from mxnet_tpu_torch import engine, autograd as ag;"
        "assert engine.bulk_size() == 5;"
        "ag.set_training(True);"
        "assert engine.bulk_size() == 9",
        MXNET_ENGINE_BULK_SIZE_IN_TRAIN="9",
        MXNET_ENGINE_BULK_SIZE_IN_INFER="5")
    assert r.returncode == 0, r.stderr


def test_env_bulk_enable_flag():
    r = _run_py(
        "import numpy as np\n"
        "import mxnet_tpu_torch as mx\n"
        "from mxnet_tpu_torch import engine, nd\n"
        "assert engine.bulk_enabled() and engine._bulk_on\n"
        "a = nd.array(np.ones((2, 2), np.float32), ctx=mx.cpu())\n"
        "c = a + 1.0\n"
        "assert c._raw.__class__ is engine._PendingArray\n"
        "assert (c.asnumpy() == 2).all()\n",
        MXT_ENGINE_BULK="1")
    assert r.returncode == 0, r.stderr


def _telemetry_record(tel, eng, arr, record_mod):
    tel.enable()
    try:
        a = arr(seed=11)
        tel.step_begin()
        with eng.bulk(8):
            (a + 1.0).asnumpy()
            _ = a * 2.0
            eng.flush()
        rec = tel.step_end()
        a = arr(seed=12)
        tel.step_begin()
        with eng.bulk(2):
            c = a + 1.0
            c = c * 2.0
            _ = a - 1.0
            with record_mod.record():
                pass
        rec2 = tel.step_end()
        return rec, rec2
    finally:
        tel.disable()


def test_telemetry_flush_reasons_and_step_record():
    rec, _ = _telemetry_record(telemetry, engine, _arr, ag)
    jrec, _ = _telemetry_record(jmx.telemetry, jengine, _jarr,
                                jmx.autograd)
    sc = rec["counters"]
    assert rec["bulk_flush"] == sc["engine.bulk_flush"] >= 2
    assert sc["engine.bulk_flush.host_sync"] >= 1
    assert sc["engine.bulk_flush.explicit"] >= 1
    assert sc["engine.bulk_compile"] >= 1
    assert rec["gauges"]["engine.bulk_segment_ops"] >= 1
    assert rec["compile_count"] >= sc["engine.bulk_compile"]
    for k in ("engine.bulk_flush", "engine.bulk_flush.host_sync",
              "engine.bulk_flush.explicit", "engine.bulk_compile"):
        assert sc[k] == jrec["counters"][k], k
    assert rec["bulk_flush"] == jrec["bulk_flush"]


def test_telemetry_size_and_record_reasons():
    _, rec = _telemetry_record(telemetry, engine, _arr, ag)
    _, jrec = _telemetry_record(jmx.telemetry, jengine, _jarr, jmx.autograd)
    sc = rec["counters"]
    assert sc["engine.bulk_flush.size"] >= 1
    assert sc["engine.bulk_flush.record"] >= 1
    for k in ("engine.bulk_flush.size", "engine.bulk_flush.record"):
        assert sc[k] == jrec["counters"][k], k


# --- scope state ------------------------------------------------------------

def test_bulk_scope_restores_sizes_and_enable():
    engine.set_bulk_size(30)
    assert not engine.bulk_enabled()
    with engine.bulk(5):
        assert engine.bulk_enabled()
        assert engine.bulk_size() == 5
    assert engine.bulk_size() == 30
    assert not engine.bulk_enabled()
    assert not engine._bulk_on


# --- async tier --------------------------------------------------------------

@pytest.fixture
def async_on():
    prev = engine.set_async_enabled(True)
    yield
    engine._TLS.segment = None
    engine.set_async_enabled(prev)


@pytest.mark.parametrize("name", list(SWEEP))
def test_async_bulked_bit_identical_to_eager(name, async_on):
    _check_sweep(name, 2)


def _slow_build(monkeypatch):
    real = engine._build_segment_fn

    def slow(*a, **k):
        time.sleep(0.01)
        return real(*a, **k)

    monkeypatch.setattr(engine, "_build_segment_fn", slow)
    engine.clear_segment_cache()


def test_async_cross_flush_stitching_matches_eager(async_on, monkeypatch):
    _slow_build(monkeypatch)

    def chain(x):
        for i in range(12):
            x = x + (0.5 + i)
            x = x / 1.01
        return x

    a = _arr(seed=20)
    ref = chain(a).asnumpy()
    before = engine.async_stats()
    with engine.bulk(4):
        got = chain(a).asnumpy()
    after = engine.async_stats()
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_allclose(got, chain(_jarr(seed=20)).asnumpy(), **TOL)
    assert after["submitted"] > before["submitted"]
    assert after["stitched_segments"] > before["stitched_segments"]
    assert after["stitched_inputs"] > before["stitched_inputs"]


def test_async_worker_exception_names_op_at_materialization(
        async_on, monkeypatch):
    def boom(ops, n_slots, keep):
        raise RuntimeError("injected kernel failure")

    monkeypatch.setattr(engine, "_build_segment_fn", boom)
    engine.clear_segment_cache()
    a = _arr(seed=21)
    with engine.bulk(2):
        c = nd.tanh(a)
        c = c * 2.0
        with pytest.raises(mx.MXNetError, match="tanh"):
            c.asnumpy()
        with pytest.raises(mx.MXNetError, match="injected kernel failure"):
            engine._materialize(c._raw)


def test_async_flush_is_deterministic_drain(async_on, monkeypatch):
    _slow_build(monkeypatch)
    a = _arr(seed=22)
    with engine.bulk(2):
        c = a + 1.0
        c = c * 2.0
        d = c - 3.0
        d = d / 2.0
        assert engine._TLS.inflight
        engine.flush()
        assert not engine._TLS.inflight
        assert c._raw._segment.results is not None
        assert d._raw._segment.results is not None
    np.testing.assert_array_equal(
        d.asnumpy(), ((a.asnumpy() + 1.0) * 2.0 - 3.0) / 2.0)


def test_sanitizer_stale_read_through_async_segment(async_on):
    from mxnet_tpu_torch import sanitizer

    sanitizer.enable()
    try:
        a = _arr()
        sanitizer.donate([a._data], "async_donating_site")
        with engine.bulk(2):
            c = a + 1.0
            c = c * 2.0
            with pytest.raises(sanitizer.DonatedBufferError,
                               match="async_donating_site"):
                c.asnumpy()
    finally:
        sanitizer.reset()
        sanitizer.disable()


def test_async_interleaved_record_pause_grads_match():
    def run(pkg, eng, arr, use_async):
        a = arr(seed=23)
        prev = eng.set_async_enabled(use_async)
        try:
            w = pkg.nd.array(np.ones((3, 4), np.float32))
            w.attach_grad()
            with eng.bulk(4):
                pre = a * 0.5 + 1.0
                with pkg.autograd.record():
                    y = w * pre
                    with pkg.autograd.pause():
                        _ = (y + 1.0).sum().asnumpy()
                    loss = pkg.nd.tanh(y).sum()
                loss.backward()
                eng.flush()
            return w.grad.asnumpy()
        finally:
            eng.set_async_enabled(prev)

    sync, asy = run(mx, engine, _arr, False), run(mx, engine, _arr, True)
    np.testing.assert_array_equal(sync, asy)
    np.testing.assert_allclose(asy, run(jmx, jengine, _jarr, True), **TOL)


def test_async_queue_backpressure_bounds_depth(async_on, monkeypatch):
    real = engine._cache_lookup

    def slow(key):
        time.sleep(0.003)
        return real(key)

    monkeypatch.setattr(engine, "_cache_lookup", slow)
    submitted0 = engine.async_stats()["submitted"]
    a = _arr(seed=24)
    with engine.bulk(2):
        x = a
        for _ in range(30):
            x = x + 1.0
            x = x * 1.0
        got = x.asnumpy()
    stats = engine.async_stats()
    assert stats["submitted"] - submitted0 >= 30
    assert stats["max_queue_depth"] <= engine._ASYNC_QUEUE_MAX + 1
    assert engine._EXEC.q.qsize() == 0
    ref = a.asnumpy()
    for _ in range(30):
        ref = (ref + np.float32(1.0)) * np.float32(1.0)
    np.testing.assert_array_equal(got, ref)


def test_shutdown_async_drains_and_restarts_lazily(async_on):
    a = _arr(seed=25)
    with engine.bulk(2):
        c = a + 1.0
        c = c * 2.0
    engine.shutdown_async()
    assert not engine._TLS.inflight
    assert c._raw._segment.results is not None
    np.testing.assert_array_equal(c.asnumpy(), (a.asnumpy() + 1.0) * 2.0)
    with engine.bulk(2):
        d = a - 1.0
        d = d * 3.0
    np.testing.assert_array_equal(d.asnumpy(), (a.asnumpy() - 1.0) * 3.0)
    t = engine._EXEC._thread
    assert t is not None and t.is_alive()


def test_segment_cache_stats_thread_safe_under_async_load(async_on):
    a = _arr(seed=26)
    with engine.bulk(2):
        x = a
        for i in range(30):
            x = x + 1.0
            x = x * 1.0
            s = engine.segment_cache_stats()
            assert s["size"] >= 0 and s["hit"] >= 0 and s["miss"] >= 0
            if i % 10 == 5:
                engine.clear_segment_cache()
        got = x.asnumpy()
    ref = a.asnumpy()
    for _ in range(30):
        ref = (ref + np.float32(1.0)) * np.float32(1.0)
    np.testing.assert_array_equal(got, ref)


def test_async_wait_accounted_in_telemetry(async_on, monkeypatch):
    _slow_build(monkeypatch)
    telemetry.enable()
    try:
        a = _arr(seed=27)
        telemetry.step_begin()
        with engine.bulk(2):
            c = a + 1.0
            c = c * 2.0
            c.asnumpy()
        rec = telemetry.step_end()
        assert rec["bulk_async_wait_ms"] > 0
        assert rec["gauges"]["engine.async_queue_depth"] >= 1
    finally:
        telemetry.disable()


def test_env_async_disabled_restores_sync_bulking():
    r = _run_py(
        "import numpy as np\n"
        "import mxnet_tpu_torch as mx\n"
        "from mxnet_tpu_torch import engine, nd\n"
        "assert not engine.async_enabled()\n"
        "a = nd.array(np.ones((2, 2), np.float32), ctx=mx.cpu())\n"
        "with engine.bulk(2):\n"
        "    c = a + 1.0\n"
        "    c = c * 2.0\n"
        "    assert engine.pending_ops() == 0\n"
        "    assert c._raw.__class__ is not engine._PendingArray\n"
        "assert engine.async_stats()['submitted'] == 0\n"
        "assert engine._EXEC._thread is None\n"
        "assert (c.asnumpy() == 4).all()\n",
        MXNET_ENGINE_ASYNC="0")
    assert r.returncode == 0, r.stderr


def test_env_async_queue_size_honoured():
    r = _run_py(
        "from mxnet_tpu_torch import engine\n"
        "assert engine._ASYNC_QUEUE_MAX == 3, engine._ASYNC_QUEUE_MAX\n"
        "assert engine._EXEC.q.maxsize == 3\n",
        MXNET_ENGINE_ASYNC_QUEUE="3")
    assert r.returncode == 0, r.stderr


def test_naive_engine_bypasses_async(async_on):
    prev = engine.engine_type()
    engine.set_engine_type("NaiveEngine")
    try:
        before = engine.async_stats()["submitted"]
        a = _arr(seed=28)
        with engine.bulk(2):
            c = a + 1.0
            c = c * 2.0
            assert not _pending(c)
        assert engine.async_stats()["submitted"] == before
    finally:
        engine.set_engine_type(prev)


# --- the port's own entry points ---------------------------------------------

def test_dispatch_callbacks_fire_at_each_async_submit(async_on):
    seen = []
    cb = seen.append
    engine.register_dispatch_callback(cb)
    engine.register_dispatch_callback(cb)  # once only
    try:
        a = _arr(seed=29)
        with engine.bulk(2):
            c = (a + 1.0) * 2.0
            c.asnumpy()
    finally:
        engine.unregister_dispatch_callback(cb)
        engine.unregister_dispatch_callback(cb)  # a second time is fine
    assert seen == ["size"]


def test_cached_vjp_gives_the_ops_gradients():
    import torch

    x = torch.tensor(_np(seed=30))
    fun = torch.tanh
    assert engine.cached_vjp(fun, [x]) is None  # bulking off
    with engine.bulk(4):
        outs, vjp = engine.cached_vjp(fun, [x])
        (g,) = vjp(torch.ones_like(outs))
    np.testing.assert_allclose(g.numpy(), 1 - np.tanh(x.numpy()) ** 2,
                               rtol=1e-6, atol=1e-7)
    assert engine.maybe_defer(fun, (), "tanh") is None

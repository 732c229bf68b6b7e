"""The sanitizers of ``mxnet_tpu_torch.sanitizer`` against the reference's
``mxnet_tpu.sanitizer``.

Locks (``MXNET_SANITIZE_LOCKS``): the reference's unit cases run against
both packages (order edges, cycles, held-while-blocking events, the
Condition protocol through the proxy, the trace hook, the disabled
path's one-boolean bound), an A→B then B→A script gives the same
violation in both, and a served run with the sanitizer on records the
same order edges in both packages with no violation and no
held-while-blocking event.

Donation (``MXNET_SANITIZE_DONATION``): a caller's own ``donate()`` makes
the next read through any NDArray holding the tensor raise the
reference's error with the reference's message, at each of the
reference's read sites.  The port's updates are in place (the fused
update kernel and ``FusedTrainStep`` write into the weights' own
tensors), so where the reference raises on a view taken before a step,
the port reads the updated weights: one test per stale-view case of the
reference's ``tests/test_sanitizer.py`` pins that difference.
"""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import sanitizer as jsan
from mxnet_tpu_torch import sanitizer as tsan

CPU = tmx.cpu()
PKGS = {"jax": jsan, "torch": tsan}


@pytest.fixture(autouse=True)
def _clean():
    for san in PKGS.values():
        san.reset_locks()
        san.reset()
    yield
    for san in PKGS.values():
        san.set_trace_hook(None)
        san.disable_locks()
        san.reset_locks()
        san.disable()


@pytest.fixture(params=sorted(PKGS))
def san(request):
    return PKGS[request.param]


# --- locks: the reference's unit cases, in both packages --------------------

def test_env_var_gate(san, monkeypatch):
    for val, want in [("1", True), ("on", True), ("TRUE", True),
                      ("0", False), ("off", False), ("", False),
                      ("no", False)]:
        monkeypatch.setenv("MXNET_SANITIZE_LOCKS", val)
        assert san._locks_env_on() is want, val
    monkeypatch.delenv("MXNET_SANITIZE_LOCKS")
    assert san._locks_env_on() is False


def test_order_edges_recorded_for_nested_acquisition(san):
    san.enable_locks()
    a = san.wrap_lock(threading.Lock(), "t.san.A")
    b = san.wrap_lock(threading.Lock(), "t.san.B")
    with a:
        with b:
            pass
    edges = san.lock_order_edges()
    assert ("t.san.A", "t.san.B") in edges
    assert ("t.san.B", "t.san.A") not in edges
    assert san.lock_order_violations() == []


def _opposite_orders(san):
    a = san.wrap_lock(threading.Lock(), "t.cyc.A")
    b = san.wrap_lock(threading.Lock(), "t.cyc.B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return san.lock_order_violations(), san.lock_order_edges()


def test_opposite_orders_give_the_same_violation_in_both_packages():
    got = {}
    for name, san in PKGS.items():
        san.enable_locks()
        got[name] = _opposite_orders(san)
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][0] and {"t.cyc.A", "t.cyc.B"} <= \
        set(got["torch"][0][0])
    assert set(got["torch"][1]) == set(got["jax"][1])


def test_held_while_blocking_event_recorded(san):
    san.enable_locks()
    x = san.wrap_lock(threading.Lock(), "t.blk.X")
    y = san.wrap_lock(threading.Lock(), "t.blk.Y")
    holding = threading.Event()
    release = threading.Event()

    def holder():
        with x:
            holding.set()
            release.wait(10)

    t = threading.Thread(target=holder, name="mxt-test-holder",
                         daemon=True)
    t.start()
    assert holding.wait(10)
    with y:
        assert not x.acquire(timeout=0.2)   # contended while holding y
    release.set()
    t.join(timeout=10)
    assert ("t.blk.Y", "t.blk.X", threading.current_thread().name) \
        in san.held_blocking_events()


def test_condition_wait_pops_held_stack(san):
    """A ``wait`` through the proxy releases and re-takes the lock in the
    held stack, so a scheduler's waits never read as held-while-
    blocking."""
    san.enable_locks()
    cond = san.wrap_lock(threading.Condition(), "t.cond.C")
    other = san.wrap_lock(threading.Lock(), "t.cond.L")
    fired = []

    def notifier():
        with cond:
            fired.append(True)
            cond.notify_all()

    t = threading.Timer(0.05, notifier)
    t.start()
    with cond:
        assert cond.wait_for(lambda: fired, timeout=10)
        with other:
            pass
        assert cond.wait(0.01) is False
    t.join()
    assert ("t.cond.C", "t.cond.L") in san.lock_order_edges()
    assert san.lock_order_violations() == []
    assert san.held_blocking_events() == []


def test_trace_hook_sees_acquire_stream_and_restores(san):
    san.enable_locks()
    a = san.wrap_lock(threading.Lock(), "t.hook.A")
    events = []
    prev = san.set_trace_hook(lambda ev, name: events.append((ev, name)))
    try:
        with a:
            pass
    finally:
        restored = san.set_trace_hook(prev)
    assert events == [("acquire", "t.hook.A"), ("acquired", "t.hook.A"),
                      ("released", "t.hook.A")]
    assert restored is not None


def test_reset_forgets_edges_keeps_enabled_state(san):
    san.enable_locks()
    a = san.wrap_lock(threading.Lock(), "t.rst.A")
    b = san.wrap_lock(threading.Lock(), "t.rst.B")
    with a, b:
        pass
    assert san.lock_order_edges()
    san.reset_locks()
    assert san.lock_order_edges() == {}
    assert san.held_blocking_events() == []
    assert san.locks_enabled()


def test_delegation_surface(san):
    san.enable_locks()
    lk = san.wrap_lock(threading.RLock(), "t.del.R")
    assert lk.acquire()
    assert lk.acquire()          # reentrant through the proxy
    lk.release()
    lk.release()
    assert "t.del.R" in repr(lk)
    c = san.wrap_lock(threading.Condition(), "t.del.C")
    with c:
        c.notify_all()           # __getattr__ delegation


def test_disabled_path_is_one_boolean_check(san):
    """Off, acquire/release cost one global read plus delegation: the
    reference's bound (``tests/test_sanitizer_locks.py``)."""
    san.disable_locks()
    lk = san.wrap_lock(threading.Lock(), "t.fast.L")
    t0 = time.perf_counter()
    for _ in range(10_000):
        with lk:
            pass
    assert time.perf_counter() - t0 < 0.5
    assert san.lock_order_edges() == {}


def test_the_ported_modules_wrap_the_reference_lock_names():
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.serving import lanes, scheduler
    from mxnet_tpu_torch.telemetry import capacity, fleet

    names = {capacity._lock.name, fleet._lock.name, fleet._ring_lock.name,
             checkpoint._STAGE_LOCK.name,
             checkpoint._DEFAULT_ASYNC_LOCK.name,
             checkpoint.AsyncCheckpointer()._lock.name,
             scheduler.RequestQueue(1)._cond.name}
    assert names == {"capacity._lock", "fleet._lock", "fleet._ring_lock",
                     "checkpoint._STAGE_LOCK",
                     "checkpoint._DEFAULT_ASYNC_LOCK",
                     "checkpoint.AsyncCheckpointer._lock",
                     "scheduler.RequestQueue._cond"}
    assert "lanes.DecodeLane._hand_lock" in open(lanes.__file__).read()


def _serve(pkg, serving, telemetry, net):
    """Two waves of the tiny net's server with capacity accounting on
    (its lock joins the graph)."""
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, 250, size=n) for n in (5, 9, 12, 7)]
    telemetry.enable(memory=False, cost=False, capacity=True)
    cfg = serving.ServerConfig(max_batch=2, max_length=64, min_length=8,
                               num_slots=2)
    try:
        with serving.GenerativeServer(net, cfg) as srv:
            futs = [srv.submit(p, max_new_tokens=4) for p in prompts[:2]]
            [f.result(120) for f in futs]
            futs = [srv.submit(p, max_new_tokens=4) for p in prompts[2:]]
            return [f.result(120) for f in futs]
    finally:
        telemetry.disable()


def test_a_served_run_records_the_reference_edges_and_no_violation():
    from mxnet_tpu import serving as jserving, telemetry as jtel
    from mxnet_tpu.models.llama import llama_tiny as jtiny
    from mxnet_tpu_torch import serving as tserving, telemetry as ttel
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.models.llama import llama_tiny as ttiny

    jnet = jtiny()
    jnet.initialize(jmx.init.Xavier())
    weights = {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()}
    tnet = ttiny()
    load_numpy_params(tnet, weights, ctx=CPU)
    edges, replies = {}, {}
    for name, (san, serving, tel, net) in {
            "jax": (jsan, jserving, jtel, jnet),
            "torch": (tsan, tserving, ttel, tnet)}.items():
        san.enable_locks()
        san.reset_locks()
        replies[name] = _serve(name, serving, tel, net)
        edges[name] = set(san.lock_order_edges())
        assert san.lock_order_violations() == [], name
        assert san.held_blocking_events() == [], name
        san.disable_locks()
    assert edges["torch"] == edges["jax"]
    for a, b in zip(replies["torch"], replies["jax"]):
        np.testing.assert_array_equal(a, b)


# --- donation: the API and its read sites ------------------------------------

def _donated_message(san, nd, ctx):
    """The message a read of a donated buffer raises in one package."""
    san.enable()
    a = nd.array(np.arange(4, dtype=np.float32), ctx=ctx) if ctx else \
        nd.array(np.arange(4, dtype=np.float32))
    san.donate([a._data], "Example.site")
    with pytest.raises(san.DonatedBufferError) as ei:
        a.asnumpy()
    return str(ei.value)


def test_donate_gives_the_reference_error_and_message():
    want = _donated_message(jsan, jmx.nd, None)
    got = _donated_message(tsan, tmx.nd, CPU)
    assert got == want
    assert "used after donation at Example.site" in got


@pytest.mark.parametrize("site", ["asnumpy", "wait_to_read", "copyto",
                                  "asnative", "wrap", "operand"])
def test_every_read_site_checks_the_donated_tensor(site):
    tsan.enable()
    a = tmx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=CPU)
    view = tmx.nd.NDArray.__new__(tmx.nd.NDArray)
    view._data = a._data          # another holder of the same tensor
    tsan.donate([a._data], "Example.donate")
    assert view._donated == "Example.donate"
    reads = {
        "asnumpy": lambda: view.asnumpy(),
        "wait_to_read": lambda: view.wait_to_read(),
        "copyto": lambda: view.copyto(tmx.nd.zeros((2, 3), ctx=CPU)),
        "asnative": lambda: view.asnative(),
        "wrap": lambda: tmx.nd.NDArray(view),
        "operand": lambda: view + 1,
    }
    match = "operand of" if site == "operand" else site
    with pytest.raises(tsan.DonatedBufferError, match=match):
        reads[site]()
    # a fresh tensor in the holder is clean by construction
    view._data = a._data.clone()
    assert view._donated is None
    np.testing.assert_array_equal(view.asnumpy(),
                                  np.arange(6).reshape(2, 3))


def test_disabled_donation_records_nothing():
    tsan.disable()
    a = tmx.nd.ones((2,), ctx=CPU)
    tsan.donate([a._data], "Example.site")
    assert a._donated is None and tsan._donated == {}
    assert a.asnumpy().tolist() == [1.0, 1.0]


def test_a_collected_tensor_leaves_the_registry():
    import gc

    tsan.enable()
    a = tmx.nd.ones((2,), ctx=CPU)
    tsan.donate([a._data, None], "Example.site")
    assert len(tsan._donated) == 1
    del a
    gc.collect()
    assert tsan._donated == {}


# --- donation: the reference's stale views, which the port updates ----------

def _mlp_pair():
    """The reference's test MLP in both packages, with the same weights."""
    from mxnet_tpu_torch.convert import load_numpy_params

    jnet = jmx.gluon.nn.HybridSequential()
    jnet.add(jmx.gluon.nn.Dense(16, activation="relu"),
             jmx.gluon.nn.Dense(4))
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.ones((1, 6)))
    tnet = tmx.gluon.nn.HybridSequential()
    tnet.add(tmx.gluon.nn.Dense(16, activation="relu"),
             tmx.gluon.nn.Dense(4))
    tnet.initialize(ctx=CPU)
    tnet(tmx.nd.ones((1, 6), ctx=CPU))
    load_numpy_params(tnet, {k: p.data().asnumpy() for k, p in
                             jnet._collect_params_with_prefix().items()},
                      ctx=CPU)
    return jnet, tnet


def _data(mx, ctx=None):
    rng = np.random.RandomState(0)
    x, y = rng.randn(8, 6).astype(np.float32), rng.randint(0, 4, (8,))
    kw = {"ctx": ctx} if ctx is not None else {}
    return mx.nd.array(x, **kw), mx.nd.array(y, **kw)


def _backward(mx, net, x, y):
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()


def _stale_after(mx, net, step_fn, ctx=None):
    x, y = _data(mx, ctx)
    _backward(mx, net, x, y)
    param = next(iter(net.collect_params().values()))
    stale = param.data().detach()
    before = stale.asnumpy().copy()
    step_fn(x, y)
    return param, stale, before


@pytest.mark.parametrize("case", ["read", "operand", "donated_property"])
def test_stale_view_after_fused_trainer_step_reads_the_update(case):
    """Reference ``test_stale_view_after_fused_trainer_step_raises``,
    ``..._poisons_op_dispatch_too`` and ``test_rebind_clears_poison...``:
    there a view taken before ``trainer.step`` raises; the port's fused
    update writes into the weight's own tensor, so the view reads the
    updated weight."""
    jnet, tnet = _mlp_pair()
    for san in PKGS.values():
        san.enable()
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    jp, jstale, _ = _stale_after(jmx, jnet, lambda x, y: jtr.step(8))
    with pytest.raises(jsan.DonatedBufferError, match="used after"):
        (jstale + 1) if case == "operand" else jstale.asnumpy()
    assert jstale._donated is not None
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    tp, tstale, before = _stale_after(tmx, tnet, lambda x, y: ttr.step(8),
                                      CPU)
    now = tp.data().asnumpy()
    assert not np.array_equal(now, before)
    if case == "operand":
        np.testing.assert_array_equal((tstale + 1).asnumpy(), now + 1)
    elif case == "read":
        np.testing.assert_array_equal(tstale.asnumpy(), now)
    else:
        assert tstale._donated is None and tp.data()._donated is None
    # the live weights agree across the packages after the step
    np.testing.assert_allclose(now, jp.data().asnumpy(), rtol=1e-5,
                               atol=1e-6)


def test_stale_view_after_fused_train_step_reads_the_update():
    """Reference ``test_stale_view_after_fused_train_step_raises``: the
    port's ``FusedTrainStep`` writes into the weights in place."""
    jnet, tnet = _mlp_pair()
    for san in PKGS.values():
        san.enable()
    got = {}
    for name, mx, net, ctx in (("jax", jmx, jnet, None),
                               ("torch", tmx, tnet, CPU)):
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        x, y = _data(mx, ctx)
        _backward(mx, net, x, y)
        trainer.step(8)
        step = mx.gluon.FusedTrainStep(
            net, trainer, lambda n, a, b: loss_fn(n(a), b),
            steps_per_execution=2, batch_size=8, stacked_inputs=False)
        param = next(iter(net.collect_params().values()))
        stale = param.data().detach()
        step(x, y)
        got[name] = (param, stale)
    with pytest.raises(jsan.DonatedBufferError, match="FusedTrainStep"):
        got["jax"][1].wait_to_read()
    tp, tstale = got["torch"]
    tstale.wait_to_read()
    np.testing.assert_array_equal(tstale.asnumpy(), tp.data().asnumpy())


def test_stale_view_after_per_param_update_reads_the_update():
    """Reference ``test_stale_view_after_per_param_update_raises``."""
    for san in PKGS.values():
        san.enable()
    w0 = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    g0 = np.random.RandomState(2).randn(8, 4).astype(np.float32)
    out = {}
    for name, mx, kw in (("jax", jmx, {}), ("torch", tmx, {"ctx": CPU})):
        opt = mx.optimizer.create("adam", learning_rate=1e-3)
        weight, grad = mx.nd.array(w0, **kw), mx.nd.array(g0, **kw)
        state = opt.create_state(0, weight)
        stale = weight.detach()
        opt.update(0, weight, grad, state)
        out[name] = (weight, stale)
    with pytest.raises(jsan.DonatedBufferError, match="_update_impl"):
        out["jax"][1].asnumpy()
    tw, tstale = out["torch"]
    assert tw._donated is None and tstale._donated is None
    np.testing.assert_array_equal(tstale.asnumpy(), tw.asnumpy())
    np.testing.assert_allclose(tw.asnumpy(), out["jax"][0].asnumpy(),
                               rtol=1e-6, atol=1e-7)

"""Memory as a managed budget in the PyTorch/CUDA port
(``mxnet_tpu_torch.memory``) against the JAX package's, on the CPU.

Mirrors ``tests/test_memory_plan.py``: the planner's bytes equal the
reference's ``plan_model`` on the same shapes (optimizers, tiers,
offload, a ``tp`` mesh with rules), the planner lands within 10% of the
port's memwatch ledger, the auto policy climbs the tier ladder only when
the budget forces it, host offload is numerically invisible (fused and
eager, under the sanitizer), an OOM comes back with the cheapest fix,
the committed lowering artifacts give the reference test's figures, and
the KV pool planner predicts a live engine's pool.  The remat tiers are
``tests/test_torch_remat.py``'s.
"""
import gc
import json
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import memory as jmemory
from mxnet_tpu.models import llama as jllama
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, gluon, memory, nd, sanitizer
from mxnet_tpu_torch.memory import offload, planner, policy
from mxnet_tpu_torch.models import llama as tllama
from mxnet_tpu_torch.telemetry import memwatch

CPU = tmx.cpu()
REPO = os.path.join(os.path.dirname(__file__), "..")
MB = 2 ** 20


@pytest.fixture(autouse=True)
def _isolate_memory_state():
    yield
    for mem in (memory, jmemory):
        mem.planner.set_budget(None)
        mem.policy.reset()
        mem.offload.reset()
    memwatch.disable()
    # a mesh trainer leaves its placement summary, which step records read
    from mxnet_tpu_torch.parallel import partition

    tmx.parallel.set_mesh(None)
    partition._LAST_PLACEMENT = None


def _tiny_shapes(dtype=None):
    """``llama_tiny``'s parameters as ``{name: (shape, dtype)}`` (the
    structural names are the same in both packages)."""
    net = tllama.llama_tiny()
    net.initialize(ctx=CPU)
    return {n: (p.shape, dtype or "float32")
            for n, p in net._collect_params_with_prefix().items()}


def _opts(name):
    """(port optimizer, reference optimizer) for a spelling."""
    if name in (None, "sgd", "adam"):
        return name, name
    kw = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}
    return tmx.optimizer.create("sgd", **kw), jmx.optimizer.create("sgd",
                                                                   **kw)


# -- planner bytes against the reference --------------------------------------

@pytest.mark.parametrize("opt", [None, "sgd", "adam", "sgd_mp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planner_bytes_equal_the_reference(opt, dtype):
    """Every plan field of ``plan_model`` — peak, breakdown, top buffers
    — equals the reference's on the same shapes, across the tiers, with
    and without host offload, a measured activation hint and a KV pool."""
    shapes = _tiny_shapes(dtype)
    topt, jopt = _opts(opt)
    for remat in ("none", "dots", "layer"):
        for off in (None, "host"):
            for hint in (None, 3 * MB):
                kw = dict(batch_bytes=2 * 16 * 64 * 4, remat=remat,
                          offload=off, activation_hint=hint,
                          use_registry=False, kv_pool_bytes=4096)
                t = planner.plan_model(shapes, optimizer=topt, **kw)
                j = jmemory.planner.plan_model(shapes, optimizer=jopt, **kw)
                assert t.as_dict() == j.as_dict(), (remat, off, hint)
    # the last plan (bf16 shapes included) prescribes as the reference's
    assert planner.prescribe(t) == jmemory.prescribe(j)
    # inference plans halve the prior
    t = planner.plan_model(shapes, training=False, batch_bytes=1024)
    j = jmemory.planner.plan_model(shapes, training=False, batch_bytes=1024)
    assert t.as_dict() == j.as_dict()


@pytest.mark.parametrize("mesh_shape,rules", [
    ({"tp": 2}, "llama"), ({"dp": 2, "tp": 2}, "llama"),
    ({"tp": 4}, ((r".*q_proj.*", ("tp", None)),))])
def test_planner_shards_by_the_rule_engine_as_the_reference(mesh_shape,
                                                           rules):
    """On a ``tp`` mesh with partition rules each parameter's bytes are
    divided as the reference's rule engine divides them (the port's own
    ``parallel.partition``), and the batch over ``dp``."""
    shapes = _tiny_shapes()
    mesh = types.SimpleNamespace(shape=mesh_shape)
    for remat in ("none", "layer"):
        kw = dict(mesh=mesh, rules=rules, optimizer="adam",
                  batch_bytes=4 * 16 * 64 * 4, remat=remat,
                  use_registry=False)
        t = planner.plan_model(shapes, **kw)
        j = jmemory.planner.plan_model(shapes, **kw)
        assert t.as_dict() == j.as_dict()
    full = planner.plan_model(shapes, optimizer="adam", use_registry=False)
    assert t.breakdown["params"] < full.breakdown["params"]


def test_budget_is_the_cards_or_the_reference_default(monkeypatch):
    """Without a card the budget is 16 GiB (the reference's CPU
    default); ``MXNET_HBM_BUDGET`` and ``set_budget`` override it."""
    assert planner.budget_bytes() == jmemory.planner.budget_bytes() == \
        16 * 2 ** 30
    monkeypatch.setenv("MXNET_HBM_BUDGET", "12345")
    assert planner.budget_bytes() == 12345
    planner.set_budget(777)
    assert planner.budget_bytes() == 777
    with pytest.raises(tmx.MXNetError, match="Not carried over"):
        planner.DEVICE_BUDGET_GIB


def test_dtypes_numpy_lacks_are_sized_by_torch(monkeypatch):
    """Without ``ml_dtypes`` (the card's machine has no JAX) numpy does
    not know bfloat16: the planner sizes it by torch's dtype, and a plan
    over such shapes re-plans (``prescribe``) with the same bytes."""
    real = np.dtype

    def no_bf16(d):
        if str(d) == "bfloat16":
            raise TypeError("data type 'bfloat16' not understood")
        return real(d)

    want = planner.plan_model({"w": ((64, 32), "bfloat16")},
                              optimizer="adam", use_registry=False)
    monkeypatch.setattr(planner.np, "dtype", no_bf16)
    for spelling in (torch.bfloat16, "bfloat16"):
        got = planner.plan_model({"w": ((64, 32), spelling)},
                                 optimizer="adam", use_registry=False)
        assert got.as_dict() == want.as_dict()
        assert planner.prescribe(got)["candidates"] == \
            planner.prescribe(want)["candidates"]


# -- planner accuracy ---------------------------------------------------------

def _params_dominated_lane(optimizer, opt_kwargs):
    """Train a params-dominated MLP under the memwatch ledger and return
    (plan, measured_live_bytes) — the reference test's lane."""
    hidden, layers, batch = 1024, 4, 4
    memwatch.enable()
    tmx.random.seed(11)
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        for _ in range(layers):
            net.add(gluon.nn.Dense(hidden, activation="relu"))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net(nd.ones((1, hidden), ctx=CPU))
    net.hybridize(static_alloc=True)
    trainer = gluon.Trainer(net.collect_params(), optimizer, opt_kwargs)
    x = tmx.random.uniform(shape=(batch, hidden), ctx=CPU)
    y = tmx.random.uniform(shape=(batch, hidden), ctx=CPU)
    loss_fn = gluon.loss.L2Loss()
    for _ in range(2):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(batch)
    nd.waitall()
    del loss
    gc.collect()
    live = memwatch.live_bytes()
    plan = planner.plan_model(
        net.collect_params(), optimizer=trainer._optimizer,
        batch_bytes=2 * batch * hidden * 4, remat="none",
        use_registry=False)
    return plan, live


@pytest.mark.parametrize("optimizer,opt_kwargs,n_state", [
    ("sgd", {"learning_rate": 0.01, "momentum": 0.9}, 1),
    ("adam", {"learning_rate": 1e-3}, 2),
])
def test_planner_within_10pct_of_memwatch(optimizer, opt_kwargs, n_state):
    plan, live = _params_dominated_lane(optimizer, opt_kwargs)
    assert plan.fits
    assert plan.breakdown["optimizer_state"] == \
        n_state * plan.breakdown["params"]
    err = abs(plan.predicted_peak_bytes - live) / live
    assert err <= 0.10, (
        f"planner {plan.predicted_peak_bytes} vs memwatch {live} "
        f"({err:.1%} off)\nbreakdown: {plan.breakdown}")
    # the verdict names the offenders and is recorded for the JSONL
    assert planner.last_plan() is plan
    assert any("weight" in b["name"] for b in plan.top_buffers)
    assert memory.telemetry_fields()["predicted_peak_bytes"] == \
        plan.predicted_peak_bytes


def test_the_last_plan_keeps_no_model_alive():
    """A plan keeps its optimizer's description, not the optimizer, which
    holds the parameters: the recorded last plan must not keep a model's
    weights alive (on the card, the next model would not fit beside
    them); it still prescribes as the reference's does."""
    import weakref

    net = gluon.nn.Dense(4, in_units=3)
    net.initialize(ctx=CPU)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    alive = weakref.ref(net.weight)
    plan = planner.plan_model(net.collect_params(), optimizer=tr._optimizer,
                              activation_hint=MB, use_registry=False)
    del net, tr
    gc.collect()
    assert alive() is None and planner.last_plan() is plan
    jplan = jmemory.planner.plan_model(
        {"weight": ((4, 3), np.float32), "bias": ((4,), np.float32)},
        optimizer=jmx.optimizer.create("sgd", momentum=0.9),
        activation_hint=MB, use_registry=False)
    assert planner.prescribe(plan)["candidates"] == \
        jmemory.prescribe(jplan)["candidates"]


# -- auto-remat tier ladder ---------------------------------------------------

def test_auto_tier_headroom_stays_on_none_budget_escalates():
    """The reference test's ladder, each decision and plan equal to the
    reference's."""
    params = {"w": ((256, 256), np.float32)}
    kw = dict(batch_bytes=1024, activation_hint=10 * MB)
    for budget, want, fits in ((None, "none", True), (5 * MB, "dots", True),
                               (5 * MB // 2, "layer", True),
                               (MB // 4, "layer", False)):
        for mem in (memory, jmemory):
            mem.planner.set_budget(budget)
        tier, plan = policy.auto_tier(params, **kw)
        jtier, jplan = jmemory.policy.auto_tier(params, **kw)
        assert (tier, plan.fits) == (jtier, jplan.fits) == (want, fits)
        assert plan.as_dict() == jplan.as_dict()
        assert policy.last_policy() == jmemory.policy.last_policy()
    assert policy.last_policy()["mode"] == "auto"
    assert memory.telemetry_fields()["remat_policy"] == "layer"


def test_tier_spellings_normalize_and_garbage_raises():
    for spelling in (None, False, True, "full", "per_layer", "per-layer",
                     "dots_saveable", "auto", "none", "dots", "layer"):
        assert policy.normalize(spelling) == \
            jmemory.policy.normalize(spelling)
    assert policy.normalize(True) == "layer"
    with pytest.raises(ValueError):
        policy.normalize("everything")
    with pytest.raises(ValueError):
        policy.checkpoint_wrap(lambda x: x, "auto")  # resolve first
    fn = lambda x: x  # noqa: E731
    assert policy.checkpoint_wrap(fn, "none") is fn
    assert memory.TIERS == jmemory.TIERS
    assert sorted(memory.__all__) == sorted(jmemory.__all__)


# -- host-offloaded optimizer state -------------------------------------------

def _bf16_net():
    tmx.random.seed(0)
    net = gluon.nn.Dense(8)
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net.cast("bfloat16")
    net(nd.ones((4, 6), dtype="bfloat16", ctx=CPU))
    return net


def _bf16_step(net, trainer, seed):
    rs = np.random.RandomState(seed)
    x = nd.array(rs.randn(4, 6).astype(np.float32),
                 ctx=CPU).astype("bfloat16")
    with autograd.record():
        loss = (net(x) ** 2).mean()
    loss.backward()
    trainer.step(4)


_MP_SGD = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}


@pytest.mark.parametrize("route", ["fused", "fused_grouped", "eager"])
def test_offload_host_matches_on_device_oracle(route, monkeypatch):
    """``Trainer(offload="host")`` keeps momentum and the f32 masters
    host-resident between steps; the weights equal the on-device
    oracle's bit for bit at every step, on the fused route (one group,
    and one group a parameter) and the eager one, under the sanitizer;
    traffic is booked both ways and ``offload_bytes`` reports it."""
    offload.reset()
    sanitizer.enable()
    try:
        oracle = _bf16_net()
        tr_o = gluon.Trainer(oracle.collect_params(), "sgd", _MP_SGD)
        offed = _bf16_net()
        tr_f = gluon.Trainer(offed.collect_params(), "sgd", _MP_SGD,
                             offload="host")
        if route == "fused":
            monkeypatch.setattr(gluon.Trainer, "_offload_groups",
                                lambda self, live: [list(live)])
        if route == "fused_grouped":
            # weight and bias hold equal aligned state: a group each
            for i in tr_f._live():
                tr_f._init_states(i)
            assert tr_f._offload_groups(tr_f._live()) == \
                [[i] for i in tr_f._live()]
        if route == "eager":
            tr_f._try_fused_update = lambda: False
        for s in range(5):
            _bf16_step(oracle, tr_o, s)
            _bf16_step(offed, tr_f, s)
            assert offload.resident_bytes() > 0
            for p, q in zip(oracle.collect_params().values(),
                            offed.collect_params().values()):
                assert torch.equal(p.data()._data, q.data()._data)
            for i in tr_f._live():
                assert all(offload.is_stashed(a)
                           for a in tr_f._offloaded_ndarrays(i))
        st = offload.stats()
        # master (8x6 + 8) and momentum (the same) in f32, host-resident
        assert st["resident_bytes"] == 2 * 4 * (8 * 6 + 8)
        assert st["h2d_bytes_total"] > 0 and st["d2h_bytes_total"] > 0
        assert memory.telemetry_fields()["offload_bytes"] == \
            st["resident_bytes"]
        # the states read back through save_states equal the oracle's
        states = [tr._states_payload()["states"] for tr in (tr_o, tr_f)]
        for i in states[0]:
            for a, b in zip(states[0][i], states[1][i]):
                np.testing.assert_array_equal(np.asarray(a, "f"),
                                              np.asarray(b, "f"))
    finally:
        sanitizer.disable()


def test_offload_groups_cut_the_table_by_bytes():
    """Groups are consecutive, each at most the largest live parameter's
    offloaded state, and cover every live parameter; the staging buffer
    is that parameter's state and no larger."""
    net = gluon.nn.HybridSequential()
    for u in (16, 32, 8):
        net.add(gluon.nn.Dense(u))
    net.initialize(ctx=CPU)
    net(nd.ones((2, 4), ctx=CPU))
    tr = gluon.Trainer(net.collect_params(), "sgd", {"momentum": 0.9},
                       offload="host")
    live = tr._live()
    for i in live:
        tr._init_states(i)
    sizes = [sum(gluon.trainer._stage_bytes(a)
                 for a in tr._offloaded_ndarrays(i)) for i in live]
    limit = max(sizes)
    assert limit == gluon.trainer._stage_bytes(
        tr._offloaded_ndarrays(live[2])[0])  # the 32 x 16 weight
    groups = tr._offload_groups(live)
    assert [i for g in groups for i in g] == live
    for g in groups:
        assert sum(sizes[live.index(i)] for i in g) <= limit
    assert 1 < len(groups) < len(live)
    assert tr._stage(groups, torch.device("cpu")).numel() == limit


def _mlp_bf16(seed):
    tmx.random.seed(seed)
    net = gluon.nn.HybridSequential()
    for u in (16, 12, 8):
        net.add(gluon.nn.Dense(u))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net.cast("bfloat16")
    net(nd.ones((4, 6), dtype="bfloat16", ctx=CPU))
    return net


def test_offload_follows_a_live_set_that_grows():
    """A layer frozen for the first steps and unfrozen later joins the
    offloaded table at the front (its state is made mid-training): the
    weights and states equal the on-device trainer's bit for bit at
    every step, before and after, and every state is host-resident
    again after each step."""
    offload.reset()
    nets = [_mlp_bf16(3), _mlp_bf16(3)]
    trainers = [gluon.Trainer(n.collect_params(), "sgd", _MP_SGD,
                              offload=off)
                for n, off in zip(nets, (None, "host"))]
    for s in range(5):
        frozen = s < 2
        for net in nets:
            for p in net[0].collect_params().values():
                p.grad_req = "null" if frozen else "write"
        for net, tr in zip(nets, trainers):
            _bf16_step(net, tr, s)
        tr = trainers[1]
        assert len(tr._live()) == (4 if frozen else 6)
        if not frozen:
            groups = tr._offload_groups(tr._live())
            assert len(groups) > 1 and groups[0][0] == tr._live()[0]
        for p, q in zip(nets[0].collect_params().values(),
                        nets[1].collect_params().values()):
            assert torch.equal(p.data()._data, q.data()._data), (s, p.name)
        for i in tr._live():
            assert all(offload.is_stashed(a)
                       for a in tr._offloaded_ndarrays(i))
    states = [t._states_payload()["states"] for t in trainers]
    for i in states[0]:
        for a, b in zip(states[0][i], states[1][i]):
            np.testing.assert_array_equal(np.asarray(a, "f"),
                                          np.asarray(b, "f"))


def test_fused_train_step_over_an_offloading_trainer():
    """As in the reference, a ``FusedTrainStep`` takes the optimizer
    states where they are and returns them on the device: its first call
    fetches them (released from the host books) and they stay there; the
    weights equal a ``FusedTrainStep`` over an on-device trainer; a later
    eager ``Trainer.step`` stashes them again."""
    offload.reset()
    loss_fn = lambda n, x: (n(x) ** 2).mean()  # noqa: E731
    x = nd.array(np.random.RandomState(1).randn(4, 6).astype(np.float32),
                 ctx=CPU).astype("bfloat16")
    nets, trainers = [_bf16_net(), _bf16_net()], []
    for net, off in zip(nets, (None, "host")):
        tr = gluon.Trainer(net.collect_params(), "sgd", _MP_SGD,
                           offload=off)
        trainers.append(tr)
        _bf16_step(net, tr, 0)  # makes the states
        fstep = gluon.FusedTrainStep(net, tr, loss_fn,
                                     steps_per_execution=2, batch_size=4)
        fstep(x)
        fstep(x)
    assert offload.resident_bytes() == 0
    tr = trainers[1]
    for i in tr._live():
        assert not any(offload.is_stashed(a)
                       for a in tr._offloaded_ndarrays(i))
    for p, q in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        assert torch.equal(p.data()._data, q.data()._data)
    _bf16_step(nets[0], trainers[0], 1)
    _bf16_step(nets[1], tr, 1)
    assert offload.resident_bytes() == 2 * 4 * (8 * 6 + 8)
    for p, q in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        assert torch.equal(p.data()._data, q.data()._data)


def test_offload_rejects_unknown_target():
    net = _bf16_net()
    with pytest.raises(tmx.MXNetError, match="offload must be"):
        gluon.Trainer(net.collect_params(), "sgd", _MP_SGD, offload="nvme")
    # refused until slice 23, which ported offload over a mesh: the
    # states stay host shards between steps, and the weights equal an
    # on-device mesh trainer's
    oracle = _bf16_net()
    try:
        mesh = tmx.parallel.make_mesh({"dp": 1}, devices="cpu")
        trs = [gluon.Trainer(n.collect_params(), "sgd", _MP_SGD,
                             offload=off, mesh=mesh)
               for n, off in ((oracle, None), (net, "host"))]
        for s in range(2):
            _bf16_step(oracle, trs[0], s)
            _bf16_step(net, trs[1], s)
        assert all(offload.is_stashed(a) for i in trs[1]._live()
                   for a in trs[1]._offloaded_ndarrays(i))
        for p, q in zip(oracle.collect_params().values(),
                        net.collect_params().values()):
            assert torch.equal(p.data()._data.to_local(),
                               q.data()._data.to_local())
    finally:
        tmx.parallel.shutdown()


# -- OOM prescription ---------------------------------------------------------

def test_oom_comes_back_with_cheapest_fix(tmp_path):
    """An allocation failure names the cheapest re-planned fix (here
    ``remat="layer"``) in the raised ``OOMError`` and in the post-mortem,
    whose prescription equals the reference's for the same plan."""
    report = tmp_path / "post.json"
    memwatch.enable(report_path=str(report))
    for mem in (memory, jmemory):
        mem.planner.set_budget(4 * MB)
    kw = dict(optimizer="sgd", batch_bytes=0, remat="none",
              activation_hint=4 * MB, use_registry=False)
    plan = planner.plan_model({"w": ((512, 512), np.float32)}, **kw)
    assert not plan.fits
    err = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 4.00 MiB")
    with pytest.raises(memwatch.OOMError) as ei:
        memwatch.annotate_oom(err, context="test dispatch")
    msg = str(ei.value)
    assert "cheapest fix that fits" in msg and 'remat="layer"' in msg
    rx = json.loads(report.read_text())["prescription"]
    assert rx["recommendation"]["change"] == 'remat="layer"'
    assert rx["recommendation"]["fits"]
    changes = [c["change"] for c in rx["candidates"]]
    assert 'offload="host"' in changes and "halve the batch" in changes
    jmemory.planner.plan_model({"w": ((512, 512), np.float32)}, **kw)
    jrx = jmemory.prescribe()
    assert rx["candidates"] == jrx["candidates"]
    assert rx["recommendation"] == jrx["recommendation"]


# -- offline artifacts: the Mixtral story -------------------------------------

def test_plan_from_artifact_rejects_mixtral_dp2_accepts_dp1():
    """The committed TPU lowerings give the reference test's figures:
    dp2xep8xtp4 rejected, dp1xep8xtp8 accepted, against the budget they
    were compiled under (not this device's)."""
    budget = int(memory.lowering.TPU_BUDGET_GIB * 2 ** 30)
    dp2 = planner.plan_from_artifact(
        os.path.join(REPO, "MIXTRAL_DP2_OVERFLOW_r05.json"))
    assert not dp2.fits
    assert dp2.budget_bytes == budget
    assert dp2.predicted_peak_bytes == 17276874752
    assert dp2.breakdown["arguments"] == 10870120448
    assert dp2.breakdown["temp"] == 6406754304
    dp1 = planner.plan_from_artifact(
        os.path.join(REPO, "MIXTRAL_LOWER_TPU_r05.json"))
    assert dp1.fits
    assert dp1.budget_bytes == budget
    assert dp1.predicted_peak_bytes == 12490305024
    assert round(dp1.predicted_peak_bytes / 2 ** 30, 2) == 11.63
    assert dp1.headroom_bytes > 4 * 2 ** 30
    for name in ("MIXTRAL_DP2_OVERFLOW_r05.json",
                 "MIXTRAL_LOWER_TPU_r05.json", "LLAMA8B_LOWER_TPU_r05.json"):
        path = os.path.join(REPO, name)
        t, j = planner.plan_from_artifact(path), \
            jmemory.planner.plan_from_artifact(path)
        assert t.as_dict() == j.as_dict()
        with open(path) as f:
            art = json.load(f)
        if art["fit_verdict"].get("fits_hbm_compiler_enforced"):
            assert memory.lowering.fit_verdict(
                art["xla_memory_analysis_per_device"], "tpu") == \
                art["fit_verdict"]
    assert planner.last_plan().source == "lowering:LLAMA8B_LOWER_TPU_r05.json"


def test_artifact_without_memory_analysis_raises():
    with pytest.raises(ValueError):
        planner.plan_from_artifact({"backend": "tpu"})


def test_lowering_ports_the_verdicts_and_refuses_xla(tmp_path):
    """``fit_verdict`` and ``cpu_upcast_artifact_bytes`` equal the
    reference's; the XLA functions raise naming "Not carried over"."""
    mem = {"argument_size_in_bytes": 10 * 2 ** 30,
           "temp_size_in_bytes": 7 * 2 ** 30}
    for backend in ("tpu", "cpu"):
        assert memory.lowering.fit_verdict(mem, backend, 2 ** 30, ["s"]) == \
            jmemory.lowering.fit_verdict(mem, backend, 2 ** 30, ["s"])
    (tmp_path / "m.buffer-assignment.txt").write_text(
        "allocation 0: size 96, preallocated-temp:\n"
        " value: <1 convert.3 @0> (size=64,offset=0): f32[4,2,2]{2,1,0}\n"
        " value: <2 add.1 @0> (size=32,offset=64): f32[8]{0}\n")
    assert memory.lowering.cpu_upcast_artifact_bytes(4, str(tmp_path)) == \
        jmemory.lowering.cpu_upcast_artifact_bytes(4, str(tmp_path)) == \
        (64, ["f32[4,2,2]{2,1,0} convert.3 (0 MB)"])
    for name in ("shell_params", "remat_forward", "harvest_memory"):
        with pytest.raises(tmx.MXNetError, match="Not carried over"):
            getattr(memory.lowering, name)


# -- the serving KV pool ------------------------------------------------------

def test_plan_kv_pool_math_and_tp_division():
    """2 (K and V) × layers × block-pool bytes, divided by tp when the
    ``llama_serving`` rules shard the pool's head axis, as the
    reference's; ``plan_model`` folds it into the peak; a live engine's
    ``kv_pool_bytes()`` is the predicted figure."""
    from mxnet_tpu_torch.serving.generative import LlamaServingEngine

    b = planner.plan_kv_pool(2, 2, 16, num_blocks=8, block_size=16)
    assert b == 2 * 2 * (8 * 2 * 16 * 16 * 4) == \
        jmemory.planner.plan_kv_pool(2, 2, 16, num_blocks=8, block_size=16)
    tp2 = types.SimpleNamespace(shape={"tp": 2})
    assert planner.plan_kv_pool(2, 2, 16, num_blocks=8, block_size=16,
                                mesh=tp2) == b // 2 == \
        jmemory.planner.plan_kv_pool(2, 2, 16, num_blocks=8, block_size=16,
                                     mesh=tp2)
    net = tllama.llama_tiny()
    net.initialize(ctx=CPU)
    base = memory.plan_model(net, training=False)
    plan = memory.plan_model(net, training=False, kv_pool_bytes=b)
    assert plan.breakdown["kv_pool"] == b
    assert plan.predicted_peak_bytes == base.predicted_peak_bytes + b
    assert any(t["name"] == "<kv_pool>" for t in plan.top_buffers)
    jnet = jllama.llama_tiny()
    jnet.initialize()
    assert memory.plan_model(net, training=False).as_dict() == \
        jmemory.plan_model(jnet, training=False).as_dict()
    cfg = net.config
    eng = LlamaServingEngine(net, max_len=64, num_slots=2, block_size=16,
                             kv_mode="paged")
    assert eng.kv_pool_bytes() == planner.plan_kv_pool(
        cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, eng.num_blocks,
        eng.block_size)

"""The remat tiers of the PyTorch/CUDA port (``memory.policy``,
``hybridize(remat=...)``, ``LlamaConfig(scan_layers=True)`` with
``set_remat``) against the JAX package's, on the CPU.

Mirrors the reference's ``tests/test_memory_plan.py::
test_remat_tiers_recompute_but_never_renumber``: a remat tier changes the backward's memory schedule, never the numbers —
the loss trajectories of every tier are bit-identical in the port, and
equal the reference's on the same weights.  Beyond it: the recompute
really runs (the forward is called again in the backward), the random
draws of a rematerialized region are saved (dropout's gradients equal
the no-remat run's), "auto" climbs the ladder when the budget forces it,
the ``scan_layers`` route of ``llama_tiny`` (and ``mixtral_tiny``'s
stacked bank) gives the reference's scan route's logits and gradients at
every tier, ``set_remat`` leaves the plain layer loop alone, the numerics
taps fire once a forward, and ``memory/policy.py`` is the package's one
``torch.utils.checkpoint`` site.
"""
import ast
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import memory as jmemory
from mxnet_tpu.models import llama as jllama
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, gluon, memory, nd, telemetry
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.memory import planner, policy
from mxnet_tpu_torch.models import llama as tllama
from mxnet_tpu_torch.ops import flash_attention as tfa

CPU = tmx.cpu()
PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mxnet_tpu_torch")
TIERS = ("none", "dots", "layer")


@pytest.fixture(autouse=True)
def _isolate_memory_state():
    yield
    for mem in (memory, jmemory):
        mem.planner.set_budget(None)
        mem.policy.reset()


# -- hybridize(remat=...) -----------------------------------------------------

def _mlp(pkg, drop=0.0):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(32, activation="relu", in_units=16))
        if drop:
            net.add(pkg.gluon.nn.Dropout(drop))
        net.add(pkg.gluon.nn.Dense(32, activation="relu", in_units=32))
        net.add(pkg.gluon.nn.Dense(4, in_units=32))
    return net


@pytest.fixture(scope="module")
def mlp_arrays():
    rs = np.random.RandomState(3)
    return [rs.normal(0, 0.3, s).astype(np.float32) for s in
            ((32, 16), (32,), (32, 32), (32,), (4, 32), (4,))]


def _train(pkg, arrays, tier, drop=0.0, steps=3):
    """Three SGD steps of the MLP at ``tier`` → (losses, net)."""
    kw = {"ctx": CPU} if pkg is tmx else {}
    pkg.random.seed(4)
    net = _mlp(pkg, drop)
    net.initialize(pkg.init.Zero(), **kw)
    for p, a in zip(net.collect_params().values(), arrays):
        p.set_data(pkg.nd.array(a, **kw))
    net.hybridize(static_alloc=True, remat=tier)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05})
    rs = np.random.RandomState(0)
    x = pkg.nd.array(rs.uniform(size=(8, 16)).astype(np.float32), **kw)
    y = pkg.nd.array(rs.uniform(size=(8, 4)).astype(np.float32), **kw)
    loss_fn = pkg.gluon.loss.L2Loss()
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(8)
        losses.append(float(loss.mean().asscalar()))
    return losses, net


def test_remat_tiers_recompute_but_never_renumber(mlp_arrays):
    """Loss trajectories are bit-identical across the ladder in the port,
    and equal the reference's on the same weights (1e-6: two
    frameworks' f32 products); a forced tier is recorded as the
    reference records it."""
    ref, _ = _train(tmx, mlp_arrays, "none")
    for tier in ("dots", "layer", True, "full"):
        assert _train(tmx, mlp_arrays, tier)[0] == ref, tier
    assert policy.last_policy() == {"tier": "layer", "mode": "forced",
                                    "predicted_peak_bytes": None}
    for tier in TIERS:
        jref, _ = _train(jmx, mlp_arrays, tier)
        np.testing.assert_allclose(ref, jref, rtol=1e-6, atol=1e-7)
    assert policy.last_policy() == jmemory.policy.last_policy()


@pytest.mark.parametrize("tier,calls", [("none", 1), ("dots", 2),
                                        ("layer", 2)])
def test_the_backward_recomputes_the_forward(mlp_arrays, monkeypatch, tier,
                                             calls):
    """Under "dots" and "layer" the block's forward runs again in the
    backward (its products' outputs are saved under "dots", not
    recomputed); under "none" it runs once.  The costs stamp (the
    recapture sanitizer's ``cachedop_bwd`` components) carries the
    tier."""
    from mxnet_tpu_torch.telemetry import retrace

    _, net = _train(tmx, mlp_arrays, tier, steps=1)
    dense = net[1]
    seen = []
    orig = type(dense).hybrid_forward

    def counted(self, *a, **kw):
        if self is dense:
            seen.append(autograd.is_recording())
        return orig(self, *a, **kw)

    monkeypatch.setattr(type(dense), "hybrid_forward", counted)
    x = nd.ones((2, 16), ctx=CPU)
    with autograd.record():
        loss = net(x).sum()
    assert len(seen) == 1
    loss.backward()
    assert len(seen) == calls and all(seen)
    monkeypatch.undo()
    retrace.enable()
    try:
        with autograd.record():
            loss = net(nd.ones((3, 16), ctx=CPU)).sum()
        loss.backward()
        hist = [e["history"] for (kind, _), e in retrace._sites.items()
                if kind == "cachedop_bwd"]
        assert hist and hist[-1][-1]["components"]["remat"] == tier
    finally:
        retrace.disable()
        retrace.reset()


def test_dropout_draws_are_saved_not_replayed(mlp_arrays):
    """A rematerialized region's random draws come from the port's own
    generators, which torch's checkpoint does not replay: the tiers save
    them, so dropout's gradients (and the whole trajectory) equal the
    no-remat run's bit for bit."""
    ref, ref_net = _train(tmx, mlp_arrays, "none", drop=0.4)
    for tier in ("dots", "layer"):
        got, net = _train(tmx, mlp_arrays, tier, drop=0.4)
        assert got == ref
        for p, q in zip(ref_net.collect_params().values(),
                        net.collect_params().values()):
            assert torch.equal(p.data()._data, q.data()._data)


def test_auto_remat_climbs_the_ladder_under_a_small_budget(mlp_arrays):
    """``remat="auto"`` picks "none" with the CPU budget's headroom and
    the most frugal tier under a tiny one, as the reference's planner
    does on the same shapes; ``cachedop.remat_auto.<tier>`` counts the
    picks."""
    telemetry.enable()
    try:
        _train(tmx, mlp_arrays, "auto", steps=1)
        assert policy.last_policy()["tier"] == "none"
        planner.set_budget(1024)
        jmemory.planner.set_budget(1024)
        got, _ = _train(tmx, mlp_arrays, "auto", steps=1)
        assert policy.last_policy()["tier"] == "layer"
        counters = telemetry.counters()
        assert counters.get("cachedop.remat_auto.none") == 1
        assert counters.get("cachedop.remat_auto.layer") == 1
        _train(jmx, mlp_arrays, "auto", steps=1)
        assert policy.last_policy() == jmemory.policy.last_policy()
    finally:
        telemetry.disable()


# -- scan_layers + set_remat on llama_tiny ------------------------------------

B, T, V = 2, 16, 256


@pytest.fixture(scope="module")
def llama_arrays():
    jnet = jllama.llama_tiny()
    jnet.initialize(jmx.init.Xavier())
    return {k: p.data().asnumpy() for k, p in
            jnet._collect_params_with_prefix().items()}


def _ids():
    rng = np.random.RandomState(2)
    return rng.randint(0, V, (B, T)).astype(np.int32)


def _port_run(arrays, ids, tier=None, scan=True, build=tllama.llama_tiny):
    net = build(scan_layers=scan)
    load_numpy_params(net, arrays, ctx=CPU)
    if tier is not None:
        net.set_remat(tier)
    with autograd.record():
        logits = net(nd.array(ids, ctx=CPU, dtype="int32"))
        loss = (logits * logits).mean()
    loss.backward()
    return logits.asnumpy(), {k: p.grad().asnumpy() for k, p in
                              net._collect_params_with_prefix().items()}


def _ref_run(arrays, ids, tier):
    net = jllama.llama_tiny(scan_layers=True)
    net.initialize()
    for name, p in net._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(arrays[name]))
    net.set_remat(tier)
    with jmx.autograd.record():
        logits = net(jmx.nd.array(ids, dtype="int32"))
        loss = (logits * logits).mean()
    loss.backward()
    return logits.asnumpy(), {k: p.grad().asnumpy() for k, p in
                              net._collect_params_with_prefix().items()}


def test_scan_layers_matches_the_reference_scan_route(llama_arrays):
    """``llama_tiny(scan_layers=True)``: at each tier the port's logits
    and gradients are bit-identical to its plain layer loop's, and equal
    the reference's scan route at its default tier, "layer" (logits
    1e-5, gradients 1e-4 of each tensor's largest: f32 in both, sums in
    other orders; the reference's eager scan costs ~5 s a tier)."""
    ids = _ids()
    plain = _port_run(llama_arrays, ids, scan=False)
    jlogits, jgrads = _ref_run(llama_arrays, ids, "layer")
    for tier in TIERS:
        logits, grads = _port_run(llama_arrays, ids, tier)
        np.testing.assert_array_equal(logits, plain[0])
        for k in plain[1]:
            np.testing.assert_array_equal(grads[k], plain[1][k], err_msg=k)
        assert policy.last_policy() == (
            None if tier == "none" else
            {"tier": tier, "mode": "forced", "predicted_peak_bytes": None})
        policy.reset()
        np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-5)
        assert grads.keys() == jgrads.keys()
        for k in jgrads:
            scale = max(np.abs(jgrads[k]).max(), 1e-6)
            assert np.abs(grads[k] - jgrads[k]).max() <= 1e-4 * scale, k


def test_scan_layers_recomputes_attention_and_defaults_to_layer(
        llama_arrays, monkeypatch):
    """The default tier is "layer": each decoder layer's forward (the
    flash forward included) runs again in the backward, so the plain
    version of #1 runs 2 × layers times a step against layers times on
    the plain loop, where ``set_remat`` changes nothing; "auto" sizes
    itself at the live activation and records its pick."""
    calls = []
    orig = tfa._fa_forward_plain

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tfa, "_fa_forward_plain", counted)
    ids = _ids()
    _port_run(llama_arrays, ids)                    # scan, default tier
    assert len(calls) == 2 * 2
    assert policy.last_policy()["tier"] == "layer"
    calls.clear()
    _port_run(llama_arrays, ids, "layer", scan=False)  # the plain loop
    assert len(calls) == 2
    calls.clear()
    _port_run(llama_arrays, ids, "auto")
    assert len(calls) == 2 and policy.last_policy()["mode"] == "auto"
    planner.set_budget(1 << 20)
    calls.clear()
    _port_run(llama_arrays, ids, "auto")
    assert len(calls) == 4 and policy.last_policy()["tier"] != "none"


def test_scan_layers_taps_fire_once_a_forward(llama_arrays):
    """With numerics on, a rematerialized step queues each
    ``decoder.<i>`` bundle once (the recompute's taps are muted), with
    the plain loop's values."""
    from mxnet_tpu_torch.telemetry import numerics

    ids = _ids()
    got = {}
    for scan in (False, True):
        numerics.clear()
        numerics.enable(stride=1)
        try:
            _port_run(llama_arrays, ids, "layer", scan=scan)
            summary = numerics.step_summary(1)
        finally:
            numerics.disable()
            numerics.clear()
        got[scan] = summary["tensors"]
    assert list(got[True]) == list(got[False])
    assert [k for k in got[True] if k.startswith("decoder.")] == \
        ["decoder.0", "decoder.1"]
    for k in got[False]:
        assert got[True][k] == got[False][k], k


def test_moe_stacked_bank_rides_the_scan_route():
    """``mixtral_tiny(scan_layers=True)``: the expert bank's layers run on
    the same route, each under its checkpoint; gradients equal the plain
    loop's bit for bit at every tier."""
    net = tllama.mixtral_tiny()
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    arrays = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
    ids = _ids()
    plain = _port_run(arrays, ids, scan=False, build=tllama.mixtral_tiny)
    for tier in TIERS:
        logits, grads = _port_run(arrays, ids, tier,
                                  build=tllama.mixtral_tiny)
        np.testing.assert_array_equal(logits, plain[0])
        for k in plain[1]:
            np.testing.assert_array_equal(grads[k], plain[1][k], err_msg=k)


# -- the one checkpoint site --------------------------------------------------

def test_checkpoint_wrap_is_the_one_checkpoint_site():
    """No module of the port but ``memory/policy.py`` calls or imports
    ``torch.utils.checkpoint`` (the port's counterpart of the reference's
    mxlint T9: every remat decision flows through ``checkpoint_wrap``)."""
    sites = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                text = None
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    mod = getattr(node, "module", None) or ""
                    names = [a.name for a in node.names]
                    if "torch.utils.checkpoint" in [mod] + names or (
                            mod == "torch.utils" and "checkpoint" in names):
                        text = "import"
                elif isinstance(node, ast.Attribute) and \
                        node.attr == "checkpoint" and \
                        isinstance(node.value, ast.Attribute) and \
                        node.value.attr == "utils":
                    text = "attribute"
                if text:
                    sites.append(os.path.relpath(path, PKG))
    assert sorted(set(sites)) == [os.path.join("memory", "policy.py")]

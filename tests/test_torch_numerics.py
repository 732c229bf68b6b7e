"""The numerics tier of the PyTorch/CUDA port (``mxnet_tpu_torch.
telemetry.numerics``) against the JAX package's, on the CPU.

Mirrors ``tests/test_numerics.py`` without its fleet cases (the fleet
layer waits for the next slice): the stat bundle and ``first_nan``
provenance, stride gating, the disabled-path guard, one graph signature
per mode, the CachedOp backward's per-parameter ``grad.`` stats, the
Llama taps, capture → replay → bisection, the reference's
``tools/numerics_report.py`` rendering the port's JSONL, and ``Monitor``
on a hybridized block.

Parity: a 2-layer tiny Llama in f32 with the same weights (the port's
Xavier draws, set on the reference's parameters) and the same numpy
inputs gives, in both
packages, the same stat paths in the same order for an eager forward, a
``Trainer`` step (``grad.``/``update.``) and ``FusedTrainStep`` at K = 2
(there the reference's ``grad.``/``update.`` paths; the port's fused step
also carries the forward's taps, which the reference's fused program
drops).  Tolerance: ``l2`` and ``maxabs`` within 1e-5 relative; ``mean``
within 1e-5 of the tensor's ``maxabs`` (a mean near 0 has no relative
scale); ``nan`` and ``inf`` exact.  An ``update.`` bundle is new − old
weight in f32, so its values also carry the rounding of the weights
themselves: they hold within 1e-5 relative or two f32 ulps of the
parameter's largest |weight| (one rounding in each package), whichever
is larger.  The weights are drawn from a fixed seed.

Traps: 1 (one graph per mode), 3 (host work only at the stride: the
off-stride steps call ``_materialize`` no time and add no ``host_sync``)
and 4 (NaN poisoned into decoder layer 1 is ``first_nan`` = ``decoder.1``
eagerly, through a hybridized block and inside ``FusedTrainStep``).
"""
import json
import math
import os
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.models import llama as jllama
from mxnet_tpu_torch import autograd, checkpoint, gluon, nd, telemetry
from mxnet_tpu_torch.models import llama as tllama
from mxnet_tpu_torch.monitor import Monitor
from mxnet_tpu_torch.telemetry import numerics
from mxnet_tpu_torch.telemetry.sinks import ListSink

CPU = tmx.cpu()
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STAT_RTOL = 1e-5


def _numerics_report():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import numerics_report
    return numerics_report


@pytest.fixture(autouse=True)
def _clean():
    for t in (telemetry, jtel):
        t.disable()
        t.reset()
        t.numerics.clear()
    yield
    for t in (telemetry, jtel):
        t.disable()
        t.reset()
        t.numerics.clear()


# --- tap / step_summary basics ----------------------------------------------

def test_tap_step_summary_schema_and_first_nan_provenance():
    numerics.enable(stride=1)
    numerics.tap("embed", nd.ones((4, 4), ctx=CPU))
    numerics.tap("decoder.1.ffn", nd.array(
        np.array([[1.0, float("nan")], [2.0, 3.0]]), ctx=CPU))
    numerics.tap("grad.decoder.1.ffn.w", nd.ones((2,), ctx=CPU) * 3.0)
    numerics.tap("grad.head.w", nd.ones((2,), ctx=CPU) * 4.0)
    summary = numerics.step_summary(0)
    assert summary["stride"] == 1
    tensors = summary["tensors"]
    assert list(tensors) == ["embed", "decoder.1.ffn",
                             "grad.decoder.1.ffn.w", "grad.head.w"]
    for st in tensors.values():
        assert set(st) == {"l2", "maxabs", "mean", "nan", "inf"}
        assert isinstance(st["l2"], float) and isinstance(st["nan"], int)
    assert tensors["embed"]["l2"] == pytest.approx(4.0)
    assert tensors["decoder.1.ffn"]["nan"] == 1
    assert summary["first_nan"] == {"path": "decoder.1.ffn", "layer": 1,
                                    "nan": 1, "inf": 0}
    assert summary["grad_norm"] == pytest.approx(math.sqrt(18 + 32))


def test_stats_of_matches_the_reference():
    """The bundle of the same tensors, f32, bf16 and integer, with nan
    and inf, in both packages."""
    import torch

    rs = np.random.RandomState(2)
    x = rs.randn(3, 5).astype(np.float32)
    x[0, 1], x[2, 2] = np.nan, np.inf
    cases = [x, rs.randn(7).astype(np.float32),
             rs.randint(-5, 5, (4, 4)).astype(np.int32)]
    for a in cases:
        got = numerics.stats_of(torch.from_numpy(a)).numpy()
        ref = jtel.numerics.stats_of(jmx.nd.array(a, dtype=a.dtype)._data)
        for i, k in enumerate(numerics.FIELDS):
            want = float(np.asarray(ref[k]))
            if math.isnan(want):
                assert math.isnan(got[i])
            else:
                assert got[i] == pytest.approx(want, rel=STAT_RTOL), k
    bf = torch.from_numpy(x).bfloat16()
    got = numerics.stats_of(bf).numpy()
    assert (got[3], got[4]) == (1.0, 1.0)


def test_stride_gates_the_host_sync_and_drops_offstride(monkeypatch):
    """Trap 3: off the stride an eager tap computes nothing and nothing
    is transferred (``_materialize`` runs no time, no ``host_sync``);
    the stride's record makes one transfer."""
    calls = []
    real = numerics._materialize
    monkeypatch.setattr(numerics, "_materialize",
                        lambda entries: calls.append(len(entries)) or
                        real(entries))
    telemetry.enable()
    numerics.enable(stride=4)
    for _ in range(3):  # records 1-3
        with telemetry.step() as scope:
            numerics.tap("x", nd.ones((2,), ctx=CPU))
            assert numerics._pending == []
        assert "numerics" not in scope.record
    assert calls == []
    with telemetry.step() as scope:  # record 4
        numerics.tap("x", nd.ones((2,), ctx=CPU))
        numerics.tap("y", nd.ones((3,), ctx=CPU))
    assert list(scope.record["numerics"]["tensors"]) == ["x", "y"]
    assert calls == [2]
    assert telemetry.counters().get("host_sync", 0) == 0
    numerics.tap("z", nd.ones((2,), ctx=CPU))  # without a step window
    assert numerics.step_summary(5) is None and numerics._pending == []


def test_layer_of_path_parsing():
    assert numerics.layer_of("decoder.7.ffn") == 7
    assert numerics.layer_of("grad.decoder.3.attn.wq") == 3
    assert numerics.layer_of("embed") == -1


def test_disabled_tap_overhead_bounded():
    x = nd.ones((8, 8), ctx=CPU)
    t0 = time.perf_counter()
    for _ in range(10_000):
        numerics.tap("layer", x)
        numerics.step_summary()
    assert time.perf_counter() - t0 < 0.5
    assert numerics._pending == []


# --- one graph per mode ------------------------------------------------------

def _mlp():
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Dense(8, activation="relu"))
        net.add(gluon.nn.Dense(4))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net(nd.ones((2, 8), ctx=CPU))
    net.hybridize()
    return net


def test_stats_enabled_keeps_one_compile_signature():
    """Trap 1: numerics on and off each keep exactly one entry of the
    CachedOp and of the fused update; toggling re-uses both."""
    numerics.enable(stride=1)
    telemetry.enable()
    net = _mlp()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01})
    x, y = nd.ones((2, 8), ctx=CPU), nd.ones((2, 4), ctx=CPU)

    def one_step():
        with telemetry.step(examples=2) as scope:
            with autograd.record():
                loss = ((net(x) - y) ** 2).mean()
            loss.backward()
            trainer.step(2)
            net(x)  # an unrecorded call: the graphs' own keys
        return scope.record

    assert one_step()["compile_count"] > 0
    kinds = set()
    for _ in range(3):
        rec = one_step()
        assert rec["compile_count"] == 0, rec["counters"]
        kinds |= {p.split(".", 1)[0] for p in rec["numerics"]["tensors"]}
    assert {"grad", "update"} <= kinds
    numerics.disable()
    assert one_step()["compile_count"] > 0
    assert one_step()["compile_count"] == 0
    numerics.enable(stride=1)
    rec = one_step()
    assert rec["compile_count"] == 0 and rec["numerics"] is not None
    cop = net._cached_op
    assert len(cop._graphs) == 2 and len(cop._recorded_sigs) == 2
    assert {k[-1] for k in cop._graphs} == {True, False}
    assert len(trainer._fused_sigs) == 2


def test_cachedop_backward_records_per_param_grad_stats():
    numerics.enable(stride=1)
    net = _mlp()
    with autograd.record():
        out = net(nd.ones((2, 8), ctx=CPU))
    out.backward()
    summary = numerics.step_summary(0)
    grads = [p for p in summary["tensors"] if p.startswith("grad.")]
    assert grads == ["grad." + p.name
                     for p in net.collect_params().values()]


def test_llama_plain_path_taps_every_layer():
    numerics.enable(stride=1)
    net = tllama.llama_tiny()
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net(nd.array(np.ones((1, 8), dtype="int32"), ctx=CPU))
    paths = list(numerics.step_summary(0)["tensors"])
    n_layers = len(net.model.layers)
    assert paths == ["embed"] + [f"decoder.{i}" for i in range(n_layers)] \
        + ["norm", "logits"]


# --- parity with the reference -----------------------------------------------

def _tiny(llama_mod):
    cfg = {**llama_mod.LLAMA_CONFIGS["llama_tiny"], "num_layers": 2}
    return llama_mod.LlamaForCausalLM(llama_mod.LlamaConfig(**cfg),
                                      prefix="tl_")


def _pair(seed=11):
    """The same 2-layer tiny Llama in both packages, and numpy inputs."""
    tmx.random.seed(seed)
    tnet = _tiny(tllama)
    tnet.initialize(tmx.init.Xavier(), ctx=CPU)
    arrays = {k: p.data().asnumpy()
              for k, p in tnet._collect_params_with_prefix().items()}
    jnet = _tiny(jllama)
    jnet.initialize(jmx.init.Zero())
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(arrays[k]))
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 256, (2, 8)).astype(np.int32)
    labels = rs.randint(0, 256, (2, 8)).astype(np.int32)
    return tnet, jnet, ids, labels


def _assert_stats_match(got, want, floors=None):
    """``floors``: a path's absolute tolerance where it exceeds the
    relative one (the ``update.`` bundles' f32 rounding)."""
    assert list(got) == list(want)
    for path in want:
        g, w = got[path], want[path]
        atol = (floors or {}).get(path, 0.0)
        assert (g["nan"], g["inf"]) == (w["nan"], w["inf"]), path
        for k in ("l2", "maxabs"):
            assert g[k] == pytest.approx(w[k], rel=STAT_RTOL, abs=atol), \
                (path, k)
        assert abs(g["mean"] - w["mean"]) <= \
            max(STAT_RTOL * w["maxabs"], atol), path


def _run(pkg, net, ids, labels, mode):
    """One numerics-harvested run of ``mode`` → the summary's tensors."""
    kw = {"ctx": CPU} if pkg is tmx else {}
    num = (numerics if pkg is tmx else jtel.numerics)
    num.enable(stride=1)
    x, y = pkg.nd.array(ids, **kw), pkg.nd.array(labels, **kw)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
    if mode == "forward":
        net(x)
    elif mode == "trainer":
        with pkg.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(ids.shape[0])
    else:
        step = pkg.gluon.FusedTrainStep(
            net, trainer, lambda n, a, b: loss_fn(n(a), b),
            steps_per_execution=2, batch_size=ids.shape[0])
        step(x, y)
    return num.step_summary(0)["tensors"]


@pytest.mark.parametrize("mode", ["forward", "trainer", "fused"])
def test_tiny_llama_stats_match_the_reference(mode):
    tnet, jnet, ids, labels = _pair()
    got = _run(tmx, tnet, ids, labels, mode)
    want = _run(jmx, jnet, ids, labels, mode)
    if mode == "fused":
        # the reference's fused program drops the forward's taps
        assert [p for p in got if not p.startswith(("grad.", "update."))] \
            == ["embed", "decoder.0", "decoder.1", "norm", "logits"]
        got = {p: s for p, s in got.items()
               if p.startswith(("grad.", "update."))}
    ulp = 2.0 ** -23
    floors = {"update." + p.name: 2 * ulp * float(
        np.abs(p.data().asnumpy()).max())
        for p in tnet.collect_params().values()}
    _assert_stats_match(got, want, floors)


# --- trap 4: provenance -------------------------------------------------------

def _poison(net):
    """NaN into the first weight of decoder layer 1, in place (the same
    storage: a graph captured before replays with it)."""
    victim = next(iter(net.model.layers[1].collect_params().values()))
    host = victim.data().asnumpy()
    host.flat[0] = float("nan")
    victim.set_data(nd.array(host, ctx=CPU))


@pytest.mark.parametrize("route", ["eager", "hybridized", "fused"])
def test_nan_in_layer_1_is_named_decoder_1(route):
    """Trap 4: a clean call first (on a card it captures the graph), the
    weight poisoned in place, then the call whose record names the
    layer.  ``FusedTrainStep`` runs one step a call: the update of a
    poisoned step spreads nan to every weight, so a second inner step
    would find the embedding poisoned first."""
    telemetry.enable()
    numerics.enable(stride=1)
    sink = ListSink()
    telemetry.add_sink(sink)
    net = _tiny(tllama)
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    if route != "eager":
        net.hybridize()
    ids = nd.array(np.ones((2, 8), dtype="int32"), ctx=CPU)
    if route == "fused":
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.01})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        step = gluon.FusedTrainStep(net, trainer,
                                    lambda n, a, b: loss_fn(n(a), b),
                                    steps_per_execution=1, batch_size=2)
        run = lambda: step(ids, ids)  # noqa: E731
    else:
        run = lambda: net(ids)  # noqa: E731
    for poisoned in (False, True):
        if poisoned:
            _poison(net)
        with telemetry.step(examples=2):
            run()
        first = sink.records[-1]["numerics"]["first_nan"]
        if not poisoned:
            assert first is None
    assert first["path"] == "decoder.1" and first["layer"] == 1
    assert first["nan"] > 0


# --- capture -> replay forensics ---------------------------------------------

class _PoisonNet(gluon.HybridBlock):
    """Dense -> log: negative activations poison the log, so the
    bisection must name ``log`` (not the dense)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.dense = gluon.nn.Dense(4)

    def hybrid_forward(self, F, x):
        return F.log(self.dense(x))


def build_poison_net():
    return _PoisonNet(prefix="poison_")


def test_capture_replay_names_first_poisoned_op(tmp_path):
    net = build_poison_net()
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    x = nd.array(np.linspace(-3.0, 3.0, 12,
                             dtype=np.float32).reshape(2, 6), ctx=CPU)
    net(x)
    wp = net.collect_params()[net.dense.weight.name]
    wp.set_data(nd.ones(wp.shape, ctx=CPU))
    numerics.arm_capture(str(tmp_path))
    assert numerics.capture_armed()
    cdir = numerics.capture_step(
        net, [x], step=42, reason="grad_spike",
        builder="test_torch_numerics:build_poison_net")
    assert cdir == str(tmp_path / "capture-42")
    assert not numerics.capture_armed()
    checkpoint.wait_async()
    with open(os.path.join(cdir, "capture.json")) as f:
        meta = json.load(f)
    assert meta["record"] == "numerics_capture"
    assert meta["step"] == 42 and meta["reason"] == "grad_spike"
    assert meta["inputs"] == ["input0"]
    ckpt = checkpoint.latest_checkpoint(cdir)
    with open(os.path.join(ckpt, "manifest.json")) as f:
        assert json.load(f)["extra"]["numerics_capture"]["reason"] == \
            "grad_spike"
    meta2, inputs = numerics.load_capture(cdir)
    assert meta2 == meta
    np.testing.assert_array_equal(inputs[0], x.asnumpy())
    # the replay: a fresh net from the builder, the captured parameters
    # and random state, then the per-op bisection
    import pickle

    replay = build_poison_net()
    replay.initialize(ctx=CPU)
    replay(nd.array(inputs[0], ctx=CPU))
    checkpoint.resume(cdir, replay, ctx=CPU)
    with open(os.path.join(cdir, meta["rng_state"]), "rb") as f:
        tmx.random.set_state(pickle.load(f))
    with numerics.bisect() as res:
        replay(nd.array(inputs[0], ctx=CPU))
    assert res.first is not None and res.first["op"] == "log"
    journal = res.ops[res.first["index"]]
    assert journal["outputs_bad"] and not journal["inputs_bad"]


def test_capture_unarmed_is_a_noop():
    net = build_poison_net()
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    x = nd.ones((1, 6), ctx=CPU)
    net(x)
    assert numerics.capture_step(net, [x], step=1) is None


# --- the reference's report over the port's JSONL ------------------------------

def test_report_renders_the_ports_jsonl(tmp_path):
    jsonl = str(tmp_path / "rank0.jsonl")
    telemetry.enable(jsonl_path=jsonl)
    numerics.enable(stride=1)
    net = tllama.llama_tiny()
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    ids = nd.array(np.ones((2, 8), dtype="int32"), ctx=CPU)
    for _ in range(3):
        with telemetry.step(examples=2):
            net(ids)
    telemetry.disable()
    nr = _numerics_report()
    records = nr.load_records([jsonl])
    rows = nr.numerics_rows(records)
    assert rows
    for _step, rank, _path, st in rows:
        assert set(st) == {"l2", "maxabs", "mean", "nan", "inf"}
    text = nr.heatmap_text(records)
    assert "numerics heatmap: l2" in text and "overflow: none" in text
    events = nr.chrome_counters(records)["traceEvents"]
    assert events and all(e["ph"] == "C" for e in events)


# --- Monitor on the numerics tier --------------------------------------------

def test_monitor_records_on_hybridized_block():
    """Its taps are kept off the numerics stride too: ``toc`` drains
    them itself."""
    net = _mlp()
    net(nd.ones((2, 8), ctx=CPU))  # a graph before install
    mon = Monitor(interval=1).install(net)
    numerics.step_summary(1)  # the tier's next step is off its stride
    assert not numerics.harvesting()
    mon.tic()
    net(nd.ones((2, 8), ctx=CPU))
    rows = mon.toc()
    assert rows and any(n.endswith("_output") for _, n, _ in rows)
    for _step, _name, stat in rows:
        assert float(stat) > 0.0
    mon.uninstall()


def test_monitor_eager_path_unchanged():
    net = _mlp()
    net.hybridize(False)
    mon = Monitor(interval=1).install(net)
    mon.tic()
    net(nd.ones((2, 8), ctx=CPU))
    assert len(mon.toc()) >= 2
    mon.uninstall()

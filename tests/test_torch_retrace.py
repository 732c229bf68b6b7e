"""The recapture sanitizer of the PyTorch/CUDA port (``mxnet_tpu_torch.
telemetry.retrace``), on the CPU.

Mirrors ``tests/test_retrace.py`` without its serving dp2 case (the
serving side waits for the next slice): warmup semantics, warn and raise
modes, the structural differ (the same diffs as the reference's for the
same components), injected retraces at the instrumented sites (a
CachedOp input shape, a FusedTrainStep ``rescale_grad``, the Trainer's
fused update after a ``cast``), a clean training lane in raise mode, the
disabled-path cost, the caps, the environment wiring, the JSONL records,
and the reference's ``tools/retrace_report.py`` reading the port's
records.

Trap 7: the port captures again when a parameter's storage moves (a CUDA
graph bakes the addresses in), a cause of a miss the reference has not;
the sanitizer names it ``param_addresses`` instead of reporting an empty
diff.  The CachedOp keys its graphs on the addresses only on a card (the
card test ``test_retrace_names_param_addresses_on_card`` rebinds a
parameter after warmup); here the same components go through the
differ.
"""
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu.telemetry import retrace as jretrace
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon, nd, telemetry
from mxnet_tpu_torch.gluon import block
from mxnet_tpu_torch.telemetry import retrace
from mxnet_tpu_torch.telemetry.sinks import ListSink

CPU = tmx.cpu()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_retrace():
    retrace.disable()
    retrace.reset()
    yield
    retrace.disable()
    retrace.reset()
    telemetry.disable()
    telemetry.reset()


# --- structural differ -------------------------------------------------------

DIFF_CASES = [
    ({"args": (((2, 8), "float32", False),), "mesh": None},
     {"args": (((3, 8), "float32", False),), "mesh": None}),
    ({"args": (((2, 8), "float32", False),), "mesh": None},
     {"args": (((2, 8), "bfloat16", False),), "mesh": None}),
    ({"args": (((2, 8), "float32"),)}, {"args": (((2, 8), "float16"),)}),
    ({"rescale_grad": 1.0, "mesh": None},
     {"rescale_grad": 0.5, "mesh": "dp2"}),
    ({"a": 1}, {"a": 1, "b": 2}),
    ({"args": (((2, 8), "float32", False),)},
     {"args": [[[2, 8], "float32", False]]}),
    ({"p": (1, 2, 3)}, {"p": (1, 2)}),
]


@pytest.mark.parametrize("old,new", DIFF_CASES)
def test_diff_matches_the_reference(old, new):
    assert retrace.diff_components(old, new) == \
        jretrace.diff_components(old, new)


def test_diff_names_the_exact_aval_field():
    old = {"args": (((2, 8), "float32", False),), "mesh": None}
    new = {"args": (((3, 8), "float32", False),), "mesh": None}
    assert retrace.diff_components(old, new) == \
        ["args[0].shape: (2, 8) -> (3, 8)"]


def test_cachedop_components_decomposition():
    sig = ((((2, 8), "float32", False),), True, "cpu", (), None, "n0")
    comps = retrace.cachedop_components(sig)
    assert comps == jretrace.cachedop_components(sig)
    assert retrace.cachedop_components("odd") == {"signature": "odd"}
    port = sig + ("bfloat16", ("w@0x10",))
    assert retrace.cachedop_components(port)["param_addresses"] == \
        ("w@0x10",)


# --- warmup semantics --------------------------------------------------------

def test_first_signature_is_never_a_violation():
    retrace.enable("raise")
    retrace.warm()
    assert retrace.observe("k", 1, {"a": 1}, site="s") is None
    assert retrace.violations() == []
    assert retrace.sites() == {("k", 1): 1}


def test_prewarm_signatures_are_baselines():
    retrace.enable("raise")
    retrace.observe("k", 1, {"a": 1}, site="s")
    retrace.observe("k", 1, {"a": 2}, site="s")
    assert retrace.violations() == []
    retrace.warm()
    with pytest.raises(retrace.RetraceError):
        retrace.observe("k", 1, {"a": 3}, site="s")
    assert len(retrace.violations()) == 1


def test_replayed_signature_is_not_new():
    retrace.enable("raise")
    retrace.warm()
    retrace.observe("k", 1, {"a": 1}, site="s")
    assert retrace.observe("k", 1, {"a": 1}, site="s") is None
    assert retrace.sites() == {("k", 1): 1}


def test_violation_diffs_against_nearest_prior_signature():
    retrace.enable("warn")
    retrace.observe("k", 1, {"a": 1, "b": 1}, site="s")
    retrace.observe("k", 1, {"a": 9, "b": 9}, site="s")
    retrace.warm()
    with pytest.warns(RuntimeWarning):
        retrace.observe("k", 1, {"a": 1, "b": 2}, site="s")
    (v,) = retrace.violations()
    assert v["against"]["signature_index"] == 0
    assert v["diff"] == ["b: 1 -> 2"] and v["signature_index"] == 2


def test_warn_mode_warns_raise_mode_raises():
    retrace.enable("warn")
    retrace.warm()
    retrace.observe("k", 1, {"a": 1}, site="mod:site")
    with pytest.warns(RuntimeWarning, match="retrace at mod:site"):
        retrace.observe("k", 1, {"a": 2}, site="mod:site")
    retrace.enable("raise")
    with pytest.raises(retrace.RetraceError) as ei:
        retrace.observe("k", 1, {"a": 3}, site="mod:site")
    msg = str(ei.value)
    assert "a: " in msg and "-> 3" in msg
    assert "test_torch_retrace.py" in msg
    assert "diverged from signature #" in msg


def test_warmup_steps_counted_at_telemetry_step_boundaries():
    retrace.enable("warn", warmup_steps=2)
    telemetry.enable()
    with telemetry.step():
        pass
    assert not retrace.is_warm()
    with telemetry.step():
        pass
    assert retrace.is_warm()


def test_reset_keeps_mode_but_forgets_history():
    retrace.enable("raise")
    retrace.warm()
    retrace.observe("k", 1, {"a": 1}, site="s")
    retrace.reset()
    assert retrace.is_enabled() and not retrace.is_warm()
    assert retrace.sites() == {}
    retrace.warm()
    assert retrace.observe("k", 1, {"a": 2}, site="s") is None


# --- injected retraces at the instrumented sites -----------------------------

def test_injected_cachedop_retrace_names_site_and_aval():
    retrace.enable("raise")
    net = gluon.nn.Dense(4)
    net.initialize(ctx=CPU)
    net.hybridize()
    net(nd.ones((2, 8), ctx=CPU)).wait_to_read()
    retrace.warm()
    net(nd.ones((2, 8), ctx=CPU)).wait_to_read()
    with pytest.raises(retrace.RetraceError) as ei:
        net(nd.ones((3, 8), ctx=CPU))
    msg = str(ei.value)
    assert "mxnet_tpu_torch.gluon.block:CachedOp.__call__" in msg
    assert "args[0].shape: (2, 8) -> (3, 8)" in msg
    assert "test_torch_retrace.py" in msg
    (v,) = retrace.violations()
    assert v["kind"] == "cachedop"
    assert v["diff"] == ["args[0].shape: (2, 8) -> (3, 8)"]


def test_param_addresses_name_a_moved_parameter():
    """Trap 7 through the CachedOp's own components: two signatures that
    differ only in a parameter's address diff to that component."""
    retrace.enable("raise")
    net = gluon.nn.Dense(4, in_units=8, prefix="moved_")
    net.initialize(ctx=CPU)
    params = list(net.collect_params().values())
    x = nd.ones((2, 8), ctx=CPU)
    sig = (((2, 8), x.dtype, x._data.device),), False, None, \
        tuple((p.shape, p.dtype) for p in params), False
    ptrs = tuple(p.data()._data.data_ptr() for p in params)
    moved = (ptrs[0] + 4096,) + ptrs[1:]
    retrace.observe("cachedop", 1, block._components(sig, [x], params, ptrs))
    retrace.warm()
    with pytest.raises(retrace.RetraceError) as ei:
        retrace.observe("cachedop", 1,
                        block._components(sig, [x], params, moved))
    (v,) = retrace.violations()
    assert len(v["diff"]) == 1 and \
        v["diff"][0].startswith("param_addresses[0]: 'moved_weight@")
    assert "param_addresses" in str(ei.value)


def test_fused_step_rescale_grad_retrace():
    """A new batch size rewrites ``rescale_grad``, which the captured
    update bakes in: the fused step's second signature after warmup
    names it."""
    retrace.enable("raise")
    net = gluon.nn.Dense(4, in_units=8)
    net.initialize(ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    x = nd.ones((2, 8), ctx=CPU)
    steps = {bs: gluon.FusedTrainStep(net, trainer,
                                      lambda n, a: (n(a) ** 2).mean(),
                                      steps_per_execution=1, batch_size=bs)
             for bs in (2, 4)}
    step = steps[2]
    step(x)
    retrace.warm()
    step(x)
    step.batch_size = 4
    with pytest.raises(retrace.RetraceError) as ei:
        step(x)
    assert "FusedTrainStep.__call__" in str(ei.value)
    assert "rescale_grad: 0.5 -> 0.25" in str(ei.value)


def test_trainer_fused_update_retrace_after_a_cast():
    """The fused update's signature holds the weights' dtypes (its
    ``rescale_grad`` rides in the kernel's arguments, so a new batch size
    is no new signature there): a cast after warmup is named."""
    retrace.enable("raise")
    net = gluon.nn.Dense(4, in_units=8)
    net.initialize(ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})

    def one_step(batch_size, dtype="float32"):
        x = nd.ones((2, 8), ctx=CPU).astype(dtype)
        with ag.record():
            loss = (net(x) ** 2).mean()
        loss.backward()
        trainer.step(batch_size)

    one_step(2)
    retrace.warm()
    one_step(4)  # rescale_grad 0.5 -> 0.25: the same fused signature
    assert retrace.violations() == []
    net.cast("float16")
    with pytest.raises(retrace.RetraceError) as ei:
        one_step(4, "float16")
    msg = str(ei.value)
    assert "Trainer._try_fused_update" in msg
    assert "weights[0].dtype: 'float32' -> 'float16'" in msg


def test_trainer_e2e_lane_raise_clean():
    retrace.enable("raise", warmup_steps=2)
    telemetry.enable()
    tmx.random.seed(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu"), gluon.nn.Dense(4))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1e-2})
    rs = np.random.RandomState(0)
    xb = nd.array(rs.randn(8, 8).astype(np.float32), ctx=CPU)
    yb = nd.array(rs.randn(8, 4).astype(np.float32), ctx=CPU)
    for i in range(5):
        with telemetry.step():
            with ag.record():
                loss = ((net(xb) - yb) ** 2).mean()
            loss.backward()
            trainer.step(8)
        assert retrace.is_warm() == (i >= 1)
    assert retrace.violations() == []
    counts = retrace.sites()
    assert {k for k, _ in counts} >= {"cachedop", "cachedop_bwd",
                                      "trainer_fused"}
    assert all(n == 1 for n in counts.values())


def test_disabled_observe_is_inert_and_cheap():
    assert not retrace.is_enabled()
    assert retrace.observe("k", 1, {"a": 1}, site="s") is None
    assert retrace.sites() == {}
    t0 = time.perf_counter()
    for _ in range(10_000):
        if retrace._enabled:  # pragma: no cover - the disabled path
            retrace.observe("k", 1, {"a": 1}, site="s")
    assert time.perf_counter() - t0 < 0.25


def test_history_and_violation_caps():
    retrace.enable("warn")
    retrace.warm()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(300):
            retrace.observe("k", 1, {"a": i}, site="s")
    assert retrace.sites()[("k", 1)] <= 64
    assert len(retrace.violations()) <= 256


# --- env wiring --------------------------------------------------------------

def _env(**kw):
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep +
                os.environ.get("PYTHONPATH", ""), **kw)


def test_env_raise_mode_wires_through_subprocess():
    code = ("from mxnet_tpu_torch.telemetry import retrace\n"
            "assert retrace.is_enabled() and retrace._mode == 'raise'\n"
            "assert retrace._warmup_steps == 3\n"
            "retrace.warm()\n"
            "retrace.observe('k', 1, {'a': 1}, site='env.site')\n"
            "retrace.observe('k', 1, {'a': 2}, site='env.site')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO,
                       env=_env(MXNET_SANITIZE_RETRACE="raise",
                                MXNET_SANITIZE_RETRACE_WARMUP="3"))
    assert r.returncode != 0
    assert "RetraceError" in r.stderr and "a: 1 -> 2" in r.stderr


def test_env_off_mode_is_inert_through_subprocess():
    code = ("from mxnet_tpu_torch.telemetry import retrace\n"
            "assert not retrace.is_enabled()\n"
            "assert retrace.observe('k', 1, {'a': 1}) is None\n"
            "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO,
                       env=_env(MXNET_SANITIZE_RETRACE="off"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK" in r.stdout


def test_telemetry_enable_retrace_flag():
    telemetry.enable(retrace="raise")
    assert retrace.is_enabled() and retrace._mode == "raise"


# --- records and the reference's reporter ------------------------------------

def _seed_records():
    telemetry.enable()
    sink = ListSink()
    telemetry.add_sink(sink)
    retrace.enable("warn")
    retrace.warm()
    retrace.observe("k", 7, {"x": ((2, 8), "float32", False), "m": None},
                    site="mod:site")
    with pytest.warns(RuntimeWarning):
        retrace.observe("k", 7, {"x": ((3, 8), "float32", False),
                                 "m": None}, site="mod:site")
    return [r for r in sink.records if r.get("record") == "retrace"]


def test_jsonl_records_schema():
    recs = _seed_records()
    assert [r["action"] for r in recs] == ["baseline", "warn"]
    base, viol = recs
    for r in recs:
        assert r["site"] == "mod:site" and r["kind"] == "k"
        assert r["instance"] == 7 and isinstance(r["where"], str)
        assert isinstance(r["components"], dict)
    assert base["signature_index"] == 0 and "diff" not in base
    assert viol["diff"] == ["x.shape: (2, 8) -> (3, 8)"]
    json.dumps(recs)


def test_retrace_report_reads_the_ports_jsonl(tmp_path, capsys):
    from tools import retrace_report

    recs = _seed_records()
    path = tmp_path / "telemetry.jsonl"
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
        f.write('{"record": "step", "step": 1}\n')
    assert retrace_report.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "mod:site" in out and "! sig #1" in out
    assert "x.shape: (2, 8) -> (3, 8)" in out

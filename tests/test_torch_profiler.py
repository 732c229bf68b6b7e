"""The profiler of the port (``mxnet_tpu_torch/profiler.py``) against the
JAX package's: the same op sequence, inside and outside a ``Scope``,
gives the same per-op counts in ``dumps`` and the same chrome-trace
events (names, phases, keys) in ``dump``; spans, counters and markers
alike; and the device trace runs through ``torch.profiler``."""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PACKAGES = ((jmx, {}), (tmx, {"ctx": tmx.cpu()}))


def _reset(tmp_path):
    """Both profilers stopped with empty buffers: each is process-wide,
    and another test file in the same worker may have left events
    (``dump`` of a finished profile clears them, ``dumps(reset=True)``
    the aggregate)."""
    for mx, _ in PACKAGES:
        mx.profiler.set_state("stop")
        mx.profiler.set_config(profile_device_trace=False,
                               filename=str(tmp_path / "reset.json"))
        mx.profiler.dump(finished=True)
        mx.profiler.dumps(reset=True)


@pytest.fixture(autouse=True)
def stopped(tmp_path):
    _reset(tmp_path)
    yield
    _reset(tmp_path)


def _sequence(mx, kw):
    x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), **kw)
    w = mx.nd.array(np.ones((3, 4), np.float32), **kw)
    with mx.profiler.Scope("fwd"):
        assert mx.profiler.current_scope_prefix() == "fwd:"
        y = mx.nd.dot(x, w)
        z = mx.nd.relu(y * 2.0 + 1.0)
    out = mx.nd.sigmoid(mx.nd.sum(z))
    mx.profiler.Marker("end").mark()
    mx.profiler.record_span_event("step", 0.0, 0.001, args={"n": 1})
    mx.profiler.record_counter_event("bytes", {"live": 3})
    return out


def _profile(mx, kw, tmp_path):
    path = tmp_path / f"{mx.__name__}.json"
    mx.profiler.set_config(filename=str(path), aggregate_stats=True)
    mx.profiler.set_state("run")
    assert mx.profiler.is_running()
    _sequence(mx, kw)
    mx.profiler.pause()
    _sequence(mx, kw)  # not recorded
    mx.profiler.resume()
    mx.nd.exp(mx.nd.array([1.0], **kw))
    mx.profiler.set_state("stop")
    agg = json.loads(mx.profiler.dumps(format="json"))
    table = mx.profiler.dumps(reset=True).splitlines()
    mx.profiler.dump()
    events = json.loads(path.read_text())["traceEvents"]
    return agg, table, events


def test_same_op_sequence_same_counts_and_events(tmp_path):
    (ragg, rtable, rev), (agg, table, ev) = [
        _profile(mx, kw, tmp_path) for mx, kw in PACKAGES]
    counts = {k: v["count"] for k, v in agg.items()}
    assert counts == {k: v["count"] for k, v in ragg.items()}
    assert counts["fwd:dot"] == counts["exp"] == counts["step"] == 1
    assert set(agg["sum"]) == set(ragg["sum"])
    assert table[0] == rtable[0]
    assert sorted(ln.split()[0] for ln in table[1:]) == \
        sorted(ln.split()[0] for ln in rtable[1:])
    assert [(e["name"], e["ph"], sorted(e)) for e in ev] == \
        [(e["name"], e["ph"], sorted(e)) for e in rev]
    stamps = [e["ts"] for e in ev if e["ph"] == "X" and e["name"] != "step"]
    assert stamps == sorted(stamps)  # one epoch across pause and resume
    assert {"n": "1"} == next(e["args"] for e in ev if e["name"] == "step")


def test_nothing_is_recorded_while_stopped(tmp_path):
    for mx, kw in PACKAGES:
        mx.profiler.set_config(filename=str(tmp_path / "p.json"))
        _sequence(mx, kw)
        assert json.loads(mx.profiler.dumps(format="json")) == {}
        assert not mx.profiler.is_running()


def test_bad_config_and_state_raise_in_both():
    for mx, _ in PACKAGES:
        with pytest.raises(mx.MXNetError, match="unknown profiler config"):
            mx.profiler.set_config(nope=True)
        with pytest.raises(mx.MXNetError, match="'run' or 'stop'"):
            mx.profiler.set_state("go")
        with pytest.raises(mx.MXNetError, match="unknown dumps format"):
            mx.profiler.dumps(format="csv")


def test_device_trace_runs_through_torch_profiler(tmp_path):
    prof = tmx.profiler
    prof.set_config(filename=str(tmp_path / "dev.json"),
                    profile_device_trace=True)
    prof.set_state("run")
    with tmx.cpu():
        x = tmx.nd.ones((64, 64))
        tmx.nd.dot(x, x).wait_to_read()
    prof.set_state("stop")
    trace = json.loads((tmp_path / "dev_torch_trace.json").read_text())
    assert trace["traceEvents"]
    keys = [k.key for k in prof.device_profile().key_averages()]
    assert any("mm" in k or "tensordot" in k for k in keys), keys

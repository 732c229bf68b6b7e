"""``InferenceServer`` and ``BatchScheduler`` of the PyTorch/CUDA port
against the JAX package's, on the CPU.

Two models, each served by both packages from concurrent client threads
with the same weights: a hybridized ``Dense`` stack (a gluon block,
position-wise, so a reply's rows are trimmed back along
``output_length_axis``), and ``bert_tiny`` as a callable that builds
``valid_length`` from the padded ids (pad id 0, as ``pad_batch`` pads)
and returns the pooled output.  Replies are held to the reference
server's and to the request's solo forward: the f32 Dense stack to
1e-5, BERT to 1e-4 (two layers, other summation orders; the padded
batch and the solo forward run the masked route over other lengths).
Then the server's own contract: bucketing (signatures within the
policy's ceiling, one miss a signature), dynamic batching (fewer
batches than requests), backpressure, draining, the host-side
observability calls, and the refused forms.  Every wait has a timeout.
"""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving
from mxnet_tpu.models import bert as jbert

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.serving import (ServerClosedError,
                                     ServerOverloadedError)

CPU = tmx.cpu()
WAIT = 60.0
DENSE_TOL = 1e-5
BERT_TOL = 1e-4
V = 50


def _dense(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, flatten=False, activation="relu"),
            pkg.gluon.nn.Dense(5, flatten=False))
    return net


def _carry(jnet, make_port):
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    tnet = make_port()
    load_numpy_params(tnet, arrays, ctx=CPU)
    return tnet


@pytest.fixture(scope="module")
def dense_pair():
    jnet = _dense(jmx)
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 8, 6)))
    tnet = _carry(jnet, lambda: _dense(tmx))
    return jnet, tnet


@pytest.fixture(scope="module")
def bert_pair():
    def make(m):
        return m.bert_tiny(vocab_size=V, dropout=0.0, use_decoder=False,
                           use_classifier=False)

    jnet = make(jbert)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(np.ones((1, 4), np.int32), dtype="int32"))
    return jnet, _carry(jnet, lambda: make(tbert))


def _bert_callable(pkg, net, ctx=None):
    """The serving callable: padded ids → valid_length (pad id 0) → the
    pooled output (B, units)."""
    kw = {"ctx": ctx} if ctx is not None else {}

    def call(batch):
        ids = batch["data"]
        vl = (ids != 0).sum(axis=1).astype(np.float32)
        return net(pkg.nd.array(ids, dtype="int32", **kw), None,
                   pkg.nd.array(vl, **kw))[1]

    return call


def _serve(srv, inputs):
    """Every input from its own client thread → the replies in order."""
    results = [None] * len(inputs)
    errors = []

    def client(i):
        try:
            results[i] = srv.infer(inputs[i], timeout=WAIT)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    with srv:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(inputs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    assert not errors, errors
    return results


LENGTHS = [3, 5, 9, 7, 12, 4, 8, 15, 2, 6, 11, 16]


def _dense_config(pkg):
    return pkg.ServerConfig(max_batch=4, max_length=16, min_batch=2,
                            min_length=8, output_length_axis=0,
                            batch_window_ms=10.0)


def test_hybridized_block_replies_match_the_reference_server(dense_pair):
    jnet, tnet = dense_pair
    jnet.hybridize()
    tnet.hybridize()
    rs = np.random.RandomState(11)
    inputs = [rs.randn(n, 6).astype(np.float32) for n in LENGTHS]
    ref = _serve(jserving.InferenceServer(jnet, _dense_config(jserving)),
                 inputs)
    srv = tserving.InferenceServer(tnet, _dense_config(tserving))
    got = _serve(srv, inputs)
    stats = srv.stats()
    for x, g, r in zip(inputs, got, ref):
        assert g.shape == r.shape == (len(x), 5)
        np.testing.assert_allclose(g, r, atol=DENSE_TOL, rtol=0)
        solo = tnet(tmx.nd.array(x[None], ctx=CPU)).asnumpy()[0]
        np.testing.assert_allclose(g, solo, atol=DENSE_TOL, rtol=0)
    cache = stats["cache"]
    assert 1 <= cache["signatures"] <= stats["signature_ceiling"] == 4
    assert cache["misses"] == cache["signatures"]
    assert stats["completed"] == len(inputs) and stats["failed"] == 0
    assert stats["batches"] < len(inputs)


def test_bert_callable_replies_match_the_reference_server(bert_pair):
    jnet, tnet = bert_pair
    rs = np.random.RandomState(12)
    inputs = [rs.randint(1, V, n).astype(np.int32) for n in LENGTHS]

    def config(pkg):
        return pkg.ServerConfig(max_batch=4, max_length=16, min_length=8,
                                batch_window_ms=10.0)

    ref = _serve(jserving.InferenceServer(_bert_callable(jmx, jnet),
                                          config(jserving)), inputs)
    srv = tserving.InferenceServer(_bert_callable(tmx, tnet, CPU),
                                   config(tserving))
    got = _serve(srv, inputs)
    for ids, g, r in zip(inputs, got, ref):
        assert g.shape == r.shape == (128,)
        np.testing.assert_allclose(g, r, atol=BERT_TOL, rtol=0)
        solo = tnet(tmx.nd.array(ids[None], ctx=CPU, dtype="int32"))[1]
        np.testing.assert_allclose(g, solo.asnumpy()[0], atol=BERT_TOL,
                                   rtol=0)
    assert srv.stats()["batches"] < len(inputs)
    assert "cache" not in srv.stats()  # a callable has no CachedOp


class _Gate:
    """A callable model whose every batch waits until ``go`` is set."""

    def __init__(self):
        self.entered = threading.Event()
        self.go = threading.Event()
        self.batches = []

    def __call__(self, batch):
        self.batches.append(batch["data"].shape)
        self.entered.set()
        assert self.go.wait(WAIT)
        return batch["data"] * 2.0


def _gated(capacity=64):
    gate = _Gate()
    srv = tserving.InferenceServer(gate, tserving.ServerConfig(
        max_batch=2, max_length=8, min_length=8, queue_capacity=capacity,
        batch_window_ms=0.0, output_length_axis=0))
    return gate, srv


def test_overloaded_at_capacity():
    gate, srv = _gated(capacity=2)
    srv.start()
    try:
        first = srv.submit(np.ones(3, np.float32))
        assert gate.entered.wait(WAIT)  # the loop holds the first batch
        queued = [srv.submit(np.ones(3, np.float32)) for _ in range(2)]
        with pytest.raises(ServerOverloadedError):
            srv.submit(np.ones(3, np.float32))
        assert srv.health()["rejected"] == 1
        gate.go.set()
        for f in [first] + queued:
            np.testing.assert_array_equal(f.result(WAIT),
                                          np.full(3, 2.0, np.float32))
    finally:
        gate.go.set()
        srv.stop()
    assert srv.stats()["rejected"] == 1


@pytest.mark.parametrize("drain", [True, False])
def test_stop_drains_or_fails_the_leftovers(drain):
    gate, srv = _gated()
    srv.start()
    first = srv.submit(np.ones(2, np.float32))
    assert gate.entered.wait(WAIT)
    left = [srv.submit(np.full(4, i, np.float32)) for i in range(3)]
    flight = srv.in_flight()
    assert [r["state"] for r in flight] == ["queued"] * 3
    assert [r["length"] for r in flight] == [4, 4, 4]
    assert srv.health()["status"] == "ok"
    assert srv.health()["queue_depth"] == 3
    stopper = threading.Thread(target=srv.stop, kwargs={"drain": drain})
    stopper.start()
    # the loop must see the stop before it is released, or it would take
    # the leftovers itself
    deadline = time.monotonic() + WAIT
    while not srv._sched._stop.is_set() and time.monotonic() < deadline:
        time.sleep(0.001)
    assert srv._sched._stop.is_set()
    gate.go.set()
    stopper.join(WAIT)
    assert not stopper.is_alive()
    np.testing.assert_array_equal(first.result(WAIT), np.full(2, 2.0))
    for i, f in enumerate(left):
        if drain:
            np.testing.assert_array_equal(f.result(WAIT),
                                          np.full(4, 2.0 * i))
        else:
            with pytest.raises(ServerClosedError):
                f.result(WAIT)
    stats = srv.stats()
    assert stats["completed"] == (4 if drain else 1)
    assert stats["batches"] == (3 if drain else 1)  # 3 left: 2 + 1
    assert srv.health()["status"] == "stopped"
    with pytest.raises(ServerClosedError):
        srv.submit(np.ones(2, np.float32))


def test_oversized_request_is_refused_at_admission():
    """A length above ``max_length`` raises at submit (in the JAX
    package it reaches the scheduler thread, whose bucketing raises
    there); the server goes on serving."""
    gate, srv = _gated()
    gate.go.set()
    with srv:
        with pytest.raises(tmx.MXNetError, match="exceeds"):
            srv.submit(np.ones(9, np.float32))
        np.testing.assert_array_equal(
            srv.infer(np.ones(8, np.float32), timeout=WAIT),
            np.full(8, 2.0))
    assert srv.stats()["completed"] == 1


def test_failed_batch_fails_its_requests():
    def broken(batch):
        raise ValueError("model fault")

    srv = tserving.InferenceServer(broken, tserving.ServerConfig(
        max_batch=2, max_length=8))
    with srv:
        f = srv.submit(np.ones(3, np.float32))
        with pytest.raises(ValueError, match="model fault"):
            f.result(WAIT)
    assert srv.stats()["failed"] == 1 and srv.stats()["completed"] == 0


def test_refused_forms_name_the_slice():
    class FakePredictor:
        input_names = ["data"]

        def forward(self, **kw):
            return kw

    # summary_every is ported in slice 20 (the rolling serving.latency
    # records, tests/test_torch_serving_metrics.py)
    assert tserving.ServerConfig(summary_every=32).summary_every == 32
    # InferenceServer(Predictor) is ported in slice 17
    # (tests/test_torch_export.py serves a real one)
    srv = tserving.InferenceServer(FakePredictor())
    assert srv.input_names == ["data"] and srv._predictor is not None
    # int8 and calib_data are ported in slice 14: a callable is served as
    # it is (the reference quantizes blocks only), a block needs
    # calib_data
    srv = tserving.InferenceServer(lambda b: b,
                                   tserving.ServerConfig(int8=True))
    assert srv.model is not None
    with pytest.raises(tmx.MXNetError, match="calib_data"):
        tserving.InferenceServer(_dense(tmx), tserving.ServerConfig(
            int8=True))


def test_config_reads_the_inference_keys():
    cfg = tserving.ServerConfig(batch_window_ms=5.0, length_axis=1,
                                output_length_axis=0)
    assert (cfg.batch_window_ms, cfg.length_axis,
            cfg.output_length_axis) == (5.0, 1, 0)
    srv = tserving.InferenceServer(lambda b: b["data"], cfg)
    assert srv._sched.batch_window_s == 0.005
    assert srv._sched.length_axis == 1


def test_materialize_waits_on_an_event_for_ndarrays_on_a_card(monkeypatch):
    """A batch's outputs on a card, as NDArrays (what a block or a
    callable model returns), take the event wait before their copy to
    the host; outputs on the host take none."""
    from mxnet_tpu_torch.serving import scheduler

    waits = []

    class Event:
        def record(self):
            pass

        def synchronize(self):
            waits.append(1)

    class OnCard:  # an NDArray's form: its tensor in ``_data``
        _data = type("Tensor", (), {"is_cuda": True})()

        def asnumpy(self):
            return np.ones(2, np.float32)

    monkeypatch.setattr(scheduler.torch.cuda, "Event", Event)
    out = scheduler._materialize([OnCard(), np.zeros(2)])
    assert waits == [1]
    np.testing.assert_array_equal(out[0], np.ones(2))
    scheduler._materialize([tmx.nd.array(np.ones(2), ctx=tmx.cpu()),
                            np.zeros(2)])
    assert waits == [1]

"""Hybridized blocks under ``autograd.record()``, the port against the
JAX package on the CPU (the reference's ``tests/test_gluon.py`` cases of
hybridized training, on the recorded path).

The reference records a hybridized block as ONE tape node whose forward
and backward are jitted; the port, on a card, replays a CUDA graph pair
as one node of torch's tape, and on the CPU runs the recorded forward
eagerly.  Each case builds the same net in both packages from numpy
weights (structural names), runs the same recorded program and holds
the port's loss and every gradient against the reference's within
1e-5 relative and 1e-6 absolute (f32; the two packages' kernels sum in
other orders), and against the port's own unhybridized net bit for bit.
Cases: gradients of a hybridized net; one block called twice under one
``record()`` before its backward; BatchNorm's moving statistics under
record; ``grad_req`` ``"write"``, ``"add"`` and ``"null"`` with an input
that ``attach_grad()``s; a second ``backward(retain_graph=True)``; the
remat tiers; ``create_graph=True``, which the reference's jitted node
refuses (the port's CPU path is eager and differentiates twice); and
the bounds of the card's graph pairs, on stand-in instances.
BatchNorm's gradients are held within 1e-4 relative and 1e-5 absolute:
its backward subtracts batch means, which cancels leading digits.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_numpy_params

CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-6)
X = np.random.RandomState(3).randn(6, 5).astype(np.float32)


def _build(mx, bn=False):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="tanh", in_units=5, prefix="d0_"))
        if bn:
            net.add(nn.BatchNorm(axis=-1, in_channels=16, prefix="bn_"))
        net.add(nn.Dense(4, in_units=16, prefix="d1_"))
    return net


def _weights(bn=False):
    rs = np.random.RandomState(11)
    w = {"0.weight": rs.randn(16, 5) * 0.4, "0.bias": rs.randn(16) * 0.1}
    if bn:
        w.update({"1.gamma": rs.uniform(0.7, 1.3, 16),
                  "1.beta": rs.randn(16) * 0.1,
                  "1.running_mean": rs.randn(16) * 0.1,
                  "1.running_var": rs.uniform(0.5, 1.5, 16)})
    last = "2" if bn else "1"
    w.update({last + ".weight": rs.randn(4, 16) * 0.4,
              last + ".bias": rs.randn(4) * 0.1})
    return {k: v.astype(np.float32) for k, v in w.items()}


def _port(bn=False, hybrid=True, **kw):
    net = _build(tmx, bn)
    load_numpy_params(net, _weights(bn), ctx=CPU)
    if hybrid:
        net.hybridize(**kw)
    return net


def _ref(bn=False, **kw):
    net = _build(jmx, bn)
    net.initialize(jmx.init.Zero())
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(_weights(bn)[k]))
    net.hybridize(**kw)
    return net


def _x(mx):
    return mx.nd.array(X, ctx=CPU) if mx is tmx else mx.nd.array(X)


def _grads(net):
    return {k: p.grad().asnumpy()
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _assert_same(port, ref, exact=False):
    assert port.keys() == ref.keys()
    for k in ref:
        if exact:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(port[k], ref[k], err_msg=k, **TOL)


def _twice(mx, net):
    x = _x(mx)
    with mx.autograd.record():
        a = net(x)
        b = net(x * 0.5)
        loss = (a * b).sum() + (a ** 2).mean()
    loss.backward()
    return float(loss.asscalar()), _grads(net)


def test_hybridize_gradients_match_the_reference():
    out = {}
    for name, mx, net in (("plain", tmx, _port(hybrid=False)),
                          ("hyb", tmx, _port()), ("ref", jmx, _ref())):
        with mx.autograd.record():
            loss = net(_x(mx)).sum()
        loss.backward()
        out[name] = (float(loss.asscalar()), _grads(net))
    assert out["hyb"][0] == out["plain"][0]
    _assert_same(out["hyb"][1], out["plain"][1], exact=True)
    np.testing.assert_allclose(out["hyb"][0], out["ref"][0], **TOL)
    _assert_same(out["hyb"][1], out["ref"][1])


def test_block_called_twice_before_its_backward():
    plain = _twice(tmx, _port(hybrid=False))
    hyb = _twice(tmx, _port())
    ref = _twice(jmx, _ref())
    assert hyb[0] == plain[0]
    _assert_same(hyb[1], plain[1], exact=True)
    np.testing.assert_allclose(hyb[0], ref[0], **TOL)
    _assert_same(hyb[1], ref[1])


def test_batchnorm_moving_statistics_update_under_record():
    stats = {}
    for name, mx, net in (("hyb", tmx, _port(bn=True)),
                          ("ref", jmx, _ref(bn=True))):
        bn = net[1]
        seen = []
        for _ in range(2):
            with mx.autograd.record():
                loss = (net(_x(mx)) ** 2).sum()
            loss.backward()
            seen.append((bn.running_mean.data().asnumpy().copy(),
                         bn.running_var.data().asnumpy().copy()))
        stats[name] = (seen, _grads(net))
    for (pm, pv), (rm, rv) in zip(stats["hyb"][0], stats["ref"][0]):
        np.testing.assert_allclose(pm, rm, **TOL)
        np.testing.assert_allclose(pv, rv, **TOL)
    assert not np.allclose(stats["hyb"][0][0][0], stats["hyb"][0][1][0])
    for k, g in stats["ref"][1].items():  # BN's backward cancels means
        np.testing.assert_allclose(stats["hyb"][1][k], g, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_and_attached_input(req):
    out = {}
    for name, mx, net in (("hyb", tmx, _port()), ("ref", jmx, _ref())):
        net[0].weight.grad_req = req
        x = _x(mx)
        x.attach_grad()
        for _ in range(2):
            with mx.autograd.record():
                loss = (net(x) ** 2).sum()
            loss.backward()
        out[name] = (_grads(net), x.grad.asnumpy())
    _assert_same(out["hyb"][0], out["ref"][0])
    np.testing.assert_allclose(out["hyb"][1], out["ref"][1], **TOL)
    assert ("0.weight" in out["hyb"][0]) == (req != "null")


def test_second_backward_with_retain_graph():
    out = {}
    for name, mx, net in (("hyb", tmx, _port()), ("ref", jmx, _ref())):
        for p in net.collect_params().values():
            p.grad_req = "add"
        with mx.autograd.record():
            loss = net(_x(mx)).sum()
        loss.backward(retain_graph=True)
        loss.backward()
        out[name] = _grads(net)
    _assert_same(out["hyb"], out["ref"])


@pytest.mark.parametrize("remat", ["dots", "layer"])
def test_remat_tiers_match_the_reference(remat):
    out = {}
    for name, mx, net in (("plain", tmx, _port()),
                          ("hyb", tmx, _port(remat=remat)),
                          ("ref", jmx, _ref(remat=remat))):
        x = _x(mx)
        x.attach_grad()
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        out[name] = (float(loss.asscalar()), _grads(net), x.grad.asnumpy())
    assert out["hyb"][0] == out["plain"][0]
    _assert_same(out["hyb"][1], out["plain"][1], exact=True)
    np.testing.assert_allclose(out["hyb"][0], out["ref"][0], **TOL)
    _assert_same(out["hyb"][1], out["ref"][1])
    np.testing.assert_allclose(out["hyb"][2], out["ref"][2], **TOL)


def test_create_graph_through_a_hybridized_block():
    net = _ref()
    x = _x(jmx)
    x.attach_grad()
    with jmx.autograd.record():
        y = (net(x) ** 2).sum()
        with pytest.raises(jmx.MXNetError, match="create_graph"):
            jmx.autograd.grad(y, [x], create_graph=True)
    got = {}
    for name, net in (("hyb", _port()), ("plain", _port(hybrid=False))):
        x = _x(tmx)
        x.attach_grad()
        with tmx.autograd.record():
            y = (net(x) ** 2).sum()
            g = tmx.autograd.grad(y, [x], create_graph=True)[0]
            z = (g * g).sum()
        z.backward()
        got[name] = x.grad.asnumpy()
    np.testing.assert_array_equal(got["hyb"], got["plain"])


def test_recorded_calls_on_the_cpu_count_as_recorded():
    net = _port()
    for _ in range(3):
        with tmx.autograd.record():
            net(_x(tmx)).sum().backward()
    assert net.cache_stats() == {"hits": 0, "misses": 0, "signatures": 0,
                                 "recorded": 3}


def test_recorded_graph_pairs_are_bounded(monkeypatch):
    """A CachedOp keeps at most ``_MAX_RECORDED_GRAPHS`` instances of its
    recorded graph pairs and the process's instances at most
    ``cuda_graph.budget`` bytes: a capture first drops the free
    instances of the least recently used other signatures, never one an
    outstanding call still needs, and finds no room when every kept
    instance is busy (the call then runs eagerly on the card)."""
    import types
    import weakref

    import torch

    from mxnet_tpu_torch import cuda_graph
    from mxnet_tpu_torch.gluon import block as tblock

    class Node:  # a tape node whose backward has not run yet
        saved_tensors = ()

    busy = Node()
    made = []

    def entry(sig, nbytes, node=None):
        inst = tblock._RecordedInstance()
        inst.fwd = types.SimpleNamespace(pool_bytes=nbytes)
        inst.bwd = types.SimpleNamespace(pool_bytes=nbytes)
        if node is not None:
            inst.owner = weakref.ref(node)
        tblock._RECORDED.add(inst)
        made.append(inst)
        e = op._rec_graphs[sig] = tblock._RecordedEntry(sig)
        e.instances.append(inst)

    cpu = torch.device("cpu")
    monkeypatch.setattr(tblock, "_MAX_RECORDED_GRAPHS", 2)
    op = tblock.CachedOp(_port())
    entry("a", 10)
    entry("b", 10)
    assert op.recorded_graph_bytes() == 40
    assert op._make_room("c", cpu)  # "a", least recently used, dropped
    assert [len(op._rec_graphs[s].instances) for s in "ab"] == [0, 1]
    entry("c", 10, busy)  # kept: b (free) and c (busy)
    assert op._make_room("c", cpu)  # b dropped, c's own kept
    assert [len(op._rec_graphs[s].instances) for s in "bc"] == [0, 1]
    entry("d", 10, busy)
    assert not op._make_room("e", cpu)  # both kept instances busy
    assert [len(op._rec_graphs[s].instances) for s in "cd"] == [1, 1]
    monkeypatch.setattr(cuda_graph, "budget", lambda device: 45)
    monkeypatch.setattr(tblock, "_MAX_RECORDED_GRAPHS", 4)
    op2 = tblock.CachedOp(_port())
    assert not op2._make_room("x", cpu)  # c and d hold 40 + 40 bytes

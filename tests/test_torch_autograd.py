"""Autograd, the training ops and the losses of the PyTorch/CUDA port
against the JAX package.

The same numpy inputs go through both packages' ``attach_grad`` /
``record`` / ``backward``; everything runs on the CPU in f32 unless a
test says otherwise.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import loss as jloss

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.gluon import loss as tloss

CPU = tmx.cpu()


def _x(seed=0, shape=(3, 4)):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _pair(a):
    """The same array as a JAX NDArray and a port NDArray, both attached."""
    j, t = jmx.nd.array(a), tmx.nd.array(a, ctx=CPU)
    return j, t


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_across_two_backward_calls(req):
    """write overwrites, add accumulates (the reference never zeroes
    between calls); with null nothing is recorded, so both packages
    refuse the backward and keep no gradient."""
    a = _x(1)
    out = []
    for mx, ag in ((jmx, jag), (tmx, tag)):
        x = mx.nd.array(a) if mx is jmx else mx.nd.array(a, ctx=CPU)
        x.attach_grad(req)
        for scale in (2.0, 3.0):
            with ag.record():
                y = (x * x * scale).sum()
            if req == "null":
                with pytest.raises(mx.MXNetError, match="attached"):
                    y.backward()
            else:
                y.backward()
        out.append(None if x.grad is None else x.grad.asnumpy())
    if req == "null":
        assert out == [None, None]
        return
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6)
    expect = 6 * a if req == "write" else 10 * a
    np.testing.assert_allclose(out[1], expect, rtol=1e-6)


def test_parameter_grad_req_and_zero_grad():
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=CPU)
    x = tmx.nd.array(_x(2, (4, 3)), ctx=CPU)
    assert float(net.weight.grad().asnumpy().std()) == 0.0  # zeros
    net.weight.grad_req = "add"
    for _ in range(2):
        with tag.record():
            y = net(x).sum()
        y.backward()
    np.testing.assert_allclose(net.weight.grad().asnumpy(),
                               2 * np.tile(x.asnumpy().sum(0), (2, 1)),
                               rtol=1e-5)
    net.collect_params().zero_grad()
    assert not net.weight.grad().asnumpy().any()
    net.bias.grad_req = "null"
    with pytest.raises(tmx.MXNetError, match="null"):
        net.bias.grad()
    assert not net.bias.data()._data.requires_grad
    with pytest.raises(tmx.MXNetError):
        net.weight.grad_req = "sometimes"


def test_head_gradients_match_reference():
    a, hg = _x(3), _x(4)
    out = []
    for nd, ag, kw in ((jmx.nd, jag, {}), (tmx.nd, tag, {"ctx": CPU})):
        x = nd.array(a, **kw)
        x.attach_grad()
        with ag.record():
            y = x * x + x
            z = y * 2
        ag.backward([y, z], [nd.array(hg, **kw), nd.array(hg, **kw)])
        out.append(x.grad.asnumpy())
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5)
    np.testing.assert_allclose(out[1], 3 * hg * (2 * a + 1), rtol=1e-5)


def test_second_backward_needs_retain_graph():
    x = tmx.nd.array(_x(5), ctx=CPU)
    x.attach_grad()
    with tag.record():
        y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 2 * x.asnumpy(), rtol=1e-6)
    with pytest.raises(tmx.MXNetError, match="retain_graph"):
        y.backward()
    with pytest.raises(tmx.MXNetError, match="attached"):
        tmx.nd.array(_x(5), ctx=CPU).backward()


@pytest.mark.parametrize("req", ["write", "add"])
def test_write_gradient_is_released_before_the_backward(req):
    """A "write" buffer's old gradient is freed before the new one is
    computed (one gradient set alive at the peak); an "add" buffer keeps
    its old gradient, which the new one is added to."""
    import weakref

    x = tmx.nd.array(_x(7), ctx=CPU)
    x.attach_grad(req)
    old_alive = []
    for _ in range(2):
        old = weakref.ref(x.grad._data)
        with tag.record():
            y = x * x
            y._data.register_hook(
                lambda g: old_alive.append(old() is not None))
            s = y.sum()
        s.backward()
    assert old_alive == [req == "add"] * 2
    np.testing.assert_allclose(x.grad.asnumpy(),
                               (2 if req == "write" else 4) * x.asnumpy(),
                               rtol=1e-6)
    # a backward that fails leaves the released "write" gradient zero
    with pytest.raises(tmx.MXNetError, match="retain_graph"):
        s.backward()
    if req == "write":
        assert not x.grad.asnumpy().any()


def test_write_gradient_reached_without_a_gradient_is_zero():
    """A variable the heads reach through an op that passes it no
    gradient gets zeros under "write", not its released old gradient."""
    class NoGrad(tag.Function):
        def forward(self, x):
            return x * 2

        def backward(self, dy):
            return (None,)

    x = tmx.nd.array(_x(8), ctx=CPU)
    x.attach_grad()
    with tag.record():
        s = (x * 3).sum()
    s.backward()
    with tag.record():
        s = NoGrad()(x).sum()
    s.backward()
    assert x.grad.shape == x.shape and not x.grad.asnumpy().any()


def test_nothing_is_taped_outside_record_or_under_pause():
    x = tmx.nd.array(_x(6), ctx=CPU)
    x.attach_grad()
    assert (x * 2)._data.grad_fn is None
    with tag.record():
        with tag.pause():
            assert (x * 2)._data.grad_fn is None
            assert not tag.is_recording()
        assert tag.is_recording() and tag.is_training()
        assert (x * 2)._data.grad_fn is not None
    with tag.predict_mode():
        assert not tag.is_training()


def test_autograd_grad_and_mark_variables():
    a = _x(7)
    jx, tx = _pair(a)
    jx.attach_grad()
    tx.attach_grad()
    with jag.record():
        jy = (jx * jx * jx).sum()
    with tag.record():
        ty = (tx * tx * tx).sum()
    (jg,) = jag.grad(jy, [jx])
    (tg,) = tag.grad(ty, [tx])
    np.testing.assert_allclose(tg.asnumpy(), jg.asnumpy(), rtol=1e-5)
    assert not tx.grad.asnumpy().any()  # grad() leaves the buffer alone
    # higher-order gradients (ported in slice 18): the gradient stays in
    # the graph, and its own gradient is the reference's
    seconds = []
    for ag, x in ((jag, jx), (tag, tx)):
        with ag.record():
            y = (x * x * x).sum()
            (g,) = ag.grad(y, [x], create_graph=True)
            z = (g * g).sum()
        z.backward()
        seconds.append(x.grad.asnumpy())
    np.testing.assert_allclose(seconds[1], seconds[0], rtol=1e-5)
    np.testing.assert_allclose(seconds[1], 36 * a ** 3, rtol=1e-5)
    tx.grad._data.zero_()
    buf = tmx.nd.array(np.zeros_like(a), ctx=CPU)
    v = tmx.nd.array(a, ctx=CPU)
    tag.mark_variables([v], [buf])
    with tag.record():
        w = (v * 4).sum()
    w.backward()
    assert v.grad is buf
    np.testing.assert_allclose(buf.asnumpy(), np.full_like(a, 4.0))


def test_custom_function_matches_reference():
    a = _x(8)
    out = []
    for mx, ag, kw in ((jmx, jag, {}), (tmx, tag, {"ctx": CPU})):
        class Square(ag.Function):
            def forward(self, x):
                self.save_for_backward(x)
                return x * x

            def backward(self, dy):
                (x,) = self.saved_tensors
                return dy * x * 2

        x = mx.nd.array(a, **kw)
        x.attach_grad()
        with ag.record():
            y = Square()(x)
            z = (y * 3).sum()
        z.backward()
        out.append((y.asnumpy(), x.grad.asnumpy()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6)
    np.testing.assert_allclose(out[1][1], 6 * a, rtol=1e-6)


def test_softmax_cross_entropy_value_and_bf16_gradient_dtype():
    """The sum over rows of -log_softmax[label], f32 inside; a bf16
    logits tensor gets a bf16 gradient."""
    logits = _x(9, (5, 7)) * 3
    labels = np.array([0, 6, 3, 3, 1], np.int32)
    ref = jmx.nd.softmax_cross_entropy(jmx.nd.array(logits),
                                       jmx.nd.array(labels, dtype="int32"))
    x = tmx.nd.array(logits, ctx=CPU)
    x.attach_grad()
    with tag.record():
        got = tmx.nd.softmax_cross_entropy(
            x, tmx.nd.array(labels, ctx=CPU, dtype="int32"))
    got.backward()
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got.asscalar()) - float(ref.asscalar())) <= 1e-5
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    p[np.arange(5), labels] -= 1
    np.testing.assert_allclose(x.grad.asnumpy(), p, atol=1e-6)

    xb = tmx.nd.array(logits, ctx=CPU, dtype="bfloat16")
    xb.attach_grad()
    with tag.record():
        lb = tmx.nd.softmax_cross_entropy(
            xb, tmx.nd.array(labels, ctx=CPU, dtype="int32"))
    lb.backward()
    assert lb.dtype == torch.float32 and xb.grad.dtype == torch.bfloat16
    # bf16 logits: the gradient is rounded to 8 mantissa bits (|g| < 1)
    assert np.abs(xb.grad.asnumpy() - p).max() <= 2 ** -8
    # log_softmax is the reference's too
    np.testing.assert_allclose(
        tmx.nd.log_softmax(x).asnumpy(),
        jmx.nd.log_softmax(jmx.nd.array(logits)).asnumpy(), atol=1e-6)


@pytest.mark.parametrize("make,sparse", [
    (lambda m: m.L2Loss(), False),
    (lambda m: m.L1Loss(weight=0.5), False),
    (lambda m: m.SoftmaxCrossEntropyLoss(), True),
    (lambda m: m.SoftmaxCrossEntropyLoss(sparse_label=False), False),
    (lambda m: m.SoftmaxCELoss(from_logits=True), True),
])
def test_losses_match_reference(make, sparse):
    pred = _x(10, (4, 5))
    label = np.array([1, 0, 4, 2], np.float32) if sparse else \
        np.abs(_x(11, (4, 5)))
    out = []
    for mx, ag, m, kw in ((jmx, jag, jloss, {}),
                          (tmx, tag, tloss, {"ctx": CPU})):
        p = mx.nd.array(pred, **kw)
        p.attach_grad()
        with ag.record():
            loss = make(m)(p, mx.nd.array(label, **kw))
        loss.backward()
        out.append((loss.asnumpy(), p.grad.asnumpy()))
    assert out[1][0].shape == (4,)
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-5, atol=1e-6)


def test_ndarray_training_surface():
    x = tmx.nd.array(np.arange(12, dtype="f").reshape(3, 4), ctx=CPU)
    assert x.reshape((0, -1, 2)).shape == (3, 2, 2)
    assert x.reshape(-1).shape == (12,)
    assert x.reshape((-3,)).shape == (12,)
    assert x.reshape((-4, 1, 3, -2)).shape == (1, 3, 4)
    assert float(x.sum().asscalar()) == 66.0
    np.testing.assert_allclose(x.mean(axis=1).asnumpy(), [1.5, 5.5, 9.5])
    assert x.sum(axis=0, keepdims=True).shape == (1, 4)
    assert x.wait_to_read() is x
    with pytest.raises(tmx.MXNetError, match="scalar"):
        x.asscalar()
    x.attach_grad()
    with tag.record():
        y = x * 2
    d = y.detach()
    assert d._data.grad_fn is None and y._data.grad_fn is not None
    src = np.ones(3, "f")
    tmx.nd.array(src, ctx=CPU)._data.add_(1)
    assert (src == 1).all()  # nd.array copies the host array
    init = tmx.init.Xavier()
    net = tmx.gluon.nn.Dense(200, in_units=100, use_bias=False)
    net.initialize(init, ctx=CPU)
    w = net.weight.data()._data.detach()
    bound = np.sqrt(3.0 / 150.0)
    assert float(w.abs().max()) <= bound and float(w.std()) > 0.5 * bound

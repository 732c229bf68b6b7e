"""Custom ops (``mx.operator``, ``nd.Custom``) and ``mx.rtc`` of the
PyTorch/CUDA port against the JAX package, on the CPU.

The reference's cases (``tests/test_custom_op.py``): a sigmoid written as
a ``CustomOp`` with its own backward, registered under a name, run
eagerly and under ``autograd.record()`` in both packages on the same
inputs, outputs and input gradients within 1e-6 relative (both compute
in numpy through ``asnumpy``).  The reference's jitted route
(``pure_callback``) is a hybridized block here: on the CPU, as on a card,
a block whose forward reaches ``Custom`` runs eagerly on every call
(``cache_stats()["eager"]``), so a second call follows its own input
(trap 3).  ``rtc.PallasKernel`` wraps the same callable in both packages
(the arithmetic reads the same on jax arrays and torch tensors): value
and gradient within 1e-6.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx

CPU = tmx.cpu()


def _register(mx, name, calls):
    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            calls.append(("forward", is_train))
            x = in_data[0].asnumpy()
            y = 1.0 / (1.0 + onp.exp(-x))
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            calls.append(("backward",))
            y = out_data[0].asnumpy()
            gy = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0], mx.nd.array(gy * y * (1 - y)))

    @mx.operator.register(name)
    class SigmoidProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    return SigmoidProp


class _Scale(tmx.operator.CustomOp):
    """Two outputs, a keyword from the prop's constructor, "add" writes."""

    def __init__(self, factor):
        self.factor = factor

    def forward(self, is_train, req, in_data, out_data, aux):
        a, b = in_data
        self.assign(out_data[0], req[0], a * self.factor + b)
        self.assign(out_data[1], req[1], a - b)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        g0, g1 = out_grad
        self.assign(in_grad[0], req[0], g0 * self.factor + g1)
        self.assign(in_grad[1], req[1], g0 - g1)


@tmx.operator.register("torch_test_scale")
class _ScaleProp(tmx.operator.CustomOpProp):
    def __init__(self, factor="1"):
        super().__init__()
        self.factor = float(factor)

    def list_arguments(self):
        return ["a", "b"]

    def list_outputs(self):
        return ["sum", "diff"]

    def create_operator(self, ctx, shapes, dtypes):
        return _Scale(self.factor)


CALLS = {"j": [], "t": []}
_register(jmx, "torch_test_sigmoid", CALLS["j"])
_register(tmx, "torch_test_sigmoid", CALLS["t"])
X = onp.array([0.0, 1.0, -1.0, 2.5], onp.float32)


def _sigmoid(mx, x, record):
    kw = {"ctx": CPU} if mx is tmx else {}
    a = mx.nd.array(x, **kw)
    a.attach_grad()
    if not record:
        return mx.nd.Custom(a, op_type="torch_test_sigmoid").asnumpy(), None
    with mx.autograd.record():
        y = mx.nd.Custom(a, op_type="torch_test_sigmoid")
        loss = (y * y).sum()
    loss.backward()
    return y.asnumpy(), a.grad.asnumpy()


@pytest.mark.parametrize("record", [False, True])
def test_custom_op_forward_backward_match_the_reference(record):
    ref = _sigmoid(jmx, X, record)
    got = _sigmoid(tmx, X, record)
    expect = 1 / (1 + onp.exp(-X))
    onp.testing.assert_allclose(got[0], expect, rtol=1e-6)
    onp.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    if record:
        onp.testing.assert_allclose(got[1], 2 * expect * expect *
                                    (1 - expect), rtol=1e-5)
        onp.testing.assert_allclose(got[1], ref[1], rtol=1e-6)


def test_is_train_follows_recording_as_in_the_reference():
    for k, mx in (("j", jmx), ("t", tmx)):
        CALLS[k].clear()
        _sigmoid(mx, X, False)
        _sigmoid(mx, X, True)
    assert CALLS["t"] == CALLS["j"] == [("forward", False),
                                        ("forward", True), ("backward",)]


def test_custom_op_registry():
    assert "torch_test_sigmoid" in \
        tmx.operator.get_all_registered_operators()
    with pytest.raises(tmx.MXNetError):
        tmx.nd.Custom(tmx.nd.ones((2,), ctx=CPU), op_type="not_registered")
    with pytest.raises(tmx.MXNetError):
        tmx.nd.Custom(tmx.nd.ones((2,), ctx=CPU))
    with pytest.raises(tmx.MXNetError):
        tmx.operator.register("bad")(object)
    assert tmx.nd.Custom is not None and tmx.operator.custom is not None


def test_two_outputs_kwargs_and_gradients():
    a = tmx.nd.array([1.0, 2.0], ctx=CPU)
    b = tmx.nd.array([0.5, -1.0], ctx=CPU)
    a.attach_grad()
    b.attach_grad()
    with tmx.autograd.record():
        s, d = tmx.nd.Custom(a, b, op_type="torch_test_scale", factor=3)
        loss = (s * 2 + d).sum()
    loss.backward()
    onp.testing.assert_allclose(s.asnumpy(), [3.5, 5.0])
    onp.testing.assert_allclose(d.asnumpy(), [0.5, 3.0])
    onp.testing.assert_allclose(a.grad.asnumpy(), [7.0, 7.0])
    onp.testing.assert_allclose(b.grad.asnumpy(), [1.0, 1.0])


def test_assign_honours_the_request():
    op = tmx.operator.CustomOp()
    dst = tmx.nd.array([1.0, 2.0], ctx=CPU)
    op.assign(dst, "add", onp.array([1.0, 1.0]))
    onp.testing.assert_allclose(dst.asnumpy(), [2.0, 3.0])
    op.assign(dst, "null", onp.array([9.0, 9.0]))
    onp.testing.assert_allclose(dst.asnumpy(), [2.0, 3.0])
    op.assign(dst, "write", tmx.nd.array([5.0, 6.0], ctx=CPU))
    onp.testing.assert_allclose(dst.asnumpy(), [5.0, 6.0])
    assert str(dst.dtype) == "torch.float32"


class _Block:
    """A hybridized block whose forward reaches ``Custom``."""

    @staticmethod
    def make(mx):
        class Net(mx.gluon.HybridBlock):
            def hybrid_forward(self, F, x):
                return F.Custom(x * 2, op_type="torch_test_sigmoid") + 1

        return Net()


def test_hybridized_custom_runs_eagerly_on_every_call():
    """Trap 3: two calls on different inputs; the second output follows
    its own input (a replay would return the first call's)."""
    x1 = onp.array([0.0, 1.0], onp.float32)
    x2 = onp.array([-2.0, 3.0], onp.float32)
    outs = {}
    for mx in (jmx, tmx):
        kw = {"ctx": CPU} if mx is tmx else {}
        net = _Block.make(mx)
        net.hybridize()
        outs[mx] = [net(mx.nd.array(x, **kw)).asnumpy() for x in (x1, x2)]
    for x, g, r in zip((x1, x2), outs[tmx], outs[jmx]):
        onp.testing.assert_allclose(g, 1 / (1 + onp.exp(-2 * x)) + 1,
                                    rtol=1e-6)
        onp.testing.assert_allclose(g, r, rtol=1e-6)
    net = _Block.make(tmx)
    net.hybridize()
    for x in (x1, x2, x1):
        net(tmx.nd.array(x, ctx=CPU))
    assert net.cache_stats() == {"hits": 0, "misses": 1, "signatures": 1,
                                 "recorded": 0, "eager": 3}


def test_hybridized_custom_records_its_gradient():
    x = onp.array([0.5, -1.0], onp.float32)
    grads = []
    for mx in (jmx, tmx):
        kw = {"ctx": CPU} if mx is tmx else {}
        net = _Block.make(mx)
        net.hybridize()
        a = mx.nd.array(x, **kw)
        a.attach_grad()
        with mx.autograd.record():
            y = net(a)
        y.backward()
        grads.append(a.grad.asnumpy())
    s = 1 / (1 + onp.exp(-2 * x))
    onp.testing.assert_allclose(grads[1], 2 * s * (1 - s), rtol=1e-5)
    onp.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)


def test_custom_in_np_mode():
    tmx.npx.set_np()
    try:
        y = tmx.nd.Custom(tmx.np.array(X, ctx=CPU),
                          op_type="torch_test_sigmoid")
        onp.testing.assert_allclose(y.asnumpy(), 1 / (1 + onp.exp(-X)),
                                    rtol=1e-6)
    finally:
        tmx.npx.reset_np()


def test_pallas_kernel_wraps_a_callable_with_its_gradient():
    def fn(a, b):
        return a * b + 1.0

    x = onp.array([1.0, -2.0, 3.0], onp.float32)
    w = onp.array([0.5, 0.25, -1.0], onp.float32)
    res = []
    for mx in (jmx, tmx):
        kw = {"ctx": CPU} if mx is tmx else {}
        k = mx.rtc.PallasKernel(fn, name="muladd")
        a, b = mx.nd.array(x, **kw), mx.nd.array(w, **kw)
        a.attach_grad()
        with mx.autograd.record():
            y = k(a, b)
            loss = (y * y).sum()
        loss.backward()
        res.append((y.asnumpy(), a.grad.asnumpy(),
                    k.launch(a, b).asnumpy()))
    for g, r in zip(res[1], res[0]):
        onp.testing.assert_allclose(g, r, rtol=1e-6)
    onp.testing.assert_allclose(res[1][1], 2 * (x * w + 1) * w, rtol=1e-6)
    k = tmx.rtc.PallasKernel(lambda a, scale: a * scale)
    onp.testing.assert_allclose(
        k.launch(tmx.nd.array(x, ctx=CPU), scale=3.0).asnumpy(), 3 * x)
    assert k._name == "<lambda>"


def test_cuda_module_is_not_carried_over():
    with pytest.raises(tmx.MXNetError, match="Not carried over"):
        tmx.rtc.CudaModule("extern \"C\" __global__ void k() {}")

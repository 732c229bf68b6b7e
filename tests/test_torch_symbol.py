"""``mx.sym`` and ``Executor`` of the port against the JAX package: the
same graphs built in both (fresh ``NameManager`` scopes, so the automatic
names agree), their argument lists, shape and type inference, JSON (equal
strings, and each package loading the other's), ``eval``/``simple_bind``
forward and backward on the same values, scalar arithmetic,
``get_internals``, ``Group``, ``BlockGrad``/``MakeLoss`` and the
regression outputs.  f32 on the CPU; values within 1e-5 relative (the
two packages' op orders differ only in f32 rounding)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


def _both(build):
    """``build(mx)`` in each package inside a fresh NameManager scope."""
    out = []
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            out.append(build(mx))
    return out


def _mlp(mx):
    data = mx.sym.var("data")
    h = mx.sym.FullyConnected(data, num_hidden=16)
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=4)
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _conv_bn(mx):
    data = mx.sym.var("data")
    h = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1))
    h = mx.sym.BatchNorm(h, fix_gamma=False)
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max")
    h = mx.sym.Flatten(h)
    h = mx.sym.FullyConnected(h, num_hidden=3)
    return mx.sym.SoftmaxOutput(h, name="softmax")


NETS = {"mlp": (_mlp, {"data": (4, 10)}),
        "conv_bn": (_conv_bn, {"data": (2, 3, 8, 8)})}


def _values(sym, shapes, seed=0):
    """Arguments and auxiliary states of ``sym`` drawn from ``seed``
    (labels as class ids, variances positive)."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n.endswith("label"):
            args[n] = rng.randint(0, 3, s).astype(np.float32)
        else:
            args[n] = rng.randn(*s).astype(np.float32) * 0.5
    aux = {n: (rng.rand(*s) + 0.5 if n.endswith("var") else
               rng.randn(*s) * 0.1).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


@pytest.mark.parametrize("net", sorted(NETS))
def test_lists_and_inference_equal_the_reference(net):
    build, shapes = NETS[net]
    j, t = _both(build)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_inputs() == j.list_inputs()
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
    assert t.infer_shape_partial() == j.infer_shape_partial()
    assert t.infer_type(data="float32") == j.infer_type(data="float32")
    assert t.infer_type() == j.infer_type()


@pytest.mark.parametrize("net", sorted(NETS))
def test_tojson_equals_the_reference_and_loads_across(net):
    build, shapes = NETS[net]
    j, t = _both(build)
    assert t.tojson() == j.tojson()
    # a graph written by either package loads in the other
    from_ref = tmx.sym.load_json(j.tojson())
    from_port = jmx.sym.load_json(t.tojson())
    assert from_ref.tojson() == j.tojson()
    assert from_port.tojson() == t.tojson()
    assert from_ref.infer_shape(**shapes) == j.infer_shape(**shapes)


@pytest.mark.parametrize("net", sorted(NETS))
def test_simple_bind_forward_backward_equal_the_reference(net):
    build, shapes = NETS[net]
    j, t = _both(build)
    args, aux = _values(j, shapes)
    res = []
    for mx, sym, kw in ((jmx, j, {}), (tmx, t, {"ctx": CPU})):
        exe = sym.simple_bind(grad_req="write", **kw, **shapes)
        exe.copy_params_from({k: mx.nd.array(v, **kw)
                              for k, v in args.items()},
                             {k: mx.nd.array(v, **kw)
                              for k, v in aux.items()})
        infer = exe.forward(is_train=False)[0].asnumpy()
        train = exe.forward(is_train=True)[0].asnumpy()
        exe.backward()
        grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()
                 if g is not None and n not in ("data", "softmax_label")}
        stats = {n: a.asnumpy() for n, a in exe.aux_dict.items()}
        res.append((infer, train, grads, stats))
    (ji, jt, jg, js), (ti, tt, tg, ts) = res
    np.testing.assert_allclose(ti, ji, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tt, jt, rtol=RTOL, atol=ATOL)
    assert sorted(tg) == sorted(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    # a training BatchNorm commits its moving statistics, as the reference
    assert sorted(ts) == sorted(js)
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_bind_and_eval_equal_the_reference():
    def build(mx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        return mx.sym.broadcast_add(a * b, mx.sym.exp(a) / 2.0)

    j, t = _both(build)
    rng = np.random.RandomState(3)
    a = rng.rand(3, 4).astype(np.float32)
    b = rng.rand(3, 4).astype(np.float32)
    ref = j.eval(a=jmx.nd.array(a), b=jmx.nd.array(b))[0].asnumpy()
    got = t.eval(ctx=CPU, a=tmx.nd.array(a, ctx=CPU),
                 b=tmx.nd.array(b, ctx=CPU))[0].asnumpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    grads = []
    for mx, s, kw in ((jmx, j, {}), (tmx, t, {"ctx": CPU})):
        ga, gb = mx.nd.zeros((3, 4), **kw), mx.nd.zeros((3, 4), **kw)
        exe = s.bind(args={"a": mx.nd.array(a, **kw),
                           "b": mx.nd.array(b, **kw)},
                     args_grad={"a": ga, "b": gb}, **kw)
        exe.forward(is_train=True)
        exe.backward(mx.nd.ones((3, 4), **kw))
        grads.append((exe.grad_dict["a"].asnumpy(),
                      exe.grad_dict["b"].asnumpy()))
    for g, r in zip(grads[1], grads[0]):
        np.testing.assert_allclose(g, r, rtol=RTOL)


def test_scalar_arithmetic_internals_group_and_children():
    def build(mx):
        x = mx.sym.var("x")
        y = (2.0 - x) * 3.0 + x / 4.0 - 1.0
        z = 1.0 / (x + 1.0) + (-x) ** 2.0
        return mx.sym.Group([y, z, x == 1.0, x != 2.0])

    j, t = _both(build)
    assert t.tojson() == j.tojson()
    assert t.list_outputs() == j.list_outputs()
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert t[1].get_children().list_outputs() == \
        j[1].get_children().list_outputs()
    x = np.array([[0.5, 1.0, 2.0]], np.float32)
    ref = [o.asnumpy() for o in j.eval(x=jmx.nd.array(x))]
    got = [o.asnumpy() for o in t.eval(ctx=CPU, x=tmx.nd.array(x, ctx=CPU))]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=RTOL)
    internals = t.get_internals()
    name = internals.list_outputs()[2]
    assert internals[name].list_outputs() == [name]


@pytest.mark.parametrize("head", ["BlockGrad", "MakeLoss",
                                  "LinearRegressionOutput",
                                  "LogisticRegressionOutput",
                                  "MAERegressionOutput"])
def test_loss_heads_forward_and_gradients_equal_the_reference(head):
    def build(mx):
        data = mx.sym.var("data")
        fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
        if head == "BlockGrad":
            return mx.sym.Group([mx.sym.MakeLoss(mx.sym.sum(fc * fc)),
                                 mx.sym.BlockGrad(fc)])
        if head == "MakeLoss":
            return mx.sym.MakeLoss(mx.sym.sum(mx.sym.square(fc)),
                                   grad_scale=0.5)
        return getattr(mx.sym, head)(fc, name="reg")

    j, t = _both(build)
    assert t.list_arguments() == j.list_arguments()
    shapes = {"data": (4, 5)}
    args, _ = _values(j, shapes, seed=5)
    if "reg_label" in args:
        args["reg_label"] = np.random.RandomState(6).rand(4, 3) \
            .astype(np.float32)
    res = []
    for mx, s, kw in ((jmx, j, {}), (tmx, t, {"ctx": CPU})):
        exe = s.simple_bind(grad_req="write", **kw, **shapes)
        exe.copy_params_from({k: mx.nd.array(v, **kw)
                              for k, v in args.items()})
        outs = [o.asnumpy() for o in exe.forward(is_train=True)]
        exe.backward()
        res.append((outs, exe.grad_dict["fc_weight"].asnumpy()))
    for g, r in zip(res[1][0], res[0][0]):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-4, atol=1e-6)


def test_executor_reshape_monitor_and_fluent_methods():
    got = {}
    with tmx.name.NameManager():
        s = _mlp(tmx)
    exe = s.simple_bind(CPU, data=(4, 10))
    exe.set_monitor_callback(lambda n, a: got.setdefault(n, a.shape))
    exe.forward(data=np.ones((4, 10), np.float32))
    assert got["fullyconnected0_output"] == (4, 16)
    exe2 = exe.reshape(data=(2, 10), softmax_label=(2,))
    assert exe2.forward()[0].shape == (2, 4)
    assert exe2.arg_dict["fullyconnected0_weight"] is not \
        exe.arg_dict["fullyconnected0_weight"]
    x = tmx.sym.var("x")
    r = x.reshape(shape=(2, 3)).sum(axis=1)
    out = r.eval(ctx=CPU, x=tmx.nd.array(np.arange(6.0), ctx=CPU))[0]
    np.testing.assert_array_equal(out.asnumpy(), [3.0, 12.0])
    with pytest.raises(tmx.MXNetError, match="cannot infer"):
        s.infer_shape()

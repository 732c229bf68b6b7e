"""int8 inference of the PyTorch/CUDA port against the JAX package: the
quantized ops of ``ops/quantization.py``, the KL threshold search,
``contrib.quantization.quantize_net`` and ``InferenceServer`` with
``ServerConfig(int8=True, calib_data=)``; and the hooks of a 1×1 conv
that ``HybridSequential`` would otherwise fuse with its BatchNorm and
ReLU.

The same seeded numpy inputs go through both packages.  Quantized
outputs are held as integers (``assert_array_equal``) and their ranges
equal; float outputs of the ops (``dequantize``, the uint8 path's
ranges) within f32 rounding: 1e-6 of the largest value (XLA may fuse
the uint8 path's ``q / s + min`` into one rounding, torch rounds twice).  A quantized net's output is
a float chain of int8 layers: each int32 product is exact in both, but
the float steps between (dequantize, BatchNorm, ReLU) may round a value
1 ulp apart, which moves it across a rounding edge of the next
quantization now and then; so nets are held within 2e-3 of their largest
output, while a wrong scale or a dropped layer moves them by 1e-1 and
more.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.ops import conv_bn_relu as cbr

CPU = tmx.cpu()
F32_TOL = 1e-6
NET_TOL = 2e-3


def _nd(pkg, a, dtype=None):
    kw = dict(ctx=CPU) if pkg is tmx else {}
    return pkg.nd.array(a, dtype=dtype, **kw) if dtype else \
        pkg.nd.array(a, **kw)


def _both(fn):
    """``fn(pkg)`` in each package → (reference, port), each a tuple of
    numpy arrays."""
    out = []
    for pkg in (jmx, tmx):
        res = fn(pkg)
        res = res if isinstance(res, (tuple, list)) else (res,)
        out.append(tuple(r.asnumpy() for r in res))
    return out


def _same(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype, (r.dtype, g.dtype)
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(
                g, r, rtol=F32_TOL, atol=F32_TOL * np.abs(r).max())


RS = np.random.RandomState(0)
X = RS.normal(0, 1.5, (4, 12)).astype(np.float32)


@pytest.mark.parametrize("out_type", ["uint8", "int8"])
def test_quantize_and_dequantize(out_type):
    def f(pkg):
        q = pkg.nd.quantize(_nd(pkg, X), _nd(pkg, [-2.5]), _nd(pkg, [3.0]),
                            out_type=out_type)
        return q + (pkg.nd.dequantize(*q),)

    _same(*_both(f))


@pytest.mark.parametrize("out_type,calib", [
    ("int8", None), ("int8", (-1.0, 2.0)), ("uint8", None),
    ("uint8", (-3.0, 1.0))])
def test_quantize_v2(out_type, calib):
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])

    def f(pkg):
        q = pkg.nd.quantize_v2(_nd(pkg, X), out_type=out_type, **kw)
        return q + (pkg.nd.dequantize(*q),)

    _same(*_both(f))


@pytest.mark.parametrize("calib", [None, (-0.5, 0.8)])
def test_requantize_and_int32_dequantize(calib):
    acc = RS.randint(-2 ** 30, 2 ** 30, (3, 7)).astype(np.int32)
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])

    def f(pkg):
        a = _nd(pkg, acc, "int32")
        mn, mx = _nd(pkg, [-4.0]), _nd(pkg, [4.0])
        return pkg.nd.requantize(a, mn, mx, **kw) + (
            pkg.nd.dequantize(a, mn, mx),)

    _same(*_both(f))


def _fc_inputs(pkg, data_type, k, bias):
    rs = np.random.RandomState(k)
    x = rs.normal(0, 1, (5, 3, k // 3)).astype(np.float32)
    w = rs.normal(0, 0.2, (6, k)).astype(np.float32)
    qd = pkg.nd.quantize_v2(_nd(pkg, x), out_type=data_type)
    qw = pkg.nd.quantize_v2(_nd(pkg, w), out_type="int8")
    args = [qd[0], qw[0]]
    if bias:
        args.append(_nd(pkg, rs.randint(-50, 50, (6,)), "int8"))
    return args + [qd[1], qd[2], qw[1], qw[2]]


@pytest.mark.parametrize("data_type,k,bias", [
    ("int8", 24, False), ("int8", 21, True), ("uint8", 24, False),
    ("uint8", 15, True)], ids=["int8", "int8_k21_bias", "uint8",
                               "uint8_k15_bias"])
def test_quantized_fully_connected(data_type, k, bias):
    """K = 21 and 15 are not multiples of 8 (the product pads them); the
    uint8 path's row of largest |value| sets its range and meets the top
    of int32, where XLA saturates and torch's plain cast would wrap."""
    def f(pkg):
        out = pkg.nd.quantized_fully_connected(
            *_fc_inputs(pkg, data_type, k, bias), num_hidden=6,
            no_bias=not bias)
        return out + (pkg.nd.dequantize(*out),)

    ref, got = _both(f)
    _same(ref, got)
    if data_type == "uint8":
        assert np.abs(got[0].astype(np.int64)).max() >= 2 ** 31 - 1


def test_quantized_fully_connected_keeps_leading_axes():
    x = RS.normal(0, 1, (2, 3, 16)).astype(np.float32)
    w = RS.normal(0, 0.3, (8, 16)).astype(np.float32)

    def f(pkg):
        qd = pkg.nd.quantize_v2(_nd(pkg, x))
        qw = pkg.nd.quantize_v2(_nd(pkg, w))
        return pkg.nd.quantized_fully_connected(
            qd[0], qw[0], qd[1], qd[2], qw[1], qw[2], no_bias=True,
            num_hidden=8, flatten=False)

    ref, got = _both(f)
    assert got[0].shape == (2, 3, 8)
    _same(ref, got)


CONVS = [  # (name, x shape, w shape, stride, pad, dilate, bias)
    ("k3_s1_p1", (2, 8, 9, 9), (16, 8, 3, 3), 1, 1, 1, False),
    ("k3_s2_p1_d2", (2, 4, 11, 10), (8, 4, 3, 3), (2, 1), (1, 2), 2, True),
    ("stem_k7_c3", (1, 3, 20, 20), (8, 3, 7, 7), 2, 3, 1, False),  # K=147
    ("k1_s2", (3, 16, 7, 7), (24, 16, 1, 1), 2, 0, 1, True),
    ("k1_m_small", (1, 8, 3, 3), (5, 8, 1, 1), 1, 0, 1, False),  # M=9
]


@pytest.mark.parametrize("name,xs,ws,stride,pad,dilate,bias", CONVS,
                         ids=[c[0] for c in CONVS])
def test_quantized_conv(name, xs, ws, stride, pad, dilate, bias):
    rs = np.random.RandomState(len(name))
    x = rs.normal(0, 1, xs).astype(np.float32)
    w = rs.normal(0, 0.3, ws).astype(np.float32)
    b = rs.randint(-100, 100, (ws[0],))

    def f(pkg):
        qd = pkg.nd.quantize_v2(_nd(pkg, x), out_type="int8")
        qw = pkg.nd.quantize_v2(_nd(pkg, w), out_type="int8")
        args = [qd[0], qw[0]] + ([_nd(pkg, b, "int8")] if bias else []) \
            + [qd[1], qd[2], qw[1], qw[2]]
        out = pkg.nd.quantized_conv(
            *args, kernel=ws[2:], stride=stride, pad=pad, dilate=dilate,
            num_filter=ws[0], no_bias=not bias)
        return out + (pkg.nd.dequantize(*out),)

    _same(*_both(f))


def test_quantized_conv_refuses_uint8_data():
    q = tmx.nd.quantize_v2(_nd(tmx, X.reshape(1, 3, 4, 4)),
                           out_type="uint8")
    qw = tmx.nd.quantize_v2(_nd(tmx, np.ones((2, 3, 1, 1), np.float32)))
    with pytest.raises(tmx.MXNetError, match="requires int8 data"):
        tmx.nd.quantized_conv(q[0], qw[0], q[1], q[2], qw[1], qw[2],
                              kernel=(1, 1), num_filter=2, no_bias=True)


@pytest.mark.parametrize("pool", [
    dict(kernel=(2, 2), pool_type="max", stride=(2, 2)),
    dict(kernel=(3, 3), pool_type="avg", stride=(1, 1), pad=(1, 1)),
    dict(pool_type="avg", global_pool=True, kernel=(1, 1))],
    ids=["max", "avg_pad", "global_avg"])
def test_quantized_pooling_and_flatten(pool):
    x = RS.normal(0, 1, (2, 3, 6, 6)).astype(np.float32)

    def f(pkg):
        q = pkg.nd.quantize_v2(_nd(pkg, x))
        p = pkg.nd.quantized_pooling(*q, **pool)
        return p + pkg.nd.quantized_flatten(*p)

    _same(*_both(f))


@pytest.mark.parametrize("seed,shape", [(0, "normal"), (1, "skewed"),
                                        (2, "spiky")])
def test_optimal_threshold_matches_reference(seed, shape):
    rs = np.random.RandomState(seed)
    a = {"normal": rs.normal(0, 1, 20000),
         "skewed": rs.exponential(1.0, 20000) - 0.2,
         "spiky": np.concatenate([rs.normal(0, 0.1, 20000),
                                  rs.normal(0, 8, 30)])}[shape]
    amax = np.abs(a).max()
    hist, edges = np.histogram(a, bins=8001, range=(-amax, amax))
    assert tq._optimal_threshold(hist, edges) == \
        jq._optimal_threshold(hist, edges)
    p = rs.randint(0, 3, 50).astype(np.float64)
    np.testing.assert_array_equal(tq._smooth(p), jq._smooth(p))


def test_symbol_rewrites_raise_naming_item_8f():
    # the symbol rewrites refused until slice 17, which ported them
    # (tests/test_torch_quantization_symbol.py holds them to the
    # reference); each is now a function of the module, and a bad call
    # raises as the reference's does
    for fn in (tq.quantize_model, tq.quantize_symbol, tq.quantize_params,
               tq._collect_ranges):
        assert fn.__module__ == "mxnet_tpu_torch.contrib.quantization"
    with pytest.raises(tmx.MXNetError, match="bad quantized_dtype"):
        tq.quantize_model(None, {}, {}, quantized_dtype="int4")


# -- nets -----------------------------------------------------------------

def _weights(net, x_shape, seed):
    """Random weights of the port net ``net`` by structural name."""
    net.initialize(ctx=CPU)
    net(tmx.nd.zeros(x_shape, ctx=CPU))
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in net._collect_params_with_prefix().items():
        if name.endswith("weight"):
            fan_in = int(np.prod(p.shape[1:]))
            a = rng.normal(size=p.shape) * np.sqrt(2.0 / fan_in)
        elif name.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, p.shape)
        elif name.endswith("gamma"):
            a = rng.uniform(0.7, 1.3, p.shape)
        else:
            a = rng.normal(0.0, 0.1, p.shape)
        out[name] = a.astype(np.float32)
    return out


def _pair(make, x_shape, seed):
    """The same net in both packages with the same random weights."""
    arrays = _weights(make(tmx), x_shape, seed)
    tnet = make(tmx)
    load_numpy_params(tnet, arrays, ctx=CPU)
    jnet = make(jmx)
    jnet.initialize(init=jmx.init.Zero())
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(arrays[k]))
    return jnet, tnet


def _probe_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 1, in_channels=4), nn.BatchNorm(in_channels=8),
            nn.Activation("relu"))
    return net


def test_hooks_fire_on_a_fusable_conv_and_keep_the_output():
    """A pre-hook and a hook on the 1×1 conv of a fusable run fire, as in
    the reference (the fused op would call neither): the run goes block
    by block, with the fused run's output within f32 rounding."""
    x = RS.normal(0, 1, (2, 4, 5, 5)).astype(np.float32)
    jnet, tnet = _pair(_probe_net, x.shape, 3)
    calls = cbr.conv1x1_bn_relu.calls
    fused = tnet(_nd(tmx, x)).asnumpy()
    assert cbr.conv1x1_bn_relu.calls == calls + 1
    seen = {}
    for pkg, net in ((jmx, jnet), (tmx, tnet)):
        fired = []
        h1 = net[0].register_forward_pre_hook(lambda b, a: fired.append(1))
        h2 = net[0].register_forward_hook(lambda b, a, o: fired.append(2))
        seen[pkg] = (fired, net(_nd(pkg, x)).asnumpy())
        h1.detach()
        h2.detach()
    assert seen[jmx][0] == seen[tmx][0] == [1, 2]
    assert cbr.conv1x1_bn_relu.calls == calls + 1  # the hooked run unfused
    np.testing.assert_allclose(seen[tmx][1], fused, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(seen[tmx][1], seen[jmx][1], rtol=1e-5,
                               atol=1e-6)
    # a hook on the BatchNorm or the ReLU unfuses the run as well
    h = tnet[2].register_forward_hook(lambda b, a, o: None)
    tnet(_nd(tmx, x))
    h.detach()
    assert cbr.conv1x1_bn_relu.calls == calls + 1
    tnet(_nd(tmx, x))
    assert cbr.conv1x1_bn_relu.calls == calls + 2


def _quantized(pair, calib, x):
    """Both nets quantized on ``calib`` (naive), then run on ``x``."""
    jnet, tnet = pair
    jnet.hybridize()  # calibration runs eagerly, the check as one jit
    jq.quantize_net(jnet, calib_data=[jmx.nd.array(c) for c in calib],
                    calib_mode="naive")
    tq.quantize_net(tnet, calib_data=[_nd(tmx, c) for c in calib],
                    calib_mode="naive")
    return jnet(jmx.nd.array(x)).asnumpy(), tnet(_nd(tmx, x)).asnumpy()


def _hold(ref, got):
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=NET_TOL * np.abs(ref).max())


def test_quantize_net_on_the_hooked_probe_runs_the_int8_chain():
    x = RS.normal(0, 1, (2, 4, 5, 5)).astype(np.float32)
    pair = _pair(_probe_net, x.shape, 4)
    f32 = pair[1](_nd(tmx, x)).asnumpy()
    calls = cbr.conv1x1_bn_relu.calls
    ref, got = _quantized(pair, [x], x)
    assert cbr.conv1x1_bn_relu.calls == calls  # the rewritten conv unfused
    assert "hybrid_forward" in pair[1][0].__dict__
    _hold(ref, got)
    assert 0 < np.abs(got - f32).max() < 0.05 * np.abs(f32).max()


def test_quantize_net_on_mobilenet_quantizes_every_pointwise_conv():
    """mobilenet0.25 at 32×32, B=2: the stem's padded strided conv, the
    13 pointwise convs the fusion would take and the Dense get int8
    chains, the 13 depthwise (grouped) convs stay f32, no layer lacks a
    range."""
    def make(pkg):
        vision = jvision if pkg is jmx else tvision
        return vision.get_model("mobilenet0.25", classes=10)

    shape = (2, 3, 32, 32)
    rs = np.random.RandomState(5)
    calib = [rs.uniform(-1, 1, shape).astype(np.float32)]
    x = rs.uniform(-1, 1, shape).astype(np.float32)
    pair = _pair(make, shape, 6)
    calls = cbr.conv1x1_bn_relu.calls
    ref, got = _quantized(pair, calib, x)
    assert cbr.conv1x1_bn_relu.calls == calls
    convs = [b for b in _blocks(pair[1])
             if isinstance(b, tmx.gluon.nn.Conv2D)]
    rewritten = ["hybrid_forward" in b.__dict__ for b in convs]
    pointwise = [b._kernel == (1, 1) for b in convs]
    assert sum(pointwise) == 13 and len(convs) == 27
    assert rewritten == [b._groups == 1 for b in convs]
    assert all(r for r, p in zip(rewritten, pointwise) if p)
    dense = [b for b in _blocks(pair[1]) if isinstance(b, tmx.gluon.nn.Dense)]
    assert len(dense) == 1 and "hybrid_forward" in dense[0].__dict__
    _hold(ref, got)


def _blocks(net):
    out = []
    net.apply(out.append)
    return out


def _dense(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, flatten=False, activation="relu"),
            pkg.gluon.nn.Dense(5, flatten=False))
    return net


def test_int8_inference_server_matches_the_reference_server():
    import threading

    rs = np.random.RandomState(7)
    jnet, tnet = _pair(_dense, (1, 8, 6), 8)
    calib = [rs.normal(0, 1, (4, 8, 6)).astype(np.float32)]
    inputs = [rs.normal(0, 1, (n, 6)).astype(np.float32)
              for n in (3, 8, 5, 2, 7)]

    def serve(server, config, net, calib_arrays):
        cfg = config.ServerConfig(
            max_batch=4, max_length=8, min_batch=2, min_length=8,
            output_length_axis=0, batch_window_ms=10.0, int8=True,
            calib_data=calib_arrays)
        srv = server(net, cfg)
        out = [None] * len(inputs)

        def client(i):
            out[i] = srv.infer(inputs[i], timeout=60.0)

        with srv:
            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(len(inputs))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60.0)
        return srv, out

    jnet.hybridize()
    tnet.hybridize()
    _, ref = serve(jserving.InferenceServer, jserving, jnet,
                   [jmx.nd.array(c) for c in calib])
    srv, got = serve(tserving.InferenceServer, tserving, tnet,
                     [_nd(tmx, c) for c in calib])
    assert srv.model is tnet and all(
        "hybrid_forward" in b.__dict__ for b in tnet)
    for x, g, r in zip(inputs, got, ref):
        assert g.shape == r.shape == (len(x), 5)
        _hold(r, g)

"""The symbol quantizer of the port (``contrib.quantization.
quantize_model``, ``_collect_ranges``, ``quantize_symbol``,
``quantize_params``) against the JAX package, on a small conv symbol:
the calibrated ranges (naive min/max and the entropy search), the
rewritten graph's JSON, the parameters it keeps, its int8 weights (the
``quantize_v2`` outputs, read by a monitor callback) equal to the
reference's, and its outputs within 1e-5 of the reference's largest
output (the int8 products are exact integers in both; the float sides
round ``q / s + min`` differently, as ``test_torch_quantization.py``
holds them)."""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()


def _sym(mx):
    with mx.name.NameManager():
        data = mx.sym.var("data")
        h = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8,
                               pad=(1, 1), name="conv1")
        h = mx.sym.Activation(h, act_type="relu", name="relu1")
        h = mx.sym.Convolution(h, kernel=(1, 1), num_filter=4, name="conv2")
        h = mx.sym.Flatten(h, name="flat")
        return mx.sym.FullyConnected(h, num_hidden=3, name="fc")


def _arrays():
    sym = _sym(jmx)
    arg_shapes, _, _ = sym.infer_shape(data=(2, 3, 6, 6))
    rng = np.random.RandomState(0)
    arg = {n: (rng.randn(*s) * 0.4).astype(np.float32)
           for n, s in zip(sym.list_arguments(), arg_shapes) if n != "data"}
    calib = [rng.randn(2, 3, 6, 6).astype(np.float32) for _ in range(3)]
    x = rng.randn(2, 3, 6, 6).astype(np.float32)
    return arg, calib, x


def _quantize(mx, mode, kw):
    arg, calib, x = _arrays()
    params = {k: mx.nd.array(v, **kw) for k, v in arg.items()}
    batches = [mx.nd.array(c, **kw) for c in calib]
    ranges = mx.contrib.quantization._collect_ranges(
        _sym(mx), params, {}, batches, ["data"], None, mode, **kw)
    qsym, qarg, qaux = mx.contrib.quantization.quantize_model(
        _sym(mx), params, {}, calib_mode=mode, calib_data=batches,
        excluded_sym_names=["fc"], **kw)
    seen = {}
    exe = qsym.simple_bind(data=x.shape, grad_req="null", **kw)
    exe.copy_params_from(qarg, qaux)
    exe.set_monitor_callback(
        lambda n, a: seen.__setitem__(n, a.asnumpy())
        if "weight_quantize" in n else None)
    out = exe.forward(data=mx.nd.array(x, **kw))[0].asnumpy()
    return ranges, qsym, qarg, seen, out


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_quantize_model_equals_the_reference(mode):
    jr, jq, jarg, jseen, jout = _quantize(jmx, mode, {})
    tr, tq, targ, tseen, tout = _quantize(tmx, mode, {"ctx": CPU})
    assert sorted(tr) == sorted(jr)
    for name in jr:
        np.testing.assert_allclose(tr[name], jr[name], rtol=1e-6,
                                   err_msg=name)
    assert tq.tojson() == jq.tojson()
    nodes = [n["name"] for n in json.loads(tq.tojson())["nodes"]]
    assert "quantized_conv1" in nodes and "quantized_conv2" in nodes
    assert "quantized_fc" not in nodes  # excluded
    assert sorted(targ) == sorted(jarg)
    for k in jarg:
        np.testing.assert_array_equal(targ[k].asnumpy(), jarg[k].asnumpy())
    # the int8 weights and their ranges
    assert sorted(tseen) == sorted(jseen) and tseen
    for k in jseen:
        if jseen[k].dtype == np.int8:
            np.testing.assert_array_equal(tseen[k], jseen[k], err_msg=k)
        else:
            np.testing.assert_allclose(tseen[k], jseen[k], rtol=1e-6,
                                       err_msg=k)
    np.testing.assert_allclose(tout, jout, rtol=0,
                               atol=1e-5 * np.abs(jout).max())


def test_quantize_symbol_keeps_excluded_and_grouped_layers():
    with tmx.name.NameManager():
        data = tmx.sym.var("data")
        h = tmx.sym.Convolution(data, kernel=(3, 3), num_filter=4,
                                num_group=2, name="grouped")
        h = tmx.sym.BatchNorm(h, name="bn")
        h = tmx.sym.Convolution(h, kernel=(1, 1), num_filter=4, name="plain")
    # a BatchNorm node (one visible output of three) is rebuilt whole:
    # the reference's rewrite fails on it (IndexError)
    with jmx.name.NameManager():
        jd = jmx.sym.var("data")
        jh = jmx.sym.BatchNorm(jmx.sym.Convolution(
            jd, kernel=(1, 1), num_filter=4, name="c"), name="bn")
    with pytest.raises(IndexError):
        jmx.contrib.quantization.quantize_symbol(jh, ())
    q = tmx.contrib.quantization.quantize_symbol(h, ())
    ops = {n["name"]: n["op"] for n in json.loads(q.tojson())["nodes"]}
    assert ops["grouped"] == "Convolution"  # int8 covers plain 2-D convs
    assert ops["quantized_plain"] == "quantized_conv"
    assert ops["bn"] == "BatchNorm"
    assert q.list_auxiliary_states() == h.list_auxiliary_states()
    with pytest.raises(tmx.MXNetError, match="calib_data"):
        tmx.contrib.quantization.quantize_model(h, {}, {},
                                                calib_mode="naive")

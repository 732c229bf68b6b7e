"""``contrib.onnx`` of the port against the JAX package: ``export_model``
of an MLP, a conv net and ``bert_tiny`` (through ``bert_to_symbol``)
writes the reference's bytes (the same graph and the same weights; both
packages carry the same protobuf codec), ``import_model`` round-trips to
equal outputs, and an op with no translation raises.  f32 on the CPU;
outputs within 1e-5 relative (1e-4 absolute for BERT, as
``test_torch_bert.py``)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.contrib.onnx  # noqa: F401  (a subpackage in the reference)
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import bert as jbert
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models import bert as tbert

CPU = tmx.cpu()


def _mlp(mx):
    with mx.name.NameManager():
        data = mx.sym.var("data")
        h = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
        h = mx.sym.Activation(h, act_type="relu", name="relu1")
        h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
        return mx.sym.softmax(h, name="prob")


def _conv(mx):
    with mx.name.NameManager():
        data = mx.sym.var("data")
        h = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4,
                               pad=(1, 1), name="conv")
        h = mx.sym.BatchNorm(h, fix_gamma=False, name="bn")
        h = mx.sym.Activation(h, act_type="relu", name="relu")
        h = mx.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="avg",
                           name="pool")
        h = mx.sym.Flatten(h, name="flat")
        return mx.sym.FullyConnected(h, num_hidden=3, name="fc")


NETS = {"mlp": (_mlp, (2, 5)), "conv": (_conv, (2, 3, 6, 6))}


def _params(sym, shape, seed):
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    rng = np.random.RandomState(seed)
    arg = {n: (rng.randn(*s) * 0.5).astype(np.float32)
           for n, s in zip(sym.list_arguments(), arg_shapes) if n != "data"}
    aux = {n: (rng.rand(*s) + 0.5).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return arg, aux


def _run(mx, sym, arg, aux, x, kw):
    exe = sym.simple_bind(data=x.shape, grad_req="null", **kw)
    exe.copy_params_from({k: mx.nd.array(v, **kw) for k, v in arg.items()},
                         {k: mx.nd.array(v, **kw) for k, v in aux.items()})
    return exe.forward(data=mx.nd.array(x, **kw))[0].asnumpy()


@pytest.mark.parametrize("net", sorted(NETS))
def test_export_bytes_equal_the_reference_and_import_round_trips(
        net, tmp_path):
    build, shape = NETS[net]
    jsym, tsym = build(jmx), build(tmx)
    arg, aux = _params(jsym, shape, 1)
    params = {**arg, **aux}
    jpath = jmx.contrib.onnx.export_model(
        jsym, {k: jmx.nd.array(v) for k, v in params.items()}, [shape],
        onnx_file_path=str(tmp_path / "ref.onnx"))
    tpath = tmx.contrib.onnx.export_model(
        tsym, {k: tmx.nd.array(v, ctx=CPU) for k, v in params.items()},
        [shape], onnx_file_path=str(tmp_path / "port.onnx"))
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    want = _run(tmx, tsym, arg, aux, x, {"ctx": CPU})
    np.testing.assert_allclose(want, _run(jmx, jsym, arg, aux, x, {}),
                               rtol=1e-5, atol=1e-6)
    with tmx.cpu():
        isym, iarg, iaux = tmx.contrib.onnx.import_model(tpath)
    got = _run(tmx, isym, {k: v.asnumpy() for k, v in iarg.items()},
               {k: v.asnumpy() for k, v in iaux.items()}, x, {"ctx": CPU})
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jisym, _, jiaux = jmx.contrib.onnx.import_model(tpath)
    assert isym.list_inputs() == jisym.list_inputs()
    assert sorted(iaux) == sorted(jiaux) == sorted(aux)
    # the port's graph reads its BatchNorm statistics as auxiliary states;
    # the reference's lists them as arguments, so binding its aux_params
    # leaves them unread
    assert isym.list_auxiliary_states() == sorted(aux)
    assert jisym.list_auxiliary_states() == []


def test_bert_to_symbol_onnx_bytes_and_round_trip(tmp_path):
    b, t, v = 2, 8, 50
    ids = np.random.RandomState(3).randint(0, v, (b, t)).astype(np.int32)
    tt = np.zeros((b, t), np.int32)
    jnet = jbert.bert_tiny(vocab_size=v, prefix="bert_")
    jnet.initialize(jmx.init.Xavier())
    live = jnet(jmx.nd.array(ids, dtype="int32"),
                jmx.nd.array(tt, dtype="int32"))
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    tnet = tbert.bert_tiny(vocab_size=v, prefix="bert_")
    load_numpy_params(tnet, arrays, ctx=CPU)
    # the scalar nodes take automatic names: fresh NameManager scopes
    # give both packages the same ones
    with jmx.name.NameManager(), tmx.name.NameManager():
        jsym, jparams = jbert.bert_to_symbol(jnet, b, t)
        tsym, tparams = tbert.bert_to_symbol(tnet, b, t)
    assert tsym.tojson() == jsym.tojson()
    assert sorted(tparams) == sorted(jparams)
    with jmx.name.NameManager(), tmx.name.NameManager():
        jpath = jbert.export_bert_onnx(jnet, str(tmp_path / "ref.onnx"), b,
                                       t)
        tpath = tbert.export_bert_onnx(tnet, str(tmp_path / "port.onnx"),
                                       b, t)
    with open(jpath, "rb") as fa, open(tpath, "rb") as fb:
        assert fa.read() == fb.read()
    # bert_to_symbol's Executor against the live block's outputs
    inputs = {"data0": tmx.nd.array(ids, ctx=CPU, dtype="int32"),
              "data1": tmx.nd.array(tt, ctx=CPU, dtype="int32")}
    exe = tsym.bind(CPU, args={**tparams, **inputs}, grad_req="null")
    outs = exe.forward()
    for o, r in zip(outs, live):
        np.testing.assert_allclose(o.asnumpy(), r.asnumpy(), atol=1e-4)
    # the ONNX file back through import_model, bound and run
    with tmx.cpu():
        isym, iarg, iaux = tmx.contrib.onnx.import_model(tpath)
    iexe = isym.bind(CPU, args={**iarg, **inputs}, aux_states=iaux,
                     grad_req="null")
    iouts = iexe.forward()
    for o, r in zip(iouts, outs):
        np.testing.assert_allclose(o.asnumpy(), r.asnumpy(), atol=1e-4)


def test_unknown_ops_raise(tmp_path):
    with tmx.name.NameManager():
        s = tmx.sym.topk(tmx.sym.var("data"), k=2, name="top")
    with pytest.raises(tmx.MXNetError, match="ONNX"):
        tmx.contrib.onnx.export_model(s, {}, [(2, 5)],
                                      onnx_file_path=str(tmp_path / "a"))
    # an ONNX node with no translation: rename the exported Relu
    path = tmx.contrib.onnx.export_model(
        _mlp(tmx), {k: tmx.nd.array(v, ctx=CPU) for k, v in
                    _params(_mlp(tmx), (2, 5), 4)[0].items()},
        [(2, 5)], onnx_file_path=str(tmp_path / "m.onnx"))
    blob = open(path, "rb").read()
    assert blob.count(b"Relu") == 1
    bad = tmp_path / "bad.onnx"
    bad.write_bytes(blob.replace(b"Relu", b"Reku"))
    with pytest.raises(tmx.MXNetError, match="no translation"):
        tmx.contrib.onnx.import_model(str(bad))

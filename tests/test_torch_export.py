"""``HybridBlock.export``, ``SymbolBlock.imports``, ``Predictor`` and
``InferenceServer(Predictor)`` of the port against the JAX package, on
the CPU.

A small conv + BatchNorm + ReLU net (its 1x1 conv → BN → ReLU run is the
fused kernel #4's plain version) and ``bert_tiny`` (its unmasked
attention is the flash forward #1's plain version) are built in both
packages with the same weights (numpy arrays by structural name,
``convert.load_numpy_params``) and explicit prefixes, so their parameter
names agree.  The port's export is a ``torch.export`` program that holds
the two kernels as ``mxnet_tpu_torch`` custom-op nodes; its ``.params``
file is the reference's byte for byte.  A reference nnvm checkpoint
serves in the port's ``Predictor``; a reference StableHLO export is
refused by name.  Tolerances: the imported program against the live port
block 0 (the same ops on the same values); against the reference 1e-5
(conv net) and 1e-4 absolute (BERT, as ``test_torch_bert.py``).
"""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import bert as jbert
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models import bert as tbert

CPU = tmx.cpu()
V = 100


def _conv_net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, prefix="c0_"),
                nn.BatchNorm(prefix="bn0_"), nn.Activation("relu"),
                nn.Conv2D(16, 1, prefix="c1_"), nn.BatchNorm(prefix="bn1_"),
                nn.Activation("relu"), nn.GlobalAvgPool2D(),
                nn.Dense(5, prefix="fc_"))
    return net


def _arrays(net_fn, x):
    """Weights of ``net_fn(jmx)`` from a seed, moving statistics away
    from 0 and 1."""
    net = net_fn(jmx)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(x))
    rng = np.random.RandomState(11)
    out = {}
    for k, p in net._collect_params_with_prefix().items():
        a = p.data().asnumpy()
        if k.endswith("running_mean"):
            a = rng.randn(*a.shape).astype(np.float32) * 0.1
        elif k.endswith("running_var"):
            a = (rng.rand(*a.shape) + 0.5).astype(np.float32)
        out[k] = a
    return out


@pytest.fixture(scope="module")
def conv_pair():
    x = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
    arrays = _arrays(_conv_net, x)
    jnet = _conv_net(jmx)
    jnet.initialize()
    jnet(jmx.nd.array(x))
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(arrays[k]))
    tnet = _conv_net(tmx)
    load_numpy_params(tnet, arrays, ctx=CPU)
    return jnet, tnet, x


def _program_targets(path):
    program = torch.export.load(path)
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and "mxnet_tpu_torch" in
            str(n.target)]


def test_conv_net_export_import_predictor(conv_pair, tmp_path):
    from mxnet_tpu_torch.ops import conv_bn_relu as cbr

    jnet, tnet, x = conv_pair
    tnet.hybridize()
    calls = cbr.conv1x1_bn_relu.calls
    live = tnet(tmx.nd.array(x, ctx=CPU)).asnumpy()
    assert cbr.conv1x1_bn_relu.calls == calls + 1  # the fused run
    ref = jnet(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(live, ref, rtol=1e-5, atol=1e-6)
    prefix = str(tmp_path / "conv")
    sym_file, params_file = tnet.export(prefix)
    meta = json.load(open(sym_file))
    assert meta["mxnet_tpu_format"] == "torch_export"
    assert meta["program_file"] == "conv-0000.pt2"
    assert meta["input_shapes"] == [[2, 3, 8, 8]]
    assert meta["num_outputs"] == 1
    assert _program_targets(prefix + "-0000.pt2") == [
        "mxnet_tpu_torch.fused_matmul_affine_relu.default"]
    # the program holds no weights (its example inputs would be them):
    # they are in the .params file
    assert torch.export.load(prefix + "-0000.pt2").example_inputs is None
    block = tmx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                          ctx=CPU)
    np.testing.assert_array_equal(
        block(tmx.nd.array(x, ctx=CPU)).asnumpy(), live)
    with open(params_file, "rb") as f:
        pred = tmx.predictor.Predictor(sym_file, f.read(), ctx=CPU)
    assert pred.input_names == ["data"]
    np.testing.assert_array_equal(pred.predict(x).asnumpy(), live)
    assert pred.num_outputs == 1
    # symbol as a dict: the program comes as a path or as bytes
    with open(prefix + "-0000.pt2", "rb") as f:
        blob = f.read()
    for program in (prefix + "-0000.pt2", blob):
        pred = tmx.predictor.create(meta, params_file, ctx=CPU,
                                    program=program)
        np.testing.assert_array_equal(
            pred.forward(data=x)[0].asnumpy(), live)
    assert pred.cache_stats()["misses"] == 1
    with pytest.raises(tmx.MXNetError, match="not found next to"):
        tmx.predictor.create(meta, params_file, ctx=CPU)
    # the parameters are restored after the trace
    np.testing.assert_array_equal(tnet(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                                  live)


def test_params_bytes_equal_the_reference_and_stablehlo_is_refused(
        conv_pair, tmp_path):
    jnet, tnet, x = conv_pair
    jnet.hybridize()
    jnet(jmx.nd.array(x))
    tnet.hybridize()
    tnet(tmx.nd.array(x, ctx=CPU))
    jsym, jparams = jnet.export(str(tmp_path / "ref"))
    tsym, tparams = tnet.export(str(tmp_path / "port"))
    with open(jparams, "rb") as a, open(tparams, "rb") as b:
        assert a.read() == b.read()
    jmeta, tmeta = json.load(open(jsym)), json.load(open(tsym))
    for key in ("param_names", "param_kinds", "input_shapes",
                "input_dtypes", "num_outputs"):
        assert tmeta[key] == jmeta[key], key
    with pytest.raises(tmx.MXNetError, match="Not carried over"):
        tmx.gluon.SymbolBlock.imports(jsym, ["data"], jparams, ctx=CPU)
    with pytest.raises(tmx.MXNetError, match="Not carried over"):
        tmx.predictor.Predictor(jsym, jparams, ctx=CPU)
    with pytest.raises(tmx.MXNetError, match="Not carried over"):
        tmx.predictor.Predictor(tsym, tparams, ctx=CPU, stablehlo=b"")


@pytest.fixture(scope="module")
def bert_pair():
    ids = np.random.RandomState(2).randint(0, V, (2, 8)).astype(np.int32)
    tt = np.zeros((2, 8), np.int32)
    jnet = jbert.bert_tiny(vocab_size=V, prefix="bert_")
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(ids, dtype="int32"), jmx.nd.array(tt, dtype="int32"))
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    tnet = tbert.bert_tiny(vocab_size=V, prefix="bert_")
    load_numpy_params(tnet, arrays, ctx=CPU)
    return jnet, tnet, ids, tt


def test_bert_export_holds_the_flash_op(bert_pair, tmp_path):
    jnet, tnet, ids, tt = bert_pair
    tnet.hybridize()
    args = [tmx.nd.array(a, ctx=CPU, dtype="int32") for a in (ids, tt)]
    live = [o.asnumpy() for o in tnet(*args)]
    ref = [o.asnumpy() for o in jnet(jmx.nd.array(ids, dtype="int32"),
                                     jmx.nd.array(tt, dtype="int32"))]
    for a, b in zip(live, ref):
        np.testing.assert_allclose(a, b, atol=1e-4)
    prefix = str(tmp_path / "bert")
    sym_file, params_file = tnet.export(prefix)
    targets = _program_targets(prefix + "-0000.pt2")
    assert targets == ["mxnet_tpu_torch.flash_attention_fwd.default"] * 2
    assert json.load(open(sym_file))["num_outputs"] == len(live)
    pred = tmx.predictor.Predictor(sym_file, params_file, ctx=CPU)
    assert pred.input_names == ["data0", "data1"]
    outs = pred.forward(data0=ids, data1=tt)
    for o, a in zip(outs, live):
        np.testing.assert_array_equal(o.asnumpy(), a)
    block = tmx.gluon.SymbolBlock.imports(sym_file, ["data0", "data1"],
                                          params_file, ctx=CPU)
    for o, a in zip(block(*args), live):
        np.testing.assert_array_equal(o.asnumpy(), a)


def _mlp_sym(mx):
    with mx.name.NameManager():
        data = mx.sym.var("data")
        h = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
        h = mx.sym.BatchNorm(h, name="bn")
        h = mx.sym.Activation(h, act_type="relu", name="relu")
        h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
        return mx.sym.SoftmaxOutput(h, name="softmax")


def test_reference_nnvm_checkpoint_serves_in_the_port(tmp_path):
    sym = _mlp_sym(jmx)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(4, 6))
    rng = np.random.RandomState(3)
    arg = {n: jmx.nd.array(rng.randn(*s).astype(np.float32))
           for n, s in zip(sym.list_arguments(), arg_shapes)
           if n not in ("data", "softmax_label")}
    aux = {"bn_moving_mean": jmx.nd.array(rng.randn(8).astype(np.float32)),
           "bn_moving_var": jmx.nd.array(rng.rand(8).astype(np.float32)
                                         + 0.5)}
    prefix = str(tmp_path / "mlp")
    jmx.model.save_checkpoint(prefix, 2, sym, arg, aux)
    x = rng.rand(4, 6).astype(np.float32)
    # without input names both take every unsaved argument, the label
    # too (the reference's rule)
    assert tmx.predictor.Predictor(
        prefix + "-symbol.json", prefix + "-0002.params",
        ctx=CPU).input_names == jmx.predictor.Predictor(
        prefix + "-symbol.json", prefix + "-0002.params").input_names == [
        "data", "softmax_label"]
    jpred = jmx.predictor.Predictor(prefix + "-symbol.json",
                                    prefix + "-0002.params",
                                    input_names=["data"])
    tpred = tmx.predictor.Predictor(prefix + "-symbol.json",
                                    prefix + "-0002.params", ctx=CPU,
                                    input_names=["data"])
    ref = jpred.predict(x).asnumpy()
    np.testing.assert_allclose(tpred.predict(x).asnumpy(), ref, rtol=1e-5,
                               atol=1e-6)
    tpred.reshape({"data": (2, 6)})
    np.testing.assert_allclose(tpred.predict(x[:2]).asnumpy(), ref[:2],
                               rtol=1e-5, atol=1e-6)
    assert tpred.cache_stats()["signatures"] == 2
    # the port's load_checkpoint reads it; the JSON loads unchanged
    tsym, targ, taux = tmx.model.load_checkpoint(prefix, 2)
    assert tsym.tojson() == sym.tojson()
    assert sorted(targ) == sorted(arg) and sorted(taux) == sorted(aux)


def test_symbol_block_over_a_port_symbol():
    sym = _mlp_sym(tmx)
    rng = np.random.RandomState(4)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(4, 6))
    values = {n: rng.randn(*s).astype(np.float32)
              for n, s in zip(sym.list_arguments() +
                              sym.list_auxiliary_states(),
                              arg_shapes + aux_shapes)
              if n not in ("data", "softmax_label")}
    values["bn_moving_var"] = np.abs(values["bn_moving_var"]) + 0.5
    params = {k: tmx.nd.array(v, ctx=CPU) for k, v in values.items()}
    block = tmx.gluon.SymbolBlock(sym, tmx.sym.var("data"), params)
    assert sorted(block.collect_params().keys()) == sorted(values)
    x = rng.rand(4, 6).astype(np.float32)
    exe = sym.simple_bind(CPU, data=(4, 6))
    exe.copy_params_from(params, params)
    want = exe.forward(data=x)[0].asnumpy()
    np.testing.assert_allclose(block(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                               want, rtol=1e-6)
    block.hybridize()
    np.testing.assert_allclose(block(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                               want, rtol=1e-6)


def test_inference_server_serves_a_predictor(conv_pair, tmp_path):
    from mxnet_tpu_torch.serving import InferenceServer, ServerConfig

    _, tnet, x = conv_pair
    tnet.hybridize()
    live = tnet(tmx.nd.array(x, ctx=CPU)).asnumpy()
    sym_file, params_file = tnet.export(str(tmp_path / "srv"))
    pred = tmx.predictor.Predictor(sym_file, params_file, ctx=CPU)
    # the program's one signature: batches padded to 2, images 8 high
    cfg = ServerConfig(max_batch=2, min_batch=2, max_length=8, min_length=8,
                       length_axis=1, batch_window_ms=5.0)
    with InferenceServer(pred, cfg) as srv:
        assert srv.input_names == ["data"]
        futs = [srv.submit(x[i % 2]) for i in range(6)]
        outs = [f.result(timeout=60) for f in futs]
        stats = srv.stats()
    for i, o in enumerate(outs):
        got = o[0] if isinstance(o, (list, tuple)) else o
        np.testing.assert_allclose(np.asarray(got), live[i % 2], rtol=1e-5,
                                   atol=1e-6)
    assert stats["completed"] == 6 and stats["cache"]["signatures"] == 1


def test_export_of_a_block_reaching_nms_keep_is_refused(tmp_path):
    """Refused until slice 23, which made ``nms_keep`` a custom op: the
    block now exports, its program holds the op as one node, and the
    imported program and the ``Predictor`` give the live block's
    detections; the reference's ``box_nms`` gives the same rows."""
    class Nms(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.scale = tmx.gluon.nn.Dense(6, flatten=False,
                                                in_units=6)

        def hybrid_forward(self, F, x):
            return F.contrib.box_nms(self.scale(x), overlap_thresh=0.5)

    net = Nms()
    net.initialize(tmx.init.One(), ctx=CPU)
    net.hybridize()
    x = np.array([[[0, 0.9, 0, 0, 1, 1], [0, 0.8, 0, 0, 1, 0.9]]],
                 np.float32)
    before = net(tmx.nd.array(x, ctx=CPU)).asnumpy()
    rows = np.einsum("bnk,jk->bnj", x, np.ones((6, 6), np.float32))
    ref = jmx.nd.contrib.box_nms(jmx.nd.array(rows),
                                 overlap_thresh=0.5).asnumpy()
    np.testing.assert_array_equal(before, np.asarray(ref, np.float32))
    tensors = [p.data()._data for p in net.collect_params().values()]
    prefix = str(tmp_path / "nms")
    sym_file, params_file = net.export(prefix)
    assert _program_targets(prefix + "-0000.pt2") == \
        ["mxnet_tpu_torch.nms_keep.default"]
    # the trace restored every parameter's own tensor
    assert all(p.data()._data is t for p, t in
               zip(net.collect_params().values(), tensors))
    block = tmx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                          ctx=CPU)
    np.testing.assert_array_equal(
        block(tmx.nd.array(x, ctx=CPU)).asnumpy(), before)
    pred = tmx.predictor.Predictor(sym_file, params_file, ctx=CPU)
    np.testing.assert_array_equal(pred.predict(x).asnumpy(), before)


def test_a_block_without_parameters_exports_and_imports(tmp_path):
    """A block with no parameters writes a ``.params`` file without
    names, which reads back as an empty list: the import takes it as no
    parameters."""
    class Nms(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.contrib.box_nms(x, overlap_thresh=0.5)

    net = Nms()
    net.hybridize()
    x = np.array([[[0, 0.9, 0, 0, 1, 1], [0, 0.8, 0, 0, 1, 0.9]]],
                 np.float32)
    live = net(tmx.nd.array(x, ctx=CPU)).asnumpy()
    sym_file, params_file = net.export(str(tmp_path / "noparams"))
    block = tmx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                          ctx=CPU)
    np.testing.assert_array_equal(
        block(tmx.nd.array(x, ctx=CPU)).asnumpy(), live)


def test_sparse_arrays_are_written_dense_as_the_reference(tmp_path):
    dense = np.zeros((5, 3), np.float32)
    dense[[1, 3]] = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tmx.nd.array(dense, ctx=CPU).tostype("row_sparse")
    # the reference's nd.save refuses a sparse array (its save converts
    # it with jnp.asarray); the port writes it as the reference writes
    # the dense array
    with pytest.raises(TypeError):
        jmx.nd.save(str(tmp_path / "x.params"),
                    {"w": jmx.nd.array(dense).tostype("row_sparse")})
    jmx.nd.save(str(tmp_path / "ref.params"), {"w": jmx.nd.array(dense)})
    tmx.nd.save(str(tmp_path / "port.params"), {"w": t})
    assert (tmp_path / "ref.params").read_bytes() == \
        (tmp_path / "port.params").read_bytes()
    back = tmx.nd.load(str(tmp_path / "port.params"))["w"]
    assert back.stype == "default"
    np.testing.assert_array_equal(back.asnumpy(), dense)

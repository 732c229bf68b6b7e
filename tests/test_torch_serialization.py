"""MXNet ``.params`` files and optimizer-state files of the PyTorch/CUDA
port against the JAX package's: the same bytes for the same arrays, files
read both ways (V1 included), a ``resnet18_v1`` saved by the JAX package
loaded into the port with the same forward, and ``Trainer.save_states``
files exchanged both ways.
"""
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import serialization as jser
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

CPU = tmx.cpu()


def _numpy_arrays():
    rng = np.random.RandomState(0)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "h": rng.normal(size=(5,)).astype(np.float16),
            "d": rng.normal(size=(2, 2)).astype(np.float64),
            "i": rng.randint(-9, 9, (4,)).astype(np.int32),
            "l": rng.randint(-9, 9, (2, 3)).astype(np.int64),
            "b": rng.randint(-9, 9, (6,)).astype(np.int8),
            "u": rng.randint(0, 255, (7,)).astype(np.uint8),
            "s": np.array(3.5, np.float32),
            "bf": rng.normal(size=(2, 3)).astype(np.float32)}


def _pair(arrays):
    """The same arrays as NDArrays of each package (``bf`` as bf16)."""
    j = {k: jmx.nd.array(v, dtype="bfloat16" if k == "bf" else v.dtype)
         for k, v in arrays.items()}
    t = {k: tmx.nd.array(v, ctx=CPU,
                         dtype="bfloat16" if k == "bf" else v.dtype)
         for k, v in arrays.items()}
    return j, t


def test_nd_save_writes_the_reference_bytes(tmp_path):
    j, t = _pair(_numpy_arrays())
    for data_j, data_t in ((j, t), (list(j.values()), list(t.values()))):
        jmx.nd.save(str(tmp_path / "j.params"), data_j)
        tmx.nd.save(str(tmp_path / "t.params"), data_t)
        assert (tmp_path / "j.params").read_bytes() == \
            (tmp_path / "t.params").read_bytes()


def test_files_cross_read_both_ways(tmp_path):
    arrays = _numpy_arrays()
    j, t = _pair(arrays)
    jmx.nd.save(str(tmp_path / "j.params"), j)
    tmx.nd.save(str(tmp_path / "t.params"), t)
    from_j = tmx.nd.load(str(tmp_path / "j.params"))
    from_t = jmx.nd.load(str(tmp_path / "t.params"))
    for k, v in arrays.items():
        want = v if k != "bf" else \
            tmx.nd.array(v, ctx=CPU, dtype="bfloat16").asnumpy()
        for got in (from_j[k].asnumpy(), np.asarray(from_t[k].asnumpy())):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        assert from_j[k].context == CPU
    tmx.nd.save(str(tmp_path / "list.params"), list(t.values()))
    assert isinstance(tmx.nd.load(str(tmp_path / "list.params")), list)


def _v1_file(path, arrays):
    """A V1 container (uint32 dims, no storage type), as older MXNet
    writes it."""
    out = bytearray(struct.pack("<QQQ", 0x112, 0, len(arrays)))
    for a in arrays.values():
        out += struct.pack("<II", 0xF993FAC8, a.ndim)
        out += struct.pack(f"<{a.ndim}I", *a.shape)
        out += struct.pack("<iii", 1, 0, jser._TYPE_FLAG[a.dtype])
        out += a.tobytes()
    out += struct.pack("<Q", len(arrays))
    for name in arrays:
        out += struct.pack("<Q", len(name)) + name.encode()
    path.write_bytes(bytes(out))


def test_v1_files_read_as_the_reference_reads_them(tmp_path):
    arrays = {k: v for k, v in _numpy_arrays().items() if k != "bf"}
    _v1_file(tmp_path / "v1.params", arrays)
    got = tmx.nd.load(str(tmp_path / "v1.params"))
    ref = jmx.nd.load(str(tmp_path / "v1.params"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].asnumpy(), v)
        np.testing.assert_array_equal(got[k].asnumpy(),
                                      np.asarray(ref[k].asnumpy()))


def test_bad_files_raise(tmp_path):
    (tmp_path / "x.params").write_bytes(b"\x00" * 16)
    with pytest.raises(tmx.MXNetError, match="not an MXNet"):
        tmx.nd.load(str(tmp_path / "x.params"))
    tmx.nd.save(str(tmp_path / "t.params"), {"a": tmx.nd.ones((9,),
                                                              ctx=CPU)})
    (tmp_path / "cut.params").write_bytes(
        (tmp_path / "t.params").read_bytes()[:-20])
    with pytest.raises(tmx.MXNetError, match="truncated"):
        tmx.nd.load(str(tmp_path / "cut.params"))
    sparse = bytearray(struct.pack("<QQQ", 0x112, 0, 1))
    sparse += struct.pack("<Ii", 0xF993FAC9, 1)
    (tmp_path / "rsp.params").write_bytes(bytes(sparse))
    with pytest.raises(tmx.MXNetError, match="item 8"):
        tmx.nd.load(str(tmp_path / "rsp.params"))


def test_module_checkpoint_files_match(tmp_path):
    arrays = _numpy_arrays()
    j, t = _pair(arrays)
    args = ["w", "h"]
    jser.save_checkpoint(str(tmp_path / "j"), 3,
                         arg_params={k: j[k] for k in args},
                         aux_params={"i": j["i"]})
    tser.save_checkpoint(str(tmp_path / "t"), 3,
                         arg_params={k: t[k] for k in args},
                         aux_params={"i": t["i"]})
    assert (tmp_path / "j-0003.params").read_bytes() == \
        (tmp_path / "t-0003.params").read_bytes()
    sym, arg, aux = tser.load_checkpoint(str(tmp_path / "j"), 3)
    assert sym is None and sorted(arg) == sorted(args) and list(aux) == ["i"]
    np.testing.assert_array_equal(arg["w"].asnumpy(), arrays["w"])


def test_resnet18_saved_by_jax_loads_into_the_port(tmp_path):
    """``resnet18_v1`` (thumbnail, 8 classes) initialized and saved by the
    JAX package: the port's ``load_parameters`` (deferred shapes and all)
    gives the same forward on the CPU, f32, within 1e-4 of the largest
    logit (the convolutions sum in other orders); the port's file of the
    same net is byte for byte the JAX package's."""
    jmx.random.seed(3)
    jnet = jresnet.resnet18_v1(classes=8, thumbnail=True)
    jnet.initialize(jmx.init.Xavier())
    x = np.random.RandomState(4).normal(size=(2, 3, 16, 16)) \
        .astype(np.float32)
    ref = jnet(jmx.nd.array(x)).asnumpy()
    jnet.save_parameters(str(tmp_path / "j.params"))
    tnet = tresnet.resnet18_v1(classes=8, thumbnail=True)
    tnet.load_parameters(str(tmp_path / "j.params"), ctx=CPU)
    got = tnet(tmx.nd.array(x, ctx=CPU)).asnumpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    tnet.save_parameters(str(tmp_path / "t.params"))
    assert (tmp_path / "j.params").read_bytes() == \
        (tmp_path / "t.params").read_bytes()
    # pretrained=True reads <root>/resnet18_v1.params, a local file only
    with pytest.raises(tmx.MXNetError, match="resnet18_v1.params"):
        tresnet.resnet18_v1(pretrained=True, root=str(tmp_path / "zoo"))
    (tmp_path / "zoo").mkdir()
    (tmp_path / "zoo" / "resnet18_v1.params").write_bytes(
        (tmp_path / "j.params").read_bytes())
    tnet2 = tresnet.resnet18_v1(classes=8, thumbnail=True, pretrained=True,
                                root=str(tmp_path / "zoo"), ctx=CPU)
    np.testing.assert_array_equal(
        tnet2(tmx.nd.array(x, ctx=CPU)).asnumpy(), got)


def test_load_parameters_options(tmp_path):
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(3, in_units=2), tmx.gluon.nn.Dense(2,
                                                                  in_units=3))
    net.initialize(ctx=CPU)
    net.save_parameters(str(tmp_path / "a.params"))
    small = tmx.gluon.nn.HybridSequential()
    small.add(tmx.gluon.nn.Dense(3, in_units=2))
    small.initialize(ctx=CPU)
    with pytest.raises(tmx.MXNetError, match="not in"):
        small.load_parameters(str(tmp_path / "a.params"))
    small.load_parameters(str(tmp_path / "a.params"), ignore_extra=True)
    np.testing.assert_array_equal(small[0].weight.data().asnumpy(),
                                  net[0].weight.data().asnumpy())
    big = tmx.gluon.nn.HybridSequential()
    big.add(tmx.gluon.nn.Dense(3, in_units=2), tmx.gluon.nn.Dense(2,
                                                                  in_units=3),
            tmx.gluon.nn.Dense(1, in_units=2))
    big.initialize(ctx=CPU)
    with pytest.raises(tmx.MXNetError, match="missing"):
        big.load_parameters(str(tmp_path / "a.params"))
    big.load_parameters(str(tmp_path / "a.params"), allow_missing=True)
    net.cast("float16")
    net.save_parameters(str(tmp_path / "h.params"))
    f32 = tmx.gluon.nn.HybridSequential()
    f32.add(tmx.gluon.nn.Dense(3, in_units=2), tmx.gluon.nn.Dense(2,
                                                                  in_units=3))
    f32.initialize(ctx=CPU)
    f32.load_parameters(str(tmp_path / "h.params"))
    assert f32[0].weight.data().dtype == tmx.nd.array([1.0], ctx=CPU).dtype
    f32.load_parameters(str(tmp_path / "h.params"), cast_dtype=True,
                        dtype_source="saved")
    assert str(f32[0].weight.data().dtype) == "torch.float16"
    # the legacy ParameterDict.save route: full-prefix names, arg:/aux:
    legacy = {f"arg:{p.name}": p.data() * 2 for p in
              net.collect_params().values()}
    tmx.nd.save(str(tmp_path / "legacy.params"), legacy)
    net.load_parameters(str(tmp_path / "legacy.params"))
    for p in net.collect_params().values():
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      legacy[f"arg:{p.name}"].asnumpy())


def _trainer_pair(opt, kw):
    """One step of the same Dense net in both packages → (JAX trainer,
    port trainer, the port net)."""
    rng = np.random.RandomState(5)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    x = rng.normal(size=(3, 6)).astype(np.float32)
    out = []
    for pkg, ag in ((jmx, jautograd), (tmx, tautograd)):
        net = pkg.gluon.nn.Dense(4, in_units=6, use_bias=False)
        if pkg is jmx:
            net.initialize()
            net.weight.set_data(jmx.nd.array(w))
            xs = jmx.nd.array(x)
        else:
            net.initialize(ctx=CPU)
            net.weight.set_data(w)
            xs = tmx.nd.array(x, ctx=CPU)
        tr = pkg.gluon.Trainer(net.collect_params(), opt, dict(kw))
        with ag.record():
            loss = (net(xs) * net(xs)).sum()
        loss.backward()
        tr.step(3)
        out.append((tr, net))
    return out


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01})])
def test_trainer_states_files_interchange(tmp_path, opt, kw):
    (jtr, _), (ttr, _) = _trainer_pair(opt, kw)
    jtr.save_states(str(tmp_path / "j.states"))
    ttr.save_states(str(tmp_path / "t.states"))
    (jtr2, _), (ttr2, _) = _trainer_pair(opt, {**kw, "learning_rate": 0.5})
    ttr2.load_states(str(tmp_path / "j.states"))
    jtr2.load_states(str(tmp_path / "t.states"))
    from mxnet_tpu import optimizer as jopt
    from mxnet_tpu_torch import optimizer as topt

    def flat(tr, mod):
        return [np.asarray(s.asnumpy(), np.float32) for st in tr._states
                for s in mod._flatten_state(st)] if mod is jopt else \
            [s.numpy() for st in tr._states for s in mod._flatten_state(st)]

    for a, b in zip(flat(ttr2, topt), flat(jtr, jopt)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(flat(jtr2, jopt), flat(ttr, topt)):
        np.testing.assert_array_equal(a, b)
    assert ttr2._optimizer.num_update == jtr._optimizer.num_update == 1
    assert ttr2._optimizer._index_update_count == \
        jtr._optimizer._index_update_count

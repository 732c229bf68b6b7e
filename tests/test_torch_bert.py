"""BERT of the PyTorch/CUDA port against the JAX package, on the CPU.

``bert_tiny`` (2 layers, units 128, 2 heads) is built in the JAX
package, its weights cross as numpy arrays keyed by structural name
(``convert.load_numpy_params``, ``encoder.position_weight`` among them),
and the same seeded ids go through both.  Without ``valid_length`` the
port's attention runs the flash kernels' plain versions; with it, the
masked route.  amp is process-wide in both packages: the ``amp_off``
fixture turns it off in both after every test that turns it on.

Tolerances: f32 forward 1e-4 absolute (two layers of other summation
orders; outputs about 1, MLM logits about 3); f32 gradients and Adam
weights 1e-4 absolute; bf16 amp forward: both packages round the same
products to bf16 at the same places and differ by summation order
inside them, held by relative norm within 2^-6 (4 bf16 steps).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.models import bert as jbert

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models import bert as tbert

CPU = tmx.cpu()
TOL = 1e-4
BF16_NORM_TOL = 2.0 ** -6
V = 100


@pytest.fixture
def amp_off():
    yield
    jamp.turn_off()
    tamp.turn_off()


def _pair(make, seed=0):
    """The reference net, initialized from ``seed`` (its initializer
    draws from a key that is otherwise seeded from numpy's global state
    at the process's first draw), and the port's net with its weights."""
    jnet = make(jbert)
    jmx.random.seed(seed)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(np.ones((1, 4), np.int32), dtype="int32"))
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    tnet = make(tbert)
    load_numpy_params(tnet, arrays, ctx=CPU)
    return jnet, tnet, arrays


@pytest.fixture(scope="module")
def tiny():
    # an explicit prefix: the automatic one counts the BERT models built
    # before in the process, in each package on its own
    return _pair(lambda m: m.bert_tiny(vocab_size=V, prefix="berttiny_"))


def _ids(b, t, seed, lo=0):
    return np.random.RandomState(seed).randint(lo, V, (b, t)) \
        .astype(np.int32)


def _outs(pkg, net, *arrays, ctx=None):
    kw = {"ctx": ctx} if ctx is not None else {}
    args = [None if a is None else pkg.nd.array(
        a, dtype="int32" if a.dtype == np.int32 else "float32", **kw)
        for a in arrays]
    outs = net(*args)
    return [o.asnumpy() for o in (outs if isinstance(outs, tuple)
                                  else (outs,))]


def test_structural_names_and_position_weight(tiny):
    jnet, tnet, arrays = tiny
    names = list(tnet._collect_params_with_prefix())
    assert names == list(arrays)
    assert "encoder.position_weight" in names
    assert arrays["encoder.position_weight"].shape == (128, 128)


@pytest.mark.parametrize("with_length", [False, True])
def test_bert_tiny_four_outputs(tiny, with_length):
    jnet, tnet, _ = tiny
    ids, seg = _ids(2, 12, 1), _ids(2, 12, 2) % 2
    vl = np.array([7.0, 12.0], np.float32) if with_length else None
    ref = _outs(jmx, jnet, ids, seg, vl)
    got = _outs(tmx, tnet, ids, seg, vl, ctx=CPU)
    assert [g.shape for g in got] == [(2, 12, 128), (2, 128), (2, 2),
                                      (2, 12, V)]
    for g, r in zip(got, ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, atol=TOL, rtol=0)


def test_valid_length_masking_padding_invariance(tiny):
    """Tokens beyond valid_length do not change the real positions."""
    _, tnet, _ = tiny
    t1 = _ids(1, 8, 3, lo=1)
    t2 = t1.copy()
    t2[0, 6:] = 3
    vl = np.array([6.0], np.float32)
    s1 = _outs(tmx, tnet, t1, None, vl, ctx=CPU)[0]
    s2 = _outs(tmx, tnet, t2, None, vl, ctx=CPU)[0]
    np.testing.assert_allclose(s1[0, :6], s2[0, :6], atol=1e-5)
    assert not np.allclose(s1[0, 6:], s2[0, 6:])


def _cls(m):
    return m.BERTClassifier(m.bert_tiny(vocab_size=60, dropout=0.0),
                            num_classes=3)


def _adam_steps(pkg, autograd, net, tokens, labels, ctx=None):
    kw = {"ctx": ctx} if ctx is not None else {}
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    x = pkg.nd.array(tokens, dtype="int32", **kw)
    y = pkg.nd.array(labels, **kw)
    losses = []
    for _ in range(3):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(len(labels))
        losses.append(float(loss.mean().asscalar()))
    return losses, {k: p.data().asnumpy() for k, p in
                    net._collect_params_with_prefix().items()}


def test_classifier_three_adam_steps():
    """Losses and every weight after three Adam steps (lr 1e-3).  The key
    projection's bias has a gradient of exactly 0 in exact arithmetic
    (it adds q·b to every score of a query's row, which the softmax
    cancels); both packages' gradients there are f32 rounding noise,
    which Adam divides by its own magnitude, so each step moves those
    weights by up to lr in a direction noise decides: they are held to
    3 steps of lr, every other weight to TOL."""
    jnet, tnet, _ = _pair(_cls)
    tokens = _ids(4, 10, 4) % 60
    labels = np.array([0, 1, 2, 0], np.float32)
    ref_losses, ref_w = _adam_steps(jmx, jautograd, jnet, tokens, labels)
    got_losses, got_w = _adam_steps(tmx, tautograd, tnet, tokens, labels,
                                    ctx=CPU)
    np.testing.assert_allclose(got_losses, ref_losses, atol=TOL, rtol=0)
    assert got_losses[-1] < got_losses[0]
    assert set(got_w) == set(ref_w)
    for k in ref_w:
        tol = 3 * 1e-3 if k.endswith("proj_key.bias") else TOL
        np.testing.assert_allclose(got_w[k], ref_w[k], atol=tol, rtol=0,
                                   err_msg=k)


def test_hybridize_parity():
    jnet, tnet, _ = _pair(lambda m: m.bert_tiny(
        vocab_size=40, dropout=0.0, use_decoder=False,
        use_classifier=False))
    ids = _ids(2, 6, 5) % 40
    jnet.hybridize()
    tnet.hybridize(static_alloc=True)
    ref = _outs(jmx, jnet, ids)
    for _ in range(2):
        got = _outs(tmx, tnet, ids, ctx=CPU)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, atol=TOL, rtol=0)
    # None inputs are part of the signature
    _outs(tmx, tnet, ids, None, np.array([3.0, 6.0], np.float32), ctx=CPU)
    stats = tnet.cache_stats()
    assert stats["signatures"] == stats["misses"] == 2
    assert stats["hits"] == 1


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("with_length", [False, True])
def test_amp_bf16_forward(tiny, amp_off, with_length):
    """amp.init("bfloat16") in both packages: the same f32 weights, the
    listed ops in bf16.  The port's outputs against the reference's
    within the bf16 tolerance, and away from its own f32 outputs (amp
    took effect)."""
    jnet, tnet, _ = tiny
    ids, seg = _ids(2, 16, 6), _ids(2, 16, 7) % 2
    vl = np.array([9.0, 16.0], np.float32) if with_length else None
    f32 = _outs(tmx, tnet, ids, seg, vl, ctx=CPU)
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    assert tamp.is_active()
    ref = _outs(jmx, jnet, ids, seg, vl)
    got = _outs(tmx, tnet, ids, seg, vl, ctx=CPU)
    for g, r, f in zip(got, ref, f32):
        assert np.isfinite(g).all()
        assert _rel_norm(g, r) <= BF16_NORM_TOL
        assert _rel_norm(g, f) > 1e-5


def test_amp_casts_by_op_name(amp_off):
    x = tmx.nd.array(np.ones((2, 3), np.float32), ctx=CPU)
    w = tmx.nd.array(np.ones((4, 3), np.float32), ctx=CPU)
    tamp.init("bfloat16")
    assert tmx.nd.fully_connected(x, w, no_bias=True,
                                  num_hidden=4).dtype == torch.bfloat16
    xb = x.astype("bfloat16")
    assert tmx.nd.sum(xb).dtype == torch.float32       # FP32_OPS
    assert tmx.nd.softmax_cross_entropy(                # deliberately free
        xb, tmx.nd.array([0, 1], ctx=CPU)).dtype == torch.float32
    assert (xb + xb).dtype == torch.bfloat16            # unlisted
    tamp.turn_off()
    assert tmx.nd.fully_connected(x, w, no_bias=True,
                                  num_hidden=4).dtype == torch.float32


def test_amp_gradient_reaches_f32_parameters_in_f32(amp_off):
    net = tmx.gluon.nn.Dense(4, in_units=3)
    net.initialize(ctx=CPU)
    tamp.init("bfloat16")
    with tautograd.record():
        y = net(tmx.nd.array(np.ones((2, 3), np.float32), ctx=CPU))
    assert y.dtype == torch.bfloat16
    y.backward()
    assert net.weight.grad().dtype == torch.float32
    np.testing.assert_array_equal(net.weight.grad().asnumpy(),
                                  np.full((4, 3), 2.0, np.float32))


def test_amp_bf16_fused_conv_run_matches_the_reference(amp_off):
    """Under amp the port's fused 1×1 conv+BN+ReLU run (inference) casts
    the conv's operands as amp casts ``convolution``'s; the JAX package
    runs the three layers.  Both in bf16, held within 2 bf16 steps of
    the largest output (the fused run rounds once, after the affine)."""
    def make(pkg):
        nn = pkg.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Conv2D(16, 1, in_channels=8), nn.BatchNorm(in_channels=16),
                nn.Activation("relu"))
        return net

    jnet = make(jmx)
    jnet.initialize(jmx.init.Xavier())
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    rng = np.random.RandomState(9)
    arrays["1.running_mean"] = rng.randn(16).astype(np.float32) * 0.1
    arrays["1.running_var"] = rng.rand(16).astype(np.float32) + 0.5
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(arrays[k]))
    tnet = make(tmx)
    load_numpy_params(tnet, arrays, ctx=CPU)
    x = rng.randn(2, 8, 5, 5).astype(np.float32)
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    from mxnet_tpu_torch.ops import conv_bn_relu as tcbr

    calls = tcbr.conv1x1_bn_relu.calls
    got = tnet(tmx.nd.array(x, ctx=CPU))
    assert tcbr.conv1x1_bn_relu.calls == calls + 1
    assert got.dtype == torch.bfloat16
    ref = jnet(jmx.nd.array(x)).astype("float32").asnumpy()
    got = got.asnumpy()
    assert np.abs(got - ref).max() <= 2 * 2.0 ** -8 * np.abs(ref).max()


def test_op_lists_equal_the_reference(amp_off):
    assert tamp.TARGET_OPS == jamp.TARGET_OPS
    assert tamp.FP32_OPS == jamp.FP32_OPS
    with pytest.raises(tmx.MXNetError):
        tamp.init("int8")
    assert not tamp.is_active() and tamp.target_dtype() is None


def test_loss_scaler_and_convert_hybrid_block(amp_off):
    net = tmx.gluon.nn.Dense(2, in_units=2)
    net.initialize(ctx=CPU)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    tamp.init_trainer(trainer)
    x = tmx.nd.array(np.ones((1, 2), np.float32), ctx=CPU)
    with tautograd.record():
        loss = net(x).sum()
        with tamp.scale_loss(loss, trainer) as scaled:
            pass
    scaled.backward()
    assert trainer._scale == 1.0 / 2 ** 16
    assert not tamp.unscale(trainer)
    net.weight.grad()._data.fill_(float("inf"))
    assert tamp.unscale(trainer)
    assert trainer._amp_loss_scaler.loss_scale == 2 ** 15
    tamp.convert_hybrid_block(net)
    assert net.weight.data().dtype == torch.bfloat16


def test_bert_to_symbol_matches_the_reference(tiny):
    # the symbol of the same net has the reference's JSON and parameter
    # names (the ONNX parity test is tests/test_torch_onnx.py)
    jnet, tnet, _ = tiny
    with jmx.name.NameManager(), tmx.name.NameManager():
        tsym, tparams = tbert.bert_to_symbol(tnet, 1, 8)
        jsym, jparams = jbert.bert_to_symbol(jnet, 1, 8)
    assert tsym.tojson() == jsym.tojson()
    assert sorted(tparams) == sorted(jparams)

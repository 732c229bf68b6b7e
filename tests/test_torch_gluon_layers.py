"""Gluon layers, losses and initializers of slice 9 against the JAX
package: the layers of ``gluon/nn`` the slice adds (Sequential,
HybridConcatenate, Identity, Lambda, HybridLambda, InstanceNorm,
GroupNorm, the 1D/3D and transposed convolutions, the 1D/3D and global
pools, ReflectionPad2D), the losses of ``gluon/loss.py``, and the
initializers MSRAPrelu, Orthogonal, Bilinear, LSTMBias and Mixed.

Each layer is built in both packages with the same weights, drawn with
numpy from a seed and set by structural name; one recorded forward and a
backward seeded with the same random heads give the outputs and the
gradients of the input and of every parameter, compared at f32
``rtol=1e-4, atol=1e-5`` (convolutions and norms sum in other orders).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
TOL = dict(rtol=1e-4, atol=1e-5)


def _build(pkg, make, x):
    kw = dict(ctx=CPU) if pkg is tmx else {}
    net = make(pkg)
    net.initialize(init=pkg.init.Zero(), **kw)  # the weights are set after
    net(pkg.nd.array(x, **kw))  # resolve deferred shapes
    return net


def _run(pkg, make, x, arrays, head_seed):
    kw = dict(ctx=CPU) if pkg is tmx else {}
    net = _build(pkg, make, x)
    params = net._collect_params_with_prefix()
    assert sorted(params) == sorted(arrays)
    for k, p in params.items():
        p.set_data(pkg.nd.array(arrays[k], **kw))
    xin = pkg.nd.array(x, **kw)
    xin.attach_grad()
    with pkg.autograd.record():
        out = net(xin)
    head = np.random.RandomState(head_seed).normal(
        size=out.shape).astype(np.float32)
    out.backward(pkg.nd.array(head, **kw))
    grads = {k: p.grad().asnumpy() for k, p in params.items()
             if p.grad_req != "null"}
    return out.asnumpy(), xin.grad.asnumpy(), grads


def _nn(pkg):
    return pkg.gluon.nn


def _seq(pkg):
    nn = _nn(pkg)
    net = nn.Sequential()
    net.add(nn.Dense(5, activation="tanh"), nn.Dense(3))
    return net


def _concat(pkg):
    nn = _nn(pkg)
    net = nn.HybridConcatenate(axis=1)
    net.add(nn.Dense(4), nn.Identity(), nn.Dense(2, activation="relu"))
    return net


def _lambdas(pkg):
    nn = _nn(pkg)
    net = nn.Sequential()
    net.add(nn.Lambda("tanh"), nn.Lambda(lambda x: x * 2 + 1),
            nn.HybridLambda("sigmoid"), nn.HybridLambda(lambda x: x * x))
    return net


LAYERS = [
    ("sequential", _seq, (4, 6)),
    ("hybrid_concatenate", _concat, (4, 6)),
    ("lambdas", _lambdas, (4, 6)),
    ("instance_norm", lambda p: _nn(p).InstanceNorm(scale=True),
     (2, 3, 5, 5)),
    ("group_norm", lambda p: _nn(p).GroupNorm(num_groups=2), (2, 4, 3, 3)),
    ("conv1d", lambda p: _nn(p).Conv1D(4, 3, strides=2, padding=1,
                                       dilation=2), (2, 3, 11)),
    ("conv3d", lambda p: _nn(p).Conv3D(4, (2, 3, 3), padding=(0, 1, 1),
                                       groups=1, activation="relu"),
     (1, 2, 4, 5, 5)),
    ("conv1d_transpose", lambda p: _nn(p).Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1), (2, 4, 6)),
    ("conv2d_transpose", lambda p: _nn(p).Conv2DTranspose(
        3, (3, 3), strides=(2, 2), padding=(1, 1), output_padding=(1, 1),
        use_bias=False), (2, 4, 5, 5)),
    ("conv3d_transpose", lambda p: _nn(p).Conv3DTranspose(
        2, (2, 2, 2), strides=(1, 2, 2)), (1, 3, 3, 4, 4)),
    ("max_pool1d", lambda p: _nn(p).MaxPool1D(3, 2, ceil_mode=True),
     (2, 3, 10)),
    ("max_pool3d", lambda p: _nn(p).MaxPool3D((2, 2, 2), padding=1),
     (1, 2, 4, 5, 5)),
    ("avg_pool1d", lambda p: _nn(p).AvgPool1D(3, 2, padding=1,
                                              count_include_pad=False),
     (2, 3, 9)),
    ("avg_pool3d", lambda p: _nn(p).AvgPool3D((2, 3, 3), (1, 2, 2),
                                              ceil_mode=True),
     (1, 2, 4, 6, 6)),
    ("global_max_pool1d", lambda p: _nn(p).GlobalMaxPool1D(), (2, 3, 7)),
    ("global_max_pool2d", lambda p: _nn(p).GlobalMaxPool2D(), (2, 3, 4, 5)),
    ("global_max_pool3d", lambda p: _nn(p).GlobalMaxPool3D(),
     (1, 2, 3, 4, 5)),
    ("global_avg_pool1d", lambda p: _nn(p).GlobalAvgPool1D(), (2, 3, 7)),
    ("global_avg_pool3d", lambda p: _nn(p).GlobalAvgPool3D(),
     (1, 2, 3, 4, 5)),
    ("reflection_pad2d", lambda p: _nn(p).ReflectionPad2D(2), (1, 2, 4, 5)),
]


@pytest.mark.parametrize("name,make,shape", LAYERS,
                         ids=[n for n, _, _ in LAYERS])
def test_layer_matches_reference(name, make, shape):
    rng = np.random.RandomState(len(name))
    x = rng.normal(size=shape).astype(np.float32)
    probe = _build(tmx, make, x)
    arrays = {k: (rng.uniform(0.5, 1.5, p.shape) if k.endswith("gamma")
                  else rng.normal(0, 0.5, p.shape)).astype(np.float32)
              for k, p in probe._collect_params_with_prefix().items()}
    got = _run(tmx, make, x, arrays, 7)
    ref = _run(jmx, make, x, arrays, 7)
    np.testing.assert_allclose(got[0], ref[0], **TOL)
    np.testing.assert_allclose(got[1], ref[1], **TOL)
    assert sorted(got[2]) == sorted(ref[2])
    for k in ref[2]:
        np.testing.assert_allclose(got[2][k], ref[2][k], err_msg=k, **TOL)


def test_sequential_slices_and_sync_batch_norm_is_left_out():
    nn = tmx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(3), nn.Dense(4), nn.Dense(5))
    head = net[:2]
    assert isinstance(head, nn.HybridSequential) and len(head) == 2
    assert head[1] is net[1] and list(net)[2] is net[2]
    bn = nn.SyncBatchNorm(in_channels=3)  # ported in slice 11
    assert isinstance(bn, nn.BatchNorm)


LOSSES = [
    ("sigmoid_bce", lambda L: L.SigmoidBCELoss(), "n", "b", ()),
    ("sigmoid_bce_probs", lambda L: L.SigmoidBinaryCrossEntropyLoss(
        from_sigmoid=True), "prob", "b", ()),
    ("sigmoid_bce_pos_weight", lambda L: L.SigmoidBCELoss(), "n", "b",
     ("p1", "p")),  # sample_weight, pos_weight
    ("kl_div", lambda L: L.KLDivLoss(from_logits=False), "n", "prob", ()),
    ("huber", lambda L: L.HuberLoss(rho=0.5), "n", "n", ()),
    ("hinge", lambda L: L.HingeLoss(margin=1.5), "n", "sign", ()),
    ("squared_hinge", lambda L: L.SquaredHingeLoss(), "n", "sign", ()),
    ("logistic_signed", lambda L: L.LogisticLoss(), "n", "sign", ()),
    ("logistic_binary", lambda L: L.LogisticLoss(label_format="binary"),
     "n", "b", ()),
    ("poisson_nll", lambda L: L.PoissonNLLLoss(compute_full=True), "n",
     "count", ()),
    ("poisson_nll_rate", lambda L: L.PoissonNLLLoss(from_logits=False),
     "p", "count", ()),
    ("softmax_ce_dense", lambda L: L.SoftmaxCELoss(sparse_label=False,
                                                   weight=0.5),
     "n", "prob", ("p1",)),  # sample_weight
]


def _arr(kind, shape, rng):
    if kind == "n":
        return rng.normal(size=shape)
    if kind == "p":
        return rng.uniform(0.5, 2.0, shape)
    if kind == "p1":
        return rng.uniform(0.5, 2.0, shape[:1] + (1,))
    if kind == "b":
        return rng.randint(0, 2, shape)
    if kind == "sign":
        return rng.choice([-1.0, 1.0], shape)
    if kind == "count":
        return rng.randint(0, 5, shape)
    if kind == "prob":
        a = rng.uniform(0.05, 1.0, shape)
        return a / a.sum(-1, keepdims=True)
    raise ValueError(kind)


def _loss_run(pkg, make, arrays):
    kw = dict(ctx=CPU) if pkg is tmx else {}
    pred = pkg.nd.array(arrays[0], **kw)
    pred.attach_grad()
    args = [pkg.nd.array(a, **kw) for a in arrays[1:]]
    with pkg.autograd.record():
        loss = make(pkg.gluon.loss)(pred, *args)
    loss.backward()
    return loss.asnumpy(), pred.grad.asnumpy()


@pytest.mark.parametrize("name,make,pk,lk,extra", LOSSES,
                         ids=[n[0] for n in LOSSES])
def test_loss_matches_reference(name, make, pk, lk, extra):
    rng = np.random.RandomState(len(name))
    shape = (4, 5)
    arrays = [_arr(kind, shape, rng).astype(np.float32)
              for kind in (pk, lk) + extra]
    got = _loss_run(tmx, make, arrays)
    ref = _loss_run(jmx, make, arrays)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **TOL)


@pytest.mark.parametrize("name", ["triplet", "cosine_embedding"])
def test_three_input_losses_match_reference(name):
    rng = np.random.RandomState(3)
    a, b, c = (rng.normal(size=(4, 6)).astype(np.float32) for _ in range(3))
    label = rng.choice([-1.0, 1.0], 4).astype(np.float32)
    outs = []
    for pkg in (tmx, jmx):
        kw = dict(ctx=CPU) if pkg is tmx else {}
        x, y = pkg.nd.array(a, **kw), pkg.nd.array(b, **kw)
        x.attach_grad()
        y.attach_grad()
        L = pkg.gluon.loss
        with pkg.autograd.record():
            if name == "triplet":
                loss = L.TripletLoss(margin=0.5)(x, y, pkg.nd.array(c, **kw))
            else:
                # the reference's forward takes input2 for both inputs
                # (``_reshape_like(F, input1, input2)``): so does the port
                loss = L.CosineEmbeddingLoss(margin=0.2)(
                    x, y, pkg.nd.array(label, **kw))
        loss.backward()
        outs.append((loss.asnumpy(), x.grad.asnumpy(), y.grad.asnumpy()))
    for g, r in zip(*outs):
        np.testing.assert_allclose(g, r, **TOL)
    # CTCLoss is ported in slice 14 (tests/test_torch_ctc.py)
    assert isinstance(tmx.gluon.loss.CTCLoss(), tmx.gluon.loss.Loss)


def test_initializers():
    init = tmx.init
    with tmx.cpu():
        tmx.random.seed(5)
        for name, shape in (("bilinear", (2, 1, 4, 4)), ("lstm", (16,))):
            ini = init.Bilinear() if name == "bilinear" else \
                init.LSTMBias(forget_bias=2.0)
            ref_ini = jmx.init.Bilinear() if name == "bilinear" else \
                jmx.init.LSTMBias(forget_bias=2.0)
            arr = tmx.nd.zeros(shape)
            jarr = jmx.nd.zeros(shape)
            ini(f"x_{'weight' if name == 'bilinear' else 'bias'}", arr)
            ref_ini(f"x_{'weight' if name == 'bilinear' else 'bias'}", jarr)
            np.testing.assert_allclose(arr.asnumpy(), jarr.asnumpy(),
                                       rtol=1e-6)
        w = tmx.nd.zeros((6, 10))
        init.Orthogonal(scale=1.5)("q_weight", w)
        q = w.asnumpy()
        np.testing.assert_allclose(q @ q.T, 2.25 * np.eye(6), atol=1e-5)
        big = tmx.nd.zeros((256, 128, 3, 3))
        init.MSRAPrelu(slope=0.0)("c_weight", big)
        fan = (128 * 9 + 256 * 9) / 2.0
        assert abs(big.asnumpy().std() / np.sqrt(2.0 / fan) - 1) < 0.02
        for pkg in (tmx, jmx):
            mixed = pkg.init.Mixed(["fc.*", ".*"],
                                   [pkg.init.Constant(0.3), pkg.init.One()])
            arrs = [pkg.nd.zeros((2, 2)) for _ in range(3)]
            for name, a in zip(("fc_weight", "fc_bias", "bn_gamma"), arrs):
                mixed(name, a)
            # a bias is zeroed by the initializer's name rule, as in the
            # reference
            assert [float(a.asnumpy()[0, 0]) for a in arrs] == \
                pytest.approx([0.3, 0.0, 1.0])
        with pytest.raises(tmx.MXNetError, match="pattern"):
            init.Mixed(["a.*"], [init.One()])("b", tmx.nd.zeros((2,)))

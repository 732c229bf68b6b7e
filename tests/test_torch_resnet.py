"""ResNet of the PyTorch/CUDA port against the JAX package: inference
through the fused 1×1 conv + BatchNorm + ReLU, and the training step.

Each net is built in both packages and given the same weights, drawn
with numpy from a seed (with nonzero moving means and positive moving
variances) and carried across by structural name
(``convert.load_numpy_params`` on the port's side, ``set_data`` on the
JAX side).  The JAX references are computed once per module.  The port
runs on the CPU, where the fused path takes the kernel's plain version.
Everything is f32.
"""
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.ops import conv_bn_relu as cbr

CPU = tmx.cpu()
NARROW = ([1, 1, 1, 1], [8, 32, 64, 128, 256])
SGD = {"learning_rate": 0.05, "momentum": 0.9}
STATS = ("running_mean", "running_var")
# a conv bias that a batch-normalizing BatchNorm follows has gradient 0 in
# exact arithmetic (the BatchNorm subtracts the batch mean): both packages
# give f32 rounding noise there
ZERO_GRAD = re.compile(r"body\.[06]\.bias$")


def _narrow(pkg):
    return pkg.ResNetV1(pkg.BottleneckV1, *NARROW, classes=10)


def _arrays(net, x_shape, seed):
    """Random weights for the port net ``net`` (its shapes resolved by a
    forward on zeros), as {structural name: np.ndarray}."""
    net.initialize(ctx=CPU)
    net(tmx.nd.zeros(x_shape, ctx=CPU))
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in net._collect_params_with_prefix().items():
        shape = p.shape
        if name.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            a = rng.normal(size=shape) * np.sqrt(2.0 / fan_in)
        elif name.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("gamma"):
            a = rng.uniform(0.7, 1.3, shape)
        else:  # conv and dense biases, beta, running_mean
            a = rng.normal(0.0, 0.1, shape)
        out[name] = a.astype(np.float32)
    return out


def _jax_net(jnet, arrays):
    jnet.initialize()
    params = jnet._collect_params_with_prefix()
    assert params.keys() == arrays.keys()
    for name, p in params.items():
        p.set_data(jmx.nd.array(arrays[name]))
    return jnet


def _port_net(tnet, arrays):
    load_numpy_params(tnet, arrays, ctx=CPU)
    return tnet


def _jax_step(jnet, x, y):
    """One recorded forward, backward and SGD-momentum step of the JAX
    net: (loss, gradients, parameters and moving statistics after)."""
    trainer = jgluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
    with jautograd.record():
        loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(jmx.nd.array(x)), jmx.nd.array(y))
    loss.backward()
    params = jnet._collect_params_with_prefix()
    grads = {k: p.grad().asnumpy() for k, p in params.items()
             if p.grad_req != "null"}
    trainer.step(x.shape[0])
    return (float(loss.mean().asscalar()), grads,
            {k: p.data().asnumpy() for k, p in params.items()})


def _port_step(tnet, x, y):
    trainer = tmx.gluon.Trainer(tnet.collect_params(), "sgd", dict(SGD))
    with tautograd.record():
        loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
            tnet(tmx.nd.array(x, ctx=CPU)), tmx.nd.array(y, ctx=CPU))
    loss.backward()
    params = tnet._collect_params_with_prefix()
    grads = {k: p.grad().asnumpy() for k, p in params.items()
             if p.grad_req != "null"}
    trainer.step(x.shape[0])
    return (float(loss.mean().asscalar()), grads,
            {k: p.data().asnumpy() for k, p in params.items()})


@pytest.fixture(scope="module")
def narrow():
    """The narrow net's weights, and the JAX package's inference logits
    (B=2, 32×32) and one training step (B=2, 64×64) from those weights.

    The training input is 64×64 so that the last stage's BatchNorms see 8
    values a channel: at 32×32 they see 2, their output is ±d/√(d² + ε)
    whatever the input, and every gradient upstream of them is driven by
    ε alone, so that f32 rounding order changes it by 5e-4."""
    arrays = _arrays(_narrow(tresnet), (1, 3, 32, 32), seed=0)
    rng = np.random.RandomState(1)
    x = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    x_train = rng.normal(size=(2, 3, 64, 64)).astype(np.float32)
    y = np.array([3, 7], np.float32)
    jnet = _jax_net(_narrow(jresnet), arrays)
    logits = jnet(jmx.nd.array(x)).asnumpy()
    return dict(arrays=arrays, x=x, x_train=x_train, y=y, logits=logits,
                step=_jax_step(jnet, x_train, y))


def test_narrow_inference_matches_through_the_fused_path(narrow):
    """B=2, 32×32: the logits within 1e-4 of the largest logit, with one
    fused call per bottleneck."""
    tnet = _port_net(_narrow(tresnet), narrow["arrays"])
    before = cbr.conv1x1_bn_relu.calls
    got = tnet(tmx.nd.array(narrow["x"], ctx=CPU)).asnumpy()
    assert cbr.conv1x1_bn_relu.calls - before == 4
    ref = narrow["logits"]
    assert got.shape == ref.shape == (2, 10) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def _assert_step_matches(ref, got, arrays, stats_tol):
    """The loss within 1e-5.  Each gradient within 1e-4 of the largest
    value of the same reference tensor: the BatchNorm backward subtracts
    the batch means of dy and dy·x̂, and that cancellation lifts the f32
    summation-order differences of the two packages to about 2.5e-5 in the
    worst tensor (the stem BatchNorm's beta); a gradient that is 0 in exact
    arithmetic (``ZERO_GRAD``) within 1e-5 of the net's largest gradient.
    Each updated parameter within 1e-5 of its tensor's largest value, and
    the moving statistics (moved by the step's batch statistics) within
    ``stats_tol``."""
    (jloss, jgrads, jparams), (tloss, tgrads, tparams) = ref, got
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert tgrads.keys() == jgrads.keys()
    assert not any(k.endswith(STATS) for k in tgrads)
    largest = max(np.abs(g).max() for g in jgrads.values())
    for name, g in jgrads.items():
        assert tgrads[name].dtype == np.float32
        if ZERO_GRAD.search(name):
            assert np.abs(tgrads[name]).max() <= 1e-5 * largest, name
            assert np.abs(g).max() <= 1e-5 * largest, name
            continue
        assert np.abs(tgrads[name] - g).max() <= 1e-4 * np.abs(g).max(), \
            name
    moved = 0
    for name, p in jparams.items():
        tol = stats_tol if name.endswith(STATS) else 1e-5
        assert np.abs(tparams[name] - p).max() <= tol * np.abs(p).max(), \
            name
        moved += not np.array_equal(p, arrays[name])
    # every parameter and statistic moved, but a ZERO_GRAD bias may not
    noise = sum(bool(ZERO_GRAD.search(k)) for k in jparams)
    assert len(jparams) - noise <= moved <= len(jparams)


def test_narrow_training_step_matches(narrow):
    """One recorded step of the narrow net with SGD momentum and
    ``SoftmaxCrossEntropyLoss``: BatchNorm normalizes by the batch (no
    fused call), the trainer skips the moving statistics, and the layer
    moves them as 0.9·old + 0.1·batch with the population variance."""
    tnet = _port_net(_narrow(tresnet), narrow["arrays"])
    before = cbr.conv1x1_bn_relu.calls
    got = _port_step(tnet, narrow["x_train"], narrow["y"])
    assert cbr.conv1x1_bn_relu.calls == before
    _assert_step_matches(narrow["step"], got, narrow["arrays"], 1e-6)


def test_resnet18_thumbnail_step_matches():
    """The one-step body of ``_dryrun_multichip_impl`` on one device:
    ``resnet18_v1(classes=8, thumbnail=True)``, B=2, SGD momentum.  The
    input is 16×16, not the dry run's 8×8: at 8×8 the last stage's
    BatchNorms see 2 values a channel (see ``narrow``) and f32 rounding
    moves even the loss by 3e-4; at 32×32 one input of the last ReLU lies
    1.1e-5 from 0, within the packages' f32 differences, and its kink
    moves the gradients by 2%."""
    arrays = _arrays(tvision.resnet18_v1(classes=8, thumbnail=True),
                     (1, 3, 8, 8), seed=2)
    x = np.random.RandomState(3).uniform(size=(2, 3, 16, 16)).astype(
        np.float32)
    y = (np.arange(2) % 8).astype(np.float32)
    jnet = _jax_net(jresnet.resnet18_v1(classes=8, thumbnail=True), arrays)
    ref = _jax_step(jnet, x, y)
    tnet = _port_net(tvision.resnet18_v1(classes=8, thumbnail=True), arrays)
    # the statistics within 2e-6: 16 convolutions deep, the batch
    # statistics of the last stage (8 values a channel) differ by up to
    # 1.6e-6 between the packages' f32 summation orders
    _assert_step_matches(ref, _port_step(tnet, x, y), arrays, 2e-6)


def test_get_model_and_pretrained():
    for depth in (18, 34, 50, 101, 152):
        for version in (1, 2):
            net = tvision.get_model(f"resnet{depth}_v{version}", classes=4)
            assert isinstance(net, (tresnet.ResNetV1, tresnet.ResNetV2))
    for name in ("vgg16", "alexnet", "densenet121", "squeezenet1.0",
                 "inceptionv3", "mobilenet1.0", "mobilenetv2_1.0"):
        assert isinstance(tvision.get_model(name, classes=4),
                          tmx.gluon.HybridBlock)
    with pytest.raises(tmx.MXNetError, match="not found"):
        tvision.get_model("resnet99_v1")
    with pytest.raises(tmx.MXNetError, match="pretrained"):
        tvision.resnet50_v1(pretrained=True)
    nn = tmx.gluon.nn
    for layer in (nn.Conv1D(4, 3), nn.Conv2DTranspose(4, 3),
                  nn.GlobalMaxPool2D(), nn.MaxPool3D()):
        assert isinstance(layer, tmx.gluon.HybridBlock)


def test_cast_keeps_batch_norm_f32_and_trains_in_bf16():
    """Under ``cast("bfloat16")`` convs and dense layers are bf16 and the
    BatchNorm parameters stay f32; a recorded step keeps activations and
    their gradients in bf16 and moves the f32 statistics."""
    tmx.random.seed(0)
    net = tvision.resnet18_v1(classes=8, thumbnail=True)
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net(tmx.nd.zeros((1, 3, 8, 8), ctx=CPU))
    net.cast("bfloat16")
    params = net._collect_params_with_prefix()
    for name, p in params.items():
        want = torch.float32 if name.endswith(
            ("gamma", "beta") + STATS) else torch.bfloat16
        assert p.data().dtype == want, name
    stats = {k: p.data().asnumpy() for k, p in params.items()
             if k.endswith(STATS)}
    x = tmx.nd.array(np.random.RandomState(4).uniform(
        size=(2, 3, 8, 8)), ctx=CPU, dtype="bfloat16")
    with tautograd.record():
        out = net(x)
        loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
            out, tmx.nd.array([1.0, 5.0], ctx=CPU))
    loss.backward()
    assert out.dtype == torch.bfloat16
    assert params["features.1.0.body.1.gamma"].grad().dtype == torch.float32
    assert params["features.0.weight"].grad().dtype == torch.bfloat16
    for k, v in stats.items():
        moved = params[k].data()
        assert moved.dtype == torch.float32
        assert not np.array_equal(moved.asnumpy(), v), k


def test_load_numpy_params_carries_the_moving_statistics(narrow):
    """The JAX names (``features.4.0.body.0.bias``,
    ``features.1.running_var``) land in the port's parameters, the moving
    statistics included, and those have no gradient."""
    tnet = _port_net(_narrow(tresnet), narrow["arrays"])
    params = tnet._collect_params_with_prefix()
    for name in ("features.4.0.body.0.bias", "features.1.running_var",
                 "features.1.running_mean", "features.4.0.body.1.gamma",
                 "output.weight"):
        np.testing.assert_array_equal(params[name].data().asnumpy(),
                                      narrow["arrays"][name])
    for name in ("features.1.running_var", "features.1.running_mean"):
        assert params[name].grad_req == "null"
        params[name].grad_req = "write"  # not differentiable: stays null
        assert params[name].grad_req == "null"
        with pytest.raises(tmx.MXNetError, match="null"):
            params[name].grad()
    assert len(params) == len(narrow["arrays"])


@pytest.mark.parametrize("kw", [
    dict(pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    dict(pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
         pooling_convention="full"),
    dict(pool_type="avg", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
         pooling_convention="full"),
    dict(pool_type="avg", kernel=(2, 2), stride=(2, 2), pad=(1, 1),
         count_include_pad=False),
    dict(pool_type="avg", global_pool=True),
    dict(pool_type="max", global_pool=True),
])
def test_pooling_matches_jax(kw):
    """``MaxPool2D(3, 2, 1)`` pads with −inf (the inputs are all
    negative, so a zero pad would show) and floors; ``full`` ceils;
    ``count_include_pad=False`` divides by the covered inputs; the global
    pools keep (B, C, 1, 1).  f32: 1e-6."""
    x = -np.random.RandomState(5).uniform(0.5, 2.0, (2, 3, 9, 9)).astype(
        np.float32)
    ref = jmx.nd.Pooling(jmx.nd.array(x), **kw).asnumpy()
    got = tmx.nd.pooling(tmx.nd.array(x, ctx=CPU), **kw).asnumpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6


def test_batch_norm_training_dtypes_match_jax():
    """Training BatchNorm on bf16 activations with f32 parameters: y and
    dx come out bf16 (one bf16 rounding of f32 results that may differ in
    their last bits: 2^-7 of each value), dgamma and dbeta f32 (1e-5 of
    the largest), the moved statistics f32 (1e-6)."""
    rng = np.random.RandomState(6)
    x = (rng.normal(size=(4, 6, 5, 5)) * 2 + 0.5).astype(np.float32)
    w = rng.normal(size=(4, 6, 5, 5)).astype(np.float32)
    g, b = rng.uniform(0.5, 1.5, 6), rng.normal(0, 0.3, 6)
    mm, mv = rng.normal(0, 0.3, 6), rng.uniform(0.5, 1.5, 6)
    out = {}
    for name, pkg, ag, kw in (("jax", jmx, jautograd, {}),
                              ("port", tmx, tautograd, {"ctx": CPU})):
        xs = pkg.nd.array(x, **kw).astype("bfloat16")
        ws = pkg.nd.array(w, **kw).astype("bfloat16")
        gs, bs = (pkg.nd.array(a.astype(np.float32), **kw) for a in (g, b))
        for a in (xs, gs, bs):
            a.attach_grad()
        stats = [pkg.nd.array(a.astype(np.float32), **kw) for a in (mm, mv)]
        with ag.record():
            y, new_mm, new_mv = pkg.nd.BatchNorm(xs, gs, bs, *stats,
                                                 eps=1e-5, momentum=0.9)
            loss = (y * ws).sum()
        loss.backward()
        assert str(y.dtype).endswith("bfloat16"), name
        assert str(xs.grad.dtype).endswith("bfloat16"), name
        assert str(gs.grad.dtype).endswith("float32"), name
        out[name] = [a.asnumpy().astype(np.float32) for a in
                     (y, xs.grad, gs.grad, bs.grad, new_mm, new_mv)]
    for i, (r, t) in enumerate(zip(out["jax"], out["port"])):
        if i < 2:
            tol = 2.0 ** -7 * np.abs(r)
        else:
            tol = (1e-5 if i < 4 else 1e-6) * np.abs(r).max()
        assert np.all(np.abs(t - r) <= tol), i

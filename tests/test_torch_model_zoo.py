"""The vision model zoo of the PyTorch/CUDA port against the JAX package.

- ``get_model`` resolves every name the reference's resolves, and each
  net's structural parameter names (``_collect_params_with_prefix``) and
  declared shapes equal the reference's.
- Inference forwards (no recording, so every 1×1 Conv2D → BatchNorm →
  ReLU run takes the fused path: its plain version on the CPU) match the
  reference's on the same weights, drawn with numpy from a seed (moving
  means and variances away from 0 and 1) and set by structural name:
  ``mobilenet0.25`` and ``mobilenetv2_0.25`` at 64 px, ``squeezenet1.1``
  at 64, ``vgg11_bn`` at 32, ``alexnet`` at 63 (the smallest input it
  takes), a two-block DenseNet at 56; and Inception v3's stem and its
  blocks A-E at their real channels on small spatial sizes (the whole
  net needs 299 px: its last pool is 8×8; the card's ``chip_smoke.py``
  checks it there).  Dropout is the identity outside training.
- f32, ``rtol=1e-4`` of the output's largest value (convolutions sum in
  other orders in the two packages).  The reference runs hybridized (one
  jit of its forward, from the weights' shapes), which XLA compiles far
  faster on the CPU than the net's eager ops one by one.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.model_zoo.vision import inception as jinception

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.model_zoo.vision import inception as tinception
from mxnet_tpu_torch.ops import conv_bn_relu as cbr

CPU = tmx.cpu()
REF_NAMES = ["resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
             "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
             "resnet101_v2", "resnet152_v2", "vgg11", "vgg13", "vgg16",
             "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
             "alexnet", "densenet121", "densenet161", "densenet169",
             "densenet201", "squeezenet1.0", "squeezenet1.1", "inceptionv3",
             "mobilenet1.0", "mobilenet0.75", "mobilenet0.5",
             "mobilenet0.25", "mobilenetv2_1.0", "mobilenetv2_0.75",
             "mobilenetv2_0.5", "mobilenetv2_0.25"]


def _structure(net):
    return {k: tuple(p.shape) for k, p in
            net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("name", REF_NAMES)
def test_get_model_resolves_with_the_reference_structure(name):
    ref = jvision.get_model(name, classes=7)
    got = tvision.get_model(name, classes=7)
    assert _structure(got) == _structure(ref)
    assert type(got).__name__ == type(ref).__name__


def test_every_reference_name_is_listed():
    # the reference's get_model table, read off its error message
    with pytest.raises(jmx.MXNetError) as ref_err:
        jvision.get_model("no_such_net")
    with pytest.raises(tmx.MXNetError) as got_err:
        tvision.get_model("no_such_net")
    assert str(got_err.value) == str(ref_err.value)
    assert sorted(REF_NAMES) == sorted(tvision._MODELS)


def _arrays(net, x_shape, seed):
    """Random weights of the port net ``net`` by structural name (shapes
    resolved by a forward on zeros)."""
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
        else:  # biases, beta, running_mean
            a = rng.normal(0.0, 0.1, shape)
        out[name] = a.astype(np.float32)
    return out


def _compare(make, x_shape, seed, fused):
    """The port's inference forward (``fused`` fused calls) against the
    reference's on the same weights and input."""
    arrays = _arrays(make(tmx), x_shape, seed)
    x = np.random.RandomState(seed + 1).uniform(
        -1, 1, x_shape).astype(np.float32)
    tnet = make(tmx)
    load_numpy_params(tnet, arrays, ctx=CPU)
    before = cbr.conv1x1_bn_relu.calls
    got = tnet(tmx.nd.array(x, ctx=CPU)).asnumpy()
    assert cbr.conv1x1_bn_relu.calls - before == fused
    jnet = make(jmx)
    jnet.initialize(init=jmx.init.Zero())  # no random draw to compile
    params = jnet._collect_params_with_prefix()
    assert sorted(params) == sorted(arrays)
    for k, p in params.items():  # finishes each deferred init
        p.set_data(jmx.nd.array(arrays[k]))
    # one jit of the whole forward: XLA compiles it once instead of
    # compiling each eager op of the net
    jnet.hybridize()
    ref = jnet(jmx.nd.array(x)).asnumpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def _vision(pkg):
    return jvision if pkg is jmx else tvision


NETS = [
    ("mobilenet0.25", lambda p: _vision(p).get_model(
        "mobilenet0.25", classes=10), (2, 3, 64, 64), 13),
    ("mobilenetv2_0.25", lambda p: _vision(p).get_model(
        "mobilenetv2_0.25", classes=10), (2, 3, 64, 64), 0),
    ("squeezenet1.1", lambda p: _vision(p).get_model(
        "squeezenet1.1", classes=10), (2, 3, 64, 64), 0),
    ("vgg11_bn", lambda p: _vision(p).get_model("vgg11_bn", classes=10),
     (1, 3, 32, 32), 0),
    ("alexnet", lambda p: _vision(p).get_model("alexnet", classes=10),
     (1, 3, 63, 63), 0),
    ("densenet_two_blocks", lambda p: _vision(p).DenseNet(
        32, 16, [2, 3], bn_size=2, classes=10), (2, 3, 56, 56), 5),
]


@pytest.mark.parametrize("name,make,shape,fused", NETS,
                         ids=[n[0] for n in NETS])
def test_inference_forward_matches_reference(name, make, shape, fused):
    _compare(make, shape, len(name), fused)


def _inc(pkg):
    return jinception if pkg is jmx else tinception


def _stem(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="")
    full = _inc(pkg).Inception3(classes=10)
    for block in list(full.features)[:7]:
        net.add(block)
    return net


INCEPTION = [
    ("stem", _stem, (2, 3, 35, 35), 1),
    ("A", lambda p: _inc(p)._make_A(32, "A1_"), (2, 192, 5, 5), 4),
    ("B", lambda p: _inc(p)._make_B("B_"), (2, 288, 7, 7), 1),
    ("C", lambda p: _inc(p)._make_C(128, "C1_"), (2, 768, 5, 5), 4),
    ("D", lambda p: _inc(p)._make_D("D_"), (2, 768, 5, 5), 2),
    ("E", lambda p: _inc(p)._make_E("E2_"), (2, 2048, 3, 3), 4),
]


@pytest.mark.parametrize("name,make,shape,fused", INCEPTION,
                         ids=[n[0] for n in INCEPTION])
def test_inception_blocks_match_reference(name, make, shape, fused):
    """Each block's 1×1 runs fuse at BatchNorm eps 0.001 (40 a forward of
    the whole net: 1 in the stem, 4 in each A, 1 in B, 4 in each C, 2 in
    D, 4 in each E)."""
    _compare(make, shape, 100 + len(name), fused)

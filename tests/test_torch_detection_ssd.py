"""SSD of the PyTorch/CUDA port against the JAX package, and the
detection zoo's names.

``ssd_300_resnet18_v1`` (3 classes) at the reference tests' 96×96 is
built in both packages with the same weights: drawn with numpy from a
seed (He-normal convolutions, nonzero moving means, positive moving
variances) and carried across by structural name
(``convert.load_numpy_params`` on the port's side, ``set_data`` on the
JAX side; the backbone slice ``feats[:stop]`` keeps the same names in
both).  The JAX net is run hybridized (one compile a mode).  The batch
is 4: the last two pyramid levels are 1×1 maps, whose training-mode
BatchNorms see B values a channel, and at B = 2 f32 rounding of their
difference moves the outputs by 1e-3.

Compared: the training-mode outputs (class and box predictions,
anchors) within 1e-4 of each output's largest magnitude
(``assert_close``); the inference outputs, ids exactly and scores and
boxes within the same; and the reference's own pre-NMS rows
(its ``box_nms`` replaced by the identity while a second net is traced)
through both packages' ``box_nms``, which must agree exactly.  The port
runs on the CPU, where NMS takes the scan's plain version.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.ndarray.contrib as jnd_contrib
import mxnet_tpu.ops.contrib as jops_contrib
from mxnet_tpu.gluon.model_zoo import detection as jdet

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.gluon.model_zoo import detection as tdet

CPU = tmx.cpu()


def det_arrays(net, x, seed, gain=2.0):
    """Random weights for the port net ``net`` (its shapes resolved by a
    forward on ``x``), as {structural name: np.ndarray}: convolutions
    normal with variance ``gain / fan_in`` (He's for 2)."""
    net.initialize(ctx=CPU)
    net(tmx.nd.array(x, ctx=CPU))
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in net._collect_params_with_prefix().items():
        shape = p.shape
        if name.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            a = rng.normal(size=shape) * np.sqrt(gain / fan_in)
        elif name.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("gamma"):
            a = rng.uniform(0.7, 1.3, shape)
        else:  # conv and dense biases, beta, running_mean
            a = rng.normal(0.0, 0.1, shape)
        out[name] = a.astype(np.float32)
    load_numpy_params(net, out, ctx=CPU)
    return out


def jax_net(make, arrays):
    """The JAX net of ``make()`` with ``arrays`` set (no random draw:
    ``Zero`` then ``set_data``), hybridized."""
    net = make()
    net.initialize(jmx.init.Zero())
    params = net._collect_params_with_prefix()
    assert params.keys() == arrays.keys()
    for name, p in params.items():
        p.set_data(jmx.nd.array(arrays[name]))
    net.hybridize()
    return net


def outputs(pkg, net, x, train=False):
    nd_x = pkg.nd.array(x, ctx=CPU) if pkg is tmx else pkg.nd.array(x)
    if train:
        with pkg.autograd.train_mode():
            out = net(nd_x)
    else:
        out = net(nd_x)
    return [np.asarray(o.asnumpy(), np.float32) for o in out]


def pre_nms_rows(make, arrays, x, post_attr):
    """The reference's rows as its ``box_nms`` receives them: a second JAX
    net, traced with ``box_nms`` made the identity and its post-NMS slice
    widened to every row, returns them as (ids, scores, boxes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops_contrib, "box_nms", lambda data, **kw: data)
        mp.setattr(jnd_contrib, "box_nms", lambda data, **kw: data)
        net = jax_net(make, arrays)
        setattr(net, post_attr, 1 << 30)
        ids, scores, boxes = outputs(jmx, net, x)
    return np.concatenate([ids, scores, boxes], axis=-1)


def assert_close(got, ref, tol=1e-4):
    """Within ``tol`` of the output's largest magnitude (at least 1): the
    deep nets' f32 convolutions sum in other orders in the two
    packages, and their rounding grows with the activations' scale."""
    assert got.shape == ref.shape
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def assert_detections_match(ref, got):
    """ids exactly, scores and boxes within 1e-4 (``assert_close``)."""
    for r, g in zip(ref, got):
        assert r.shape == g.shape
    np.testing.assert_array_equal(got[0], ref[0])
    assert_close(got[1], ref[1])
    assert_close(got[2], ref[2])


def assert_nms_identical(rows, **kw):
    ref = jmx.nd.contrib.box_nms(jmx.nd.array(rows), **kw).asnumpy()
    got = tmx.nd.contrib.box_nms(tmx.nd.array(rows, ctx=CPU), **kw) \
        .asnumpy()
    np.testing.assert_array_equal(got, np.asarray(ref, np.float32))
    assert (got[..., 0] >= 0).any()


def _jssd():
    return jdet.ssd_300_resnet18_v1(classes=3)


@pytest.fixture(scope="module")
def ssd():
    x = np.random.RandomState(0).rand(4, 3, 96, 96).astype(np.float32)
    tnet = tdet.ssd_300_resnet18_v1(classes=3)
    arrays = det_arrays(tnet, x, seed=1)
    jnet = jax_net(_jssd, arrays)
    return dict(x=x, tnet=tnet, jnet=jnet, arrays=arrays)


def test_ssd_training_mode_outputs_match(ssd):
    ref = outputs(jmx, ssd["jnet"], ssd["x"], train=True)
    got = outputs(tmx, ssd["tnet"], ssd["x"], train=True)
    n = got[2].shape[1]
    assert [g.shape for g in got] == [(4, n, 4), (4, n, 4), (1, n, 4)]
    for r, g in zip(ref, got):
        assert_close(g, r)


def test_ssd_inference_outputs_match(ssd):
    ref = outputs(jmx, ssd["jnet"], ssd["x"])
    got = outputs(tmx, ssd["tnet"], ssd["x"])
    assert_detections_match(ref, got)
    assert (got[0] >= 0).any() and (got[0] == -1).any()


def test_ssd_nms_of_reference_pre_nms_rows_is_identical(ssd):
    rows = pre_nms_rows(_jssd, ssd["arrays"], ssd["x"], "post_nms")
    net = ssd["tnet"]
    assert_nms_identical(rows, overlap_thresh=net.nms_thresh,
                         valid_thresh=0.0, topk=net.nms_topk, coord_start=2,
                         score_index=1, id_index=0)


def test_ssd_hybridized_matches_eager_on_cpu(ssd):
    net = ssd["tnet"]
    eager = outputs(tmx, net, ssd["x"])
    net.hybridize()
    try:
        for _ in range(2):
            hybrid = outputs(tmx, net, ssd["x"])
            for e, h in zip(eager, hybrid):
                np.testing.assert_array_equal(h, e)
    finally:
        net.hybridize(False)


def test_ssd_training_step_with_multibox_target(ssd):
    """The loss of ``tests/test_detection_models.py``'s SSD step, one SGD
    step: finite loss and gradients, and the matched anchors' targets."""
    net = tdet.ssd_300_resnet18_v1(classes=3)
    load_numpy_params(net, ssd["arrays"], ctx=CPU)
    x = tmx.nd.array(ssd["x"], ctx=CPU)
    label = tmx.nd.array([[[0.0, 0.2, 0.2, 0.7, 0.7], [-1] * 5],
                          [[2.0, 0.1, 0.5, 0.4, 0.9], [1.0, 0.5, 0.1, 0.9,
                                                       0.6]]] * 2, ctx=CPU)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.01})
    with tmx.autograd.record():
        cls_p, box_p, anchors = net(x)
        loc_t, loc_m, cls_t = tmx.nd.contrib.MultiBoxTarget(
            anchors, label, tmx.nd.transpose(cls_p, axes=(0, 2, 1)),
            negative_mining_ratio=3)
        # negative mining marks the anchors it drops -1: no class loss
        logp = tmx.nd.log_softmax(cls_p, axis=-1)
        cls_loss = -tmx.nd.pick(logp, tmx.nd.maximum(cls_t, 0), axis=-1) \
            * (cls_t >= 0)
        loc_loss = (tmx.nd.abs(box_p.reshape((4, -1)) - loc_t) *
                    loc_m).sum()
        loss = cls_loss.sum() + loc_loss
    loss.backward()
    trainer.step(4)
    assert np.isfinite(loss.asscalar())
    ct = cls_t.asnumpy()
    assert (ct > 0).sum(1).min() >= 1 and (ct == -1).any()
    for p in net.collect_params().values():
        if p.grad_req != "null":
            assert np.isfinite(p.grad().asnumpy()).all(), p.name


@pytest.mark.parametrize("name", ["ssd_300_resnet18_v1",
                                  "ssd_512_resnet50_v1", "yolo3_darknet53",
                                  "darknet53", "faster_rcnn_resnet50_v1"])
def test_get_model_builds_every_name(name):
    tnet = tdet.get_model(name, classes=4)
    jnet = jdet.get_model(name, classes=4)
    assert type(tnet).__name__ == type(jnet).__name__
    tnet.initialize(ctx=CPU)
    jnet.initialize(jmx.init.Zero())
    # the same structural names, backbone slices included
    assert sorted(tnet._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())
    with pytest.raises(tmx.MXNetError, match="not found"):
        tdet.get_model("ssd_1024")

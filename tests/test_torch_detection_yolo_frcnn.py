"""YOLOv3 and Faster R-CNN of the PyTorch/CUDA port against the JAX
package, as ``test_torch_detection_ssd.py`` holds SSD (its helpers, its
weights recipe and its tolerances).

``yolo3_darknet53`` (3 classes) at the reference tests' 64×64, B=2, and
``faster_rcnn_resnet50_v1`` (3 classes, ``rpn_post_nms=8``) at 96×96,
B=2 (one ROIAlign batch of 16 proposals).  Their convolutions are drawn
with variance 1 / fan_in: with He's 2 / fan_in the inference-mode
activations of these deeper nets (random moving statistics do not
renormalize them) grow until ``exp`` of the box sizes overflows.  The
RPN's box-delta head is drawn 10× smaller again: ``exp`` turns the
deltas' absolute rounding into a relative error of the proposals' sizes,
and deltas near 5 (the 1 / fan_in draw) blow 1e-5 up to 1e-4.
Compared: the training-mode outputs within 1e-4 of each output's largest
magnitude (Faster R-CNN's proposals included; its box head's two
outputs within 5e-4, as its test says why); the inference outputs,
ids exactly and scores and boxes within the same; and
the reference's own pre-NMS rows through both packages' ``box_nms``,
exactly.  Each JAX net is built once for the module.
"""
import numpy as np
import pytest

from mxnet_tpu.gluon.model_zoo import detection as jdet

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.gluon.model_zoo import detection as tdet

from test_torch_detection_ssd import (assert_close,  # noqa: E402
                                      assert_detections_match,
                                      assert_nms_identical, det_arrays,
                                      jax_net, outputs, pre_nms_rows)


def _jyolo():
    return jdet.yolo3_darknet53(classes=3)


def _jfrcnn():
    return jdet.faster_rcnn_resnet50_v1(classes=3, rpn_post_nms=8)


@pytest.fixture(scope="module")
def yolo():
    x = np.random.RandomState(2).rand(2, 3, 64, 64).astype(np.float32)
    tnet = tdet.yolo3_darknet53(classes=3)
    arrays = det_arrays(tnet, x, seed=3, gain=1.0)
    return dict(x=x, tnet=tnet, jnet=jax_net(_jyolo, arrays), arrays=arrays)


@pytest.fixture(scope="module")
def frcnn():
    x = np.random.RandomState(4).rand(2, 3, 96, 96).astype(np.float32)
    tnet = tdet.faster_rcnn_resnet50_v1(classes=3, rpn_post_nms=8)
    arrays = det_arrays(tnet, x, seed=5, gain=1.0)
    for name in ("rpn.loc.weight", "rpn.loc.bias"):
        arrays[name] *= 0.1
    load_numpy_params(tnet, arrays, ctx=tmx.cpu())
    return dict(x=x, tnet=tnet, jnet=jax_net(_jfrcnn, arrays),
                arrays=arrays)


def _fresh(jnet):
    """The reference YOLO with its grid caches emptied: a hybridized JAX
    YOLO caches its grid tensors while it is traced, so a second trace
    (the other mode) would find the first one's tracers."""
    for blk in jnet.outputs:
        blk._grid_cache.clear()
    return jnet


def test_yolo_training_mode_outputs_match(yolo):
    ref = outputs(jmx, _fresh(yolo["jnet"]), yolo["x"], train=True)
    got = outputs(tmx, yolo["tnet"], yolo["x"], train=True)
    n = (64 + 16 + 4) * 3  # /8 /16 /32 cells x 3 anchors
    assert [g.shape for g in got] == [(2, n, 8), (2, n, 4), (2, n, 3)]
    for r, g in zip(ref, got):
        assert_close(g, r)


def test_yolo_inference_outputs_match(yolo):
    ref = outputs(jmx, _fresh(yolo["jnet"]), yolo["x"])
    got = outputs(tmx, yolo["tnet"], yolo["x"])
    assert_detections_match(ref, got)
    assert (got[0] >= 0).any()


def test_yolo_nms_of_reference_pre_nms_rows_is_identical(yolo):
    rows = pre_nms_rows(_jyolo, yolo["arrays"], yolo["x"], "post_nms")
    net = yolo["tnet"]
    assert_nms_identical(rows, overlap_thresh=net.nms_thresh,
                         valid_thresh=0.01, topk=net.nms_topk, coord_start=2,
                         score_index=1, id_index=0)


def test_frcnn_training_mode_outputs_match(frcnn):
    ref = outputs(jmx, frcnn["jnet"], frcnn["x"], train=True)
    got = outputs(tmx, frcnn["tnet"], frcnn["x"], train=True)
    assert [g.shape for g in got[:3]] == [(16, 5), (16, 4), (16, 4)]
    # the box head's outputs (1, 2) also carry the proposals' rounding
    # (ROIAlign samples where the proposals say) through stage 4's ten
    # training-mode BatchNorms: 5e-4 (1.3e-4 measured); the rest 1e-4
    for i, (r, g) in enumerate(zip(ref, got)):
        assert_close(g, r, 5e-4 if i in (1, 2) else 1e-4)


def test_frcnn_inference_outputs_match(frcnn):
    ref = outputs(jmx, frcnn["jnet"], frcnn["x"])
    got = outputs(tmx, frcnn["tnet"], frcnn["x"])
    assert got[0].shape == (2, 8, 1) and got[2].shape == (2, 8, 4)
    assert_detections_match(ref, got)


def test_frcnn_nms_of_reference_pre_nms_rows_is_identical(frcnn):
    rows = pre_nms_rows(_jfrcnn, frcnn["arrays"], frcnn["x"], "_post")
    net = frcnn["tnet"]
    assert_nms_identical(rows, overlap_thresh=net._nms, valid_thresh=0.001,
                         coord_start=2, score_index=1, id_index=0)


def test_frcnn_default_im_info_is_the_input_shape(frcnn):
    from mxnet_tpu_torch.gluon.model_zoo.detection import faster_rcnn

    x = tmx.nd.zeros((3, 3, 40, 56), ctx=tmx.cpu())
    np.testing.assert_array_equal(faster_rcnn._default_im_info(x).asnumpy(),
                                  [[40, 56, 1]] * 3)

"""Faster R-CNN detector (two-stage, C4).

Counterpart of ``mxnet_tpu/gluon/model_zoo/detection/faster_rcnn.py``
(GluonCV ``gluoncv/model_zoo/{rpn,faster_rcnn}/``); the ops it drives are
``Proposal`` and ``ROIAlign``.  Both stages run at fixed shapes: the RPN
keeps a static ``rpn_post_nms`` proposal count (invalid slots zeroed and
masked downstream), so ROIAlign and the box head capture into the same
CUDA graph as the backbone.  The default ``im_info`` is made on the
card from the input's static shape (no host copy).  NMS runs twice a
forward as the ``nms_keep`` kernel: the RPN's and the final
``box_nms``.
"""
from __future__ import annotations

import torch

from ...block import HybridBlock
from ... import nn
from ..vision import get_model as _get_base_model

__all__ = ["RPN", "FasterRCNN", "faster_rcnn_resnet50_v1"]


class RPN(HybridBlock):
    """Region proposal network head: 3x3 conv → objectness + box deltas,
    then the ``Proposal`` decode+NMS op."""

    def __init__(self, channels=512, scales=(8, 16, 32), ratios=(0.5, 1, 2),
                 feature_stride=16, pre_nms=2000, post_nms=300,
                 nms_thresh=0.7, min_size=5, **kwargs):
        super().__init__(**kwargs)
        self._scales = tuple(scales)
        self._ratios = tuple(ratios)
        self._stride = feature_stride
        self._pre = pre_nms
        self._post = post_nms
        self._nms = nms_thresh
        self._min_size = min_size
        a = len(scales) * len(ratios)
        with self.name_scope():
            self.conv = nn.HybridSequential(prefix="")
            self.conv.add(nn.Conv2D(channels, 3, 1, 1))
            self.conv.add(nn.Activation("relu"))
            self.score = nn.Conv2D(2 * a, 1, 1, 0)
            self.loc = nn.Conv2D(4 * a, 1, 1, 0)

    def hybrid_forward(self, F, feat, im_info):
        x = self.conv(feat)
        raw_score = self.score(x)        # (B, 2A, H, W)
        loc = self.loc(x)                # (B, 4A, H, W)
        # softmax over {bg, fg} pairs: fold A*H*W into one axis
        a2 = raw_score.shape[1]
        score = F.softmax(
            F.reshape(raw_score, shape=(0, 2, (a2 // 2) *
                                        raw_score.shape[2] *
                                        raw_score.shape[3])), axis=1)
        score = F.reshape(score, shape=(0, a2, *raw_score.shape[2:]))
        rois = F.contrib.Proposal(
            score, loc, im_info, rpn_pre_nms_top_n=self._pre,
            rpn_post_nms_top_n=self._post, threshold=self._nms,
            rpn_min_size=self._min_size, scales=self._scales,
            ratios=self._ratios, feature_stride=self._stride)
        return rois, raw_score, loc


def _default_im_info(x):
    """(B, 3) [h, w, 1] of the input's static shape, filled on its device."""
    from ....ndarray import NDArray

    info = torch.ones((x.shape[0], 3), dtype=torch.float32,
                      device=x._data.device)
    info[:, 0] = float(x.shape[2])
    info[:, 1] = float(x.shape[3])
    return NDArray(info)


class FasterRCNN(HybridBlock):
    """Two-stage detector (GluonCV ``FasterRCNN`` analog, C4 variant).

    Training mode: returns ``(rois (B*P, 5), cls_pred (B*P, C+1),
    box_pred (B*P, 4), rpn_score, rpn_loc)``.
    Inference: ``(ids, scores, bboxes)`` per image after per-class decode +
    NMS, fixed ``post_nms`` slots.
    """

    def __init__(self, classes=20, backbone="resnet50_v1", roi_size=7,
                 feature_stride=16, rpn_post_nms=128, post_nms=100,
                 nms_thresh=0.3, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = classes
        self._stride = feature_stride
        self._roi_size = roi_size
        self._rpn_post = rpn_post_nms
        self._post = post_nms
        self._nms = nms_thresh
        self._box_stds = (0.1, 0.1, 0.2, 0.2)
        with self.name_scope():
            base = _get_base_model(backbone)
            feats = base.features
            # C4: through stage 3 (stride 16); stage 4 is the roi head
            self.features = feats[:len(feats) - 2]
            self.top_features = feats[len(feats) - 2:len(feats) - 1]
            self.rpn = RPN(feature_stride=feature_stride,
                           post_nms=rpn_post_nms, min_size=1)
            self.class_predictor = nn.Dense(classes + 1)
            self.box_predictor = nn.Dense(4)

    def hybrid_forward(self, F, x, im_info=None):
        from .... import autograd as ag

        if im_info is None:
            im_info = _default_im_info(x)
        feat = self.features(x)
        rois, rpn_score, rpn_loc = self.rpn(feat, im_info)
        pooled = F.contrib.ROIAlign(
            feat, rois, pooled_size=(self._roi_size * 2,) * 2,
            spatial_scale=1.0 / self._stride, sample_ratio=2)
        top = self.top_features(pooled)  # (B*P, C', roi, roi)
        top = F.Pooling(top, global_pool=True, pool_type="avg")
        top = F.Flatten(top)
        cls_pred = self.class_predictor(top)   # (B*P, C+1)
        box_pred = self.box_predictor(top)     # (B*P, 4)
        if ag.is_training():
            return rois, cls_pred, box_pred, rpn_score, rpn_loc
        # inference decode: softmax classes, decode boxes against rois
        b = x.shape[0]
        p = self._rpn_post
        prob = F.softmax(cls_pred, axis=-1)            # (B*P, C+1)
        prob = F.reshape(prob, shape=(b, p, -1))
        box_pred = F.reshape(box_pred, shape=(b, p, 4))
        roi_boxes = F.reshape(
            F.slice_axis(rois, axis=1, begin=1, end=5), shape=(b, p, 4))
        decoded = F.contrib.box_decode(
            box_pred, roi_boxes, *self._box_stds, format="corner")
        cls_prob = F.slice_axis(prob, axis=-1, begin=1, end=None)
        cid = F.argmax(cls_prob, axis=-1, keepdims=True)
        score = F.max(cls_prob, axis=-1, keepdims=True)
        # mask the RPN's zero-padded slots (degenerate zero-area rois)
        rw = (F.slice_axis(roi_boxes, axis=-1, begin=2, end=3)
              - F.slice_axis(roi_boxes, axis=-1, begin=0, end=1))
        rh = (F.slice_axis(roi_boxes, axis=-1, begin=3, end=4)
              - F.slice_axis(roi_boxes, axis=-1, begin=1, end=2))
        score = score * ((rw > 0) * (rh > 0))
        dets = F.concat(cid, score, decoded, dim=-1)
        dets = F.contrib.box_nms(
            dets, overlap_thresh=self._nms, valid_thresh=0.001,
            coord_start=2, score_index=1, id_index=0)
        dets = F.slice_axis(dets, axis=1, begin=0,
                            end=min(self._post, p))
        ids = F.slice_axis(dets, axis=2, begin=0, end=1)
        score = F.slice_axis(dets, axis=2, begin=1, end=2)
        bbox = F.slice_axis(dets, axis=2, begin=2, end=6)
        return ids, score, bbox


def faster_rcnn_resnet50_v1(classes=20, **kwargs):
    """Faster R-CNN on ResNet-50 v1 C4 (GluonCV
    ``faster_rcnn_resnet50_v1b_voc`` analog)."""
    return FasterRCNN(classes=classes, backbone="resnet50_v1", **kwargs)

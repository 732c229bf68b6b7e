"""YOLOv3 detector + Darknet-53 backbone.

Counterpart of ``mxnet_tpu/gluon/model_zoo/detection/yolo.py`` (GluonCV
``gluoncv/model_zoo/yolo/{darknet,yolo3}.py``); the decode is
elementwise and NMS is ``box_nms`` (one ``nms_keep`` launch over the
``nms_topk`` best boxes of each image).  The grid offsets and anchor
sizes are made on the prediction's device (``arange`` and fills, never a
host copy) and cached per feature size and device outside a capture, so
the detector captures into one CUDA graph.  Darknet's blocks end in
LeakyReLU, so none of them runs the fused 1×1 conv + BatchNorm + ReLU
kernel.
"""
from __future__ import annotations

import numpy as np

from ...block import HybridBlock
from ... import nn

__all__ = ["DarknetV3", "YOLOV3", "darknet53", "yolo3_darknet53"]


def _conv2d(channels, kernel, stride, pad):
    """conv + BN + LeakyReLU(0.1) — darknet's universal block."""
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel, stride, pad, use_bias=False))
    out.add(nn.BatchNorm(epsilon=1e-5, momentum=0.9))
    out.add(nn.LeakyReLU(0.1))
    return out


class DarknetBasicBlockV3(HybridBlock):
    """1x1 squeeze + 3x3 expand with residual add."""

    def __init__(self, channels, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(_conv2d(channels // 2, 1, 1, 0))
            self.body.add(_conv2d(channels, 3, 1, 1))

    def hybrid_forward(self, F, x):
        return x + self.body(x)


class DarknetV3(HybridBlock):
    """Darknet-53 (GluonCV ``DarknetV3``): stages [1, 2, 8, 8, 4] at
    channels [64, 128, 256, 512, 1024]."""

    def __init__(self, layers=(1, 2, 8, 8, 4),
                 channels=(64, 128, 256, 512, 1024), classes=1000,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_conv2d(32, 3, 1, 1))
            for nlayer, channel in zip(layers, channels):
                self.features.add(_conv2d(channel, 3, 2, 1))  # downsample
                for _ in range(nlayer):
                    self.features.add(DarknetBasicBlockV3(channel))
            self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = F.Pooling(x, kernel=(1, 1), global_pool=True, pool_type="avg")
        return self.output(F.Flatten(x))


def darknet53(classes=1000, **kwargs):
    return DarknetV3(classes=classes, **kwargs)


class YOLODetectionBlockV3(HybridBlock):
    """Alternating 1x1/3x3 convs; ``route`` feeds the upsample branch,
    ``tip`` feeds the output head."""

    def __init__(self, channel, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            for _ in range(2):
                self.body.add(_conv2d(channel, 1, 1, 0))
                self.body.add(_conv2d(channel * 2, 3, 1, 1))
            self.body.add(_conv2d(channel, 1, 1, 0))
            self.tip = _conv2d(channel * 2, 3, 1, 1)

    def hybrid_forward(self, F, x):
        route = self.body(x)
        return route, self.tip(route)


class YOLOOutputV3(HybridBlock):
    """Per-scale output head: 1x1 conv → (B, H*W*A, 5+C) raw preds plus
    decoded corner boxes."""

    def __init__(self, num_classes, anchors, stride, **kwargs):
        super().__init__(**kwargs)
        self._classes = num_classes
        self._anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
        self._stride = stride
        self._grid_cache = {}  # (h, w, device) -> (grid, anchors)
        a = len(self._anchors)
        with self.name_scope():
            self.prediction = nn.Conv2D(a * (num_classes + 5), 1, 1, 0)

    def _grids(self, h, w, device):
        """Constant grid/anchor tensors, cached per feature size and
        device (the analog of GluonCV's precomputed offsets), made on the
        device; one made while a stream captures is not kept (its fills
        run only when the graph replays)."""
        import torch

        from ....ndarray import NDArray
        from ....ops.contrib import _capturing, _const

        key = (h, w, str(device))
        if key not in self._grid_cache:
            a = len(self._anchors)
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=device),
                torch.arange(w, dtype=torch.float32, device=device),
                indexing="ij")
            grid = torch.stack([gx, gy], dim=-1).reshape(-1, 1, 2)
            grid = grid.expand(h * w, a, 2).reshape(1, -1, 2)
            anc = _const([float(v) for v in self._anchors.ravel()],
                         device).reshape(1, a, 2)
            anc = anc.expand(h * w, a, 2).reshape(1, -1, 2)
            out = (NDArray(grid), NDArray(anc))
            if _capturing():
                return out
            self._grid_cache[key] = out
        return self._grid_cache[key]

    def hybrid_forward(self, F, x):
        a = len(self._anchors)
        c = self._classes
        pred = self.prediction(x)  # (B, A*(5+C), H, W)
        h, w = pred.shape[2], pred.shape[3]
        pred = F.transpose(pred, axes=(0, 2, 3, 1))
        pred = F.reshape(pred, shape=(0, -1, c + 5))  # (B, H*W*A, 5+C)
        # constant grid/anchor tensors (cached per size and device)
        grid, anc = self._grids(h, w, pred._data.device)
        xy = (F.sigmoid(F.slice_axis(pred, axis=-1, begin=0, end=2))
              + grid) * self._stride
        wh = F.exp(F.slice_axis(pred, axis=-1, begin=2, end=4)) * anc
        obj = F.sigmoid(F.slice_axis(pred, axis=-1, begin=4, end=5))
        cls = F.sigmoid(F.slice_axis(pred, axis=-1, begin=5, end=None))
        half = wh / 2
        bbox = F.concat(xy - half, xy + half, dim=-1)  # corner, pixel
        return pred, bbox, obj * cls


_DEFAULT_ANCHORS = [[10, 13, 16, 30, 33, 23],
                    [30, 61, 62, 45, 59, 119],
                    [116, 90, 156, 198, 373, 326]]


class YOLOV3(HybridBlock):
    """YOLOv3 (GluonCV ``YOLOV3``).

    Training mode: returns ``(raw_preds (B, N, 5+C), bboxes (B, N, 4),
    scores (B, N, C))`` for loss construction.
    Inference: ``(ids (B, topk, 1), scores (B, topk, 1),
    bboxes (B, topk, 4))`` after NMS.
    """

    def __init__(self, classes=20, anchors=None, strides=(8, 16, 32),
                 nms_thresh=0.45, nms_topk=400, post_nms=100, **kwargs):
        super().__init__(**kwargs)
        anchors = anchors or _DEFAULT_ANCHORS
        self.num_classes = classes
        self.nms_thresh = nms_thresh
        self.nms_topk = nms_topk
        self.post_nms = post_nms
        with self.name_scope():
            backbone = DarknetV3()
            feats = backbone.features
            # stage boundaries at /8 (idx 15), /16 (24), /32 (29) layers
            self.stage1 = feats[:15]
            self.stage2 = feats[15:24]
            self.stage3 = feats[24:]
            self.blocks = nn.HybridSequential(prefix="yolo_det_")
            self.outputs = nn.HybridSequential(prefix="yolo_out_")
            self.transitions = nn.HybridSequential(prefix="yolo_trans_")
            for i, ch in enumerate((512, 256, 128)):
                self.blocks.add(YOLODetectionBlockV3(ch))
                self.outputs.add(YOLOOutputV3(
                    classes, anchors[2 - i], strides[2 - i]))
                if i < 2:
                    self.transitions.add(_conv2d(ch // 2, 1, 1, 0))

    def hybrid_forward(self, F, x):
        from .... import autograd as ag

        f1 = self.stage1(x)      # /8,  256ch
        f2 = self.stage2(f1)     # /16, 512ch
        f3 = self.stage3(f2)     # /32, 1024ch
        preds, boxes, scores = [], [], []
        feat = f3
        for i, skip in enumerate((f2, f1, None)):
            route, tip = self.blocks[i](feat)
            p, b, s = self.outputs[i](tip)
            preds.append(p)
            boxes.append(b)
            scores.append(s)
            if skip is not None:
                t = self.transitions[i](route)
                t = F.UpSampling(t, scale=2, sample_type="nearest")
                feat = F.concat(t, skip, dim=1)
        preds = F.concat(*preds, dim=1)
        boxes = F.concat(*boxes, dim=1)
        scores = F.concat(*scores, dim=1)
        if ag.is_training():
            return preds, boxes, scores
        # inference: class-aware NMS over [cls, score, x1 y1 x2 y2]
        cid = F.argmax(scores, axis=-1, keepdims=True)
        score = F.max(scores, axis=-1, keepdims=True)
        dets = F.concat(cid, score, boxes, dim=-1)
        dets = F.contrib.box_nms(
            dets, overlap_thresh=self.nms_thresh, valid_thresh=0.01,
            topk=self.nms_topk, coord_start=2, score_index=1, id_index=0)
        dets = F.slice_axis(dets, axis=1, begin=0, end=self.post_nms)
        ids = F.slice_axis(dets, axis=2, begin=0, end=1)
        score = F.slice_axis(dets, axis=2, begin=1, end=2)
        bbox = F.slice_axis(dets, axis=2, begin=2, end=6)
        return ids, score, bbox


def yolo3_darknet53(classes=20, **kwargs):
    """YOLOv3 w/ Darknet-53 (GluonCV ``yolo3_darknet53_voc`` analog)."""
    return YOLOV3(classes=classes, **kwargs)

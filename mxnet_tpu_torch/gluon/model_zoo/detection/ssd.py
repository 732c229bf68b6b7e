"""SSD detector family.

Counterpart of ``mxnet_tpu/gluon/model_zoo/detection/ssd.py`` (GluonCV
``gluoncv/model_zoo/ssd/``; the ops it drives are ``MultiBoxPrior``,
``MultiBoxTarget``, ``MultiBoxDetection`` and ``box_nms``).

The whole detector — backbone, multi-scale heads, anchor generation,
decode and NMS — is one HybridBlock, so ``hybridize()`` captures one CUDA
graph a signature: the anchors are made on the card by ``arange`` and
fills, and NMS is one launch of the ``nms_keep`` kernel.  The ResNet
backbone's and the extra blocks' 1×1 conv + BatchNorm + ReLU run as the
fused kernel in inference (``nn.HybridSequential``).
"""
from __future__ import annotations

import numpy as np

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn
from ..vision import get_model as _get_base_model

__all__ = ["SSD", "SSDAnchorGenerator", "get_ssd", "ssd_300_resnet18_v1",
           "ssd_512_resnet50_v1"]


class SSDAnchorGenerator(HybridBlock):
    """Per-scale anchor generator: wraps ``MultiBoxPrior`` with this
    layer's sizes/ratios (GluonCV ``ssd/anchor.py`` analog)."""

    def __init__(self, sizes, ratios, step=-1.0, clip=True, **kwargs):
        super().__init__(**kwargs)
        self._sizes = tuple(float(s) for s in sizes)
        self._ratios = tuple(float(r) for r in ratios)
        self._step = step
        self._clip = clip

    @property
    def num_anchors(self):
        return len(self._sizes) + len(self._ratios) - 1

    def hybrid_forward(self, F, x):
        return F.contrib.MultiBoxPrior(
            x, sizes=self._sizes, ratios=self._ratios, clip=self._clip,
            steps=(self._step, self._step) if self._step > 0 else (-1, -1))


def _conv_act(channels, kernel, stride, pad):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel, stride, pad, use_bias=False))
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    return out


class SSD(HybridBlock):
    """Single-shot detector (GluonCV ``SSD`` analog).

    Training mode (``autograd.record``): returns
    ``(cls_preds (B, N, C+1), box_preds (B, N, 4), anchors (1, N, 4))`` —
    feed to ``MultiBoxTarget`` + losses.
    Inference: returns ``(ids (B, topk, 1), scores (B, topk, 1),
    bboxes (B, topk, 4))`` after decode + NMS.
    """

    def __init__(self, base_name, num_layers, classes, sizes, ratios,
                 base_stop=None, num_extra=None, nms_thresh=0.45,
                 nms_topk=400, post_nms=100, **kwargs):
        super().__init__(**kwargs)
        if len(sizes) != num_layers or len(ratios) != num_layers:
            raise MXNetError("sizes/ratios must have num_layers entries")
        # pyramid = backbone output + extras; one head per level
        num_extra = num_layers - 1 if num_extra is None else num_extra
        if 1 + num_extra != num_layers:
            raise MXNetError("1 + num_extra must equal num_layers")
        self.num_classes = classes
        self.nms_thresh = nms_thresh
        self.nms_topk = nms_topk
        self.post_nms = post_nms
        with self.name_scope():
            base = _get_base_model(base_name)
            feats = base.features
            # drop global pool (+ flatten etc.) — keep conv stages only
            stop = base_stop if base_stop is not None else len(feats) - 1
            self.features = feats[:stop]
            # extra downsampling stages extend the pyramid
            self.extras = nn.HybridSequential(prefix="extra_")
            for _ in range(num_extra):
                blk = nn.HybridSequential(prefix="")
                blk.add(_conv_act(256, 1, 1, 0))
                blk.add(_conv_act(256, 3, 2, 1))
                self.extras.add(blk)
            self.class_predictors = nn.HybridSequential(prefix="cls_")
            self.box_predictors = nn.HybridSequential(prefix="box_")
            self.anchor_generators = nn.HybridSequential(prefix="anchor_")
            for i in range(num_layers):
                gen = SSDAnchorGenerator(sizes[i], ratios[i])
                a = gen.num_anchors
                self.anchor_generators.add(gen)
                self.class_predictors.add(
                    nn.Conv2D(a * (classes + 1), 3, 1, 1))
                self.box_predictors.add(nn.Conv2D(a * 4, 3, 1, 1))

    def _pyramid(self, x):
        feats = [self.features(x)]
        for blk in self.extras:
            feats.append(blk(feats[-1]))
        return feats

    def hybrid_forward(self, F, x):
        from .... import autograd as ag

        feats = self._pyramid(x)
        cls_preds, box_preds, anchors = [], [], []
        for feat, cp, bp, gen in zip(feats, self.class_predictors,
                                     self.box_predictors,
                                     self.anchor_generators):
            # (B, A*(C+1), H, W) → (B, H*W*A, C+1)
            c = F.transpose(cp(feat), axes=(0, 2, 3, 1))
            cls_preds.append(F.reshape(c, shape=(0, -1, self.num_classes + 1)))
            b = F.transpose(bp(feat), axes=(0, 2, 3, 1))
            box_preds.append(F.reshape(b, shape=(0, -1, 4)))
            anchors.append(gen(feat))
        cls_preds = F.concat(*cls_preds, dim=1)
        box_preds = F.concat(*box_preds, dim=1)
        anchors = F.concat(*anchors, dim=1)
        if ag.is_training():
            return cls_preds, box_preds, anchors
        # inference decode: (B, N, C+1) → per-anchor class probs
        cls_prob = F.transpose(F.softmax(cls_preds, axis=-1),
                               axes=(0, 2, 1))
        out = F.contrib.MultiBoxDetection(
            cls_prob, F.reshape(box_preds, shape=(0, -1)), anchors,
            nms_threshold=self.nms_thresh, nms_topk=self.nms_topk,
            force_suppress=False)
        out = F.slice_axis(out, axis=1, begin=0, end=self.post_nms)
        ids = F.slice_axis(out, axis=2, begin=0, end=1)
        scores = F.slice_axis(out, axis=2, begin=1, end=2)
        bboxes = F.slice_axis(out, axis=2, begin=2, end=6)
        return ids, scores, bboxes


def get_ssd(base_name, size, classes=20, **kwargs):
    """Build an SSD over a vision-zoo backbone (GluonCV ``get_ssd``):
    larger input sizes get a deeper pyramid with finer anchor scales."""
    num_layers = 4 if size < 450 else 5
    # scale progression per the SSD paper (smin → smax across the pyramid)
    s = np.linspace(0.15 if size < 450 else 0.1, 0.9, num_layers + 1)
    sizes = [[s[i], float(np.sqrt(s[i] * s[i + 1]))]
             for i in range(num_layers)]
    ratios = [[1, 2, 0.5]] * num_layers
    return SSD(base_name, num_layers, classes, sizes, ratios, **kwargs)


def ssd_300_resnet18_v1(classes=20, **kwargs):
    """SSD-300 on ResNet-18 v1 (GluonCV ``ssd_300_*`` analog)."""
    return get_ssd("resnet18_v1", 300, classes=classes, **kwargs)


def ssd_512_resnet50_v1(classes=20, **kwargs):
    """SSD-512 on ResNet-50 v1 (GluonCV ``ssd_512_resnet50_v1_voc``)."""
    return get_ssd("resnet50_v1", 512, classes=classes, **kwargs)

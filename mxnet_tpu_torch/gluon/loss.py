"""Gluon losses: ``Loss``, ``L2Loss``, ``L1Loss`` and
``SoftmaxCrossEntropyLoss``.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (reference
``python/mxnet/gluon/loss.py``).  Each returns a per-sample loss vector
(the mean over the non-batch axes), so ``loss.backward()`` seeds ones
per sample.  The other losses port with the op library (ROADMAP Queue 1
item 2).
"""
from __future__ import annotations

from ..base import MXNetError
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """Optional static weight and per-sample weight (broadcast)."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise MXNetError("weight must be a number")
        loss = loss * weight
    return loss


def _reshape_like(F, pred, label):
    return label.reshape(pred.shape)


def _batch_mean(F, loss, batch_axis):
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis)
    if not axes:
        return loss
    return F.mean(loss, axis=axes)


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """weight/2 · (label − pred)², averaged over the non-batch axes."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class L1Loss(Loss):
    """|label − pred|, averaged over the non-batch axes."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """Reference ``SoftmaxCELoss``: log-softmax + pick (sparse labels) or
    -sum(label · log_softmax) (dense labels); ``from_logits`` takes
    ``pred`` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, pred, label)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss

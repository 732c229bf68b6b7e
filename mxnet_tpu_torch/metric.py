"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (reference
``python/mxnet/metric.py``): the ``EvalMetric`` registry with
``update(labels, preds)`` / ``get()`` / ``reset()``, the standard family,
``CompositeEvalMetric`` and ``create()``.  ``Accuracy``, ``TopKAccuracy``
and ``Loss`` reduce on the device (argmax or top-k, compare, sum) and
keep a running device scalar, read once at ``get``; the other metrics
accumulate on the host in float64, as the reference's do.
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "PearsonCorrelation", "Loss", "Torch", "Caffe", "CustomMetric",
           "create", "np"]

_METRIC_REGISTRY = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        name = metric.lower()
        aliases = {"acc": "accuracy", "ce": "crossentropy",
                   "top_k_accuracy": "topkaccuracy",
                   "top_k_acc": "topkaccuracy"}
        name = aliases.get(name, name)
        if name in _METRIC_REGISTRY:
            return _METRIC_REGISTRY[name](*args, **kwargs)
    raise MXNetError(f"unknown metric {metric!r}")


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if isinstance(labels, NDArray):
        labels = [labels]
    if isinstance(preds, NDArray):
        preds = [preds]
    if len(labels) != len(preds):
        raise MXNetError(
            f"labels/preds count mismatch: {len(labels)} vs {len(preds)}")
    return labels, preds


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict([self.get()])}"

    def get_config(self):
        config = dict(self._kwargs)
        config.update({"metric": type(self).__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names
                     if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._dev_sum = None

    def _drain(self):
        """Fold deferred device-side accumulation into ``sum_metric``.
        One host sync drains ANY number of updates; the per-update path
        never blocks the dispatch queue."""
        if getattr(self, "_dev_sum", None) is not None:
            self.sum_metric += float(self._dev_sum.asnumpy())
            self._dev_sum = None

    def _accum_device(self, scalar):
        """Add an (async, still-on-device) scalar NDArray to the running
        device accumulator."""
        self._dev_sum = scalar if self._dev_sum is None \
            else self._dev_sum + scalar

    def get(self):
        self._drain()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name)
            values.append(value)
        return (names, values)


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            if isinstance(label, NDArray) and isinstance(pred, NDArray):
                # device path: argmax + compare + reduce stay on device;
                # only a running scalar survives, synced once at get()
                if pred.ndim > label.ndim:
                    pred = pred.argmax(axis=self.axis)
                correct = (pred.astype(_np.int32).reshape(-1) ==
                           label.astype(_np.int32).reshape(-1))
                self._accum_device(correct.astype(_np.float32).sum())
                self.num_inst += label.size
                continue
            label = _to_np(label)
            pred = _to_np(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(_np.int32).ravel()
            label = label.astype(_np.int32).ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names,
                         top_k=top_k)
        self.top_k = top_k
        if top_k <= 1:
            raise MXNetError("use Accuracy for top_k=1")

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            if isinstance(label, NDArray) and isinstance(pred, NDArray):
                # device path: top-k runs on device and only the (N, k)
                # indices feed the running scalar — the full logits are
                # never pulled to host
                top = pred.topk(axis=-1, k=self.top_k)
                hit = (top.astype(_np.int32).reshape(label.size, -1) ==
                       label.astype(_np.int32).reshape(-1, 1))
                self._accum_device(
                    hit.max(axis=1).astype(_np.float32).sum())
                self.num_inst += label.size
                continue
            label = _to_np(label).astype(_np.int32).ravel()
            pred = _to_np(pred)
            top = _np.argpartition(pred, -self.top_k,
                                  axis=-1)[..., -self.top_k:]
            top = top.reshape(len(label), -1)
            self.sum_metric += (top == label[:, None]).any(axis=1).sum()
            self.num_inst += len(label)


@register
class F1(EvalMetric):
    """Binary F1 (reference supports macro/micro averaging)."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        super().__init__(name, output_names, label_names)

    def reset(self):
        self._tp = self._fp = self._fn = 0
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).ravel().astype(_np.int32)
            pred = _to_np(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(-1)
            pred = pred.ravel().astype(_np.int32)
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            self.num_inst += len(label)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        precision = self._tp / max(self._tp + self._fp, 1)
        recall = self._tp / max(self._tp + self._fn, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        return (self.name, f1)


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient (reference ``mx.metric.MCC``)."""

    def __init__(self, name="mcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def reset(self):
        self._tp = self._fp = self._fn = self._tn = 0
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).ravel().astype(_np.int32)
            pred = _to_np(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(-1)
            pred = pred.ravel().astype(_np.int32)
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            self._tn += ((pred == 0) & (label == 0)).sum()
            self.num_inst += len(label)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        tp, fp, fn, tn = self._tp, self._fp, self._fn, self._tn
        denom = _np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        mcc = (tp * tn - fp * fn) / denom if denom > 0 else 0.0
        return (self.name, mcc)


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _to_np(label).ravel().astype(_np.int64)
            pred = _to_np(pred).reshape(len(label), -1)
            probs = pred[_np.arange(len(label)), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                probs = _np.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= _np.log(_np.maximum(1e-10, probs)).sum()
            num += len(label)
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(_np.exp(self.sum_metric / self.num_inst)))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label)
            pred = _to_np(pred)
            if label.ndim == pred.ndim - 1:
                label = label.reshape(pred.shape)
            self.sum_metric += _np.abs(label - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label)
            pred = _to_np(pred)
            if label.ndim == pred.ndim - 1:
                label = label.reshape(pred.shape)
            self.sum_metric += ((label - pred) ** 2).mean()
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(_np.sqrt(self.sum_metric / self.num_inst)))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).ravel().astype(_np.int64)
            pred = _to_np(pred).reshape(len(label), -1)
            prob = pred[_np.arange(len(label)), label]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += len(label)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).ravel()
            pred = _to_np(pred).ravel()
            self.sum_metric += _np.corrcoef(pred, label)[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Running mean of a loss output (reference ``mx.metric.Loss``)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            if isinstance(pred, NDArray):
                # device path: defer the reduction, sync once at get()
                self._accum_device(pred.astype(_np.float32).sum())
                self.num_inst += pred.size
                continue
            loss = _np.asarray(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = getattr(feval, "__name__", "custom")
            if name.startswith("<"):
                name = "custom"
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_to_np(label), _to_np(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (reference ``mx.metric.np``)."""
    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", "custom")
    return CustomMetric(feval, name, allow_extra_outputs)

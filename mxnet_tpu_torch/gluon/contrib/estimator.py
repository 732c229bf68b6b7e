"""Gluon Estimator: the high-level ``fit()`` loop with event handlers.

Counterpart of ``mxnet_tpu/gluon/contrib/estimator.py`` (reference
``python/mxnet/gluon/contrib/estimator/{estimator,event_handler}.py``):
``Estimator(net, loss, train_metrics, trainer)`` with ``fit(train_data,
val_data, epochs, event_handlers)`` and ``evaluate(val_data)``, the
TrainBegin/EpochEnd/... hooks, and the handlers ``StoppingHandler``,
``LoggingHandler``, ``CheckpointHandler`` (``.params`` files, the
reference's bytes), ``EarlyStoppingHandler`` and
``FaultTolerantCheckpoint`` (over ``checkpoint.py``: atomic writes,
resume with the Trainer's state and the random state).

``fit(hybridize=True)`` (the default) hybridizes a HybridBlock net; its
training forwards run under ``autograd.record()``, which ``CachedOp``
runs eagerly (``cache_stats()["recorded"]``), and ``evaluate``'s
forwards replay CUDA graphs on a card.  Each step is the hand-written
loop's: ``record()``/``backward()``/``Trainer.step`` (the fused update
kernel); the handlers and metrics run on the host between steps.
"""
from __future__ import annotations

import time

from ...base import MXNetError

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StoppingHandler", "LoggingHandler",
           "CheckpointHandler", "EarlyStoppingHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop on max_epoch/max_batch (reference ``StoppingHandler``)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.stop_training = False
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            self.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            self.stop_training = True


class LoggingHandler(TrainBegin, TrainEnd, EpochEnd, BatchEnd):
    """Per-epoch (and optionally per-interval batch) metric logging."""

    def __init__(self, log_interval="epoch", metrics=None):
        self.log_interval = log_interval
        self.metrics = metrics
        self._batch = 0
        self._tic = None

    def train_begin(self, estimator, *args, **kwargs):
        self._tic = time.time()
        self._batch = 0
        print(f"Training begin: {estimator.max_epoch} epochs")

    def train_end(self, estimator, *args, **kwargs):
        print(f"Training end: {time.time() - self._tic:.1f}s")

    def batch_end(self, estimator, *args, **kwargs):
        self._batch += 1
        if self.log_interval != "epoch" and \
                self._batch % int(self.log_interval) == 0:
            print(f"[batch {self._batch}] " + self._fmt(estimator))

    def epoch_end(self, estimator, *args, **kwargs):
        print(f"[epoch] " + self._fmt(estimator))

    def _fmt(self, estimator):
        parts = []
        for m in (self.metrics or estimator.train_metrics):
            name, val = m.get()
            parts.append(f"{name}={val:.4f}")
        return " ".join(parts)


class CheckpointHandler(TrainBegin, EpochEnd):
    """Save params every ``save_every`` epochs (reference
    ``CheckpointHandler``; format = gluon save_parameters, loadable by the
    reference's NDArray::Load)."""

    def __init__(self, model_dir, model_prefix="model", save_every=1):
        import os

        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.save_every = save_every
        self._epoch = 0
        os.makedirs(model_dir, exist_ok=True)

    def train_begin(self, estimator, *args, **kwargs):
        self._epoch = 0

    def epoch_end(self, estimator, *args, **kwargs):
        self._epoch += 1
        if self._epoch % self.save_every == 0:
            import os

            path = os.path.join(self.model_dir,
                                f"{self.model_prefix}-"
                                f"{self._epoch:04d}.params")
            estimator.net.save_parameters(path)


class FaultTolerantCheckpoint(TrainBegin, EpochEnd):
    """Atomic checkpoint + auto-resume handler (beyond the reference's
    CheckpointHandler: includes Trainer state and survives mid-write
    crashes — see checkpoint.py).

    On ``train_begin`` it RESUMES from the newest complete checkpoint in
    ``ckpt_dir`` (restoring weights, optimizer state and RNG position);
    every ``save_every`` epochs it writes ``ckpt-<epoch>`` atomically,
    keeping the newest ``keep``.

    ``fit(epochs=N)`` is treated as a TOTAL budget: a run resumed at
    epoch k trains only the remaining N-k epochs (the handler raises
    ``stop_training`` once the global epoch counter reaches N), so an
    interrupted-and-rerun job lands on exactly the same epoch count as an
    uninterrupted one.
    """

    def __init__(self, ckpt_dir, save_every=1, keep=3):
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.keep = keep
        self.resumed_epoch = 0
        self._epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        from ... import checkpoint

        step, _extra = checkpoint.resume(self.ckpt_dir, estimator.net,
                                         getattr(estimator, "trainer",
                                                 None))
        self.resumed_epoch = self._epoch = step
        budget = getattr(estimator, "max_epoch", None)
        self.stop_training = budget is not None and self._epoch >= budget

    def epoch_end(self, estimator, *args, **kwargs):
        from ... import checkpoint

        self._epoch += 1
        if self._epoch % self.save_every == 0:
            checkpoint.save_checkpoint(
                self.ckpt_dir, self._epoch, estimator.net,
                getattr(estimator, "trainer", None), keep=self.keep)
        budget = getattr(estimator, "max_epoch", None)
        if budget is not None and self._epoch >= budget:
            self.stop_training = True


class EarlyStoppingHandler(TrainBegin, EpochEnd):
    """Stop when a monitored metric stops improving."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto"):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        if mode == "auto":
            mode = "min" if any(
                s in monitor.get()[0] for s in ("loss", "error")) else "max"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        # reusable across fit() calls (reference resets here too)
        self.best = None
        self.wait = 0
        self.stop_training = False

    def epoch_end(self, estimator, *args, **kwargs):
        _name, val = self.monitor.get()
        better = (self.best is None or
                  (val < self.best - self.min_delta if self.mode == "min"
                   else val > self.best + self.min_delta))
        if better:
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stop_training = True


class Estimator:
    """Reference ``gluon.contrib.estimator.Estimator``; ``context`` (or
    the device of the net's parameters) is where each batch goes."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None, val_metrics=None):
        from ... import metric as metric_mod
        from .. import Trainer

        self.net = net
        self.loss = loss
        self.train_metrics = train_metrics or [metric_mod.Accuracy()]
        self.val_metrics = val_metrics or [metric_mod.Accuracy()]
        self.trainer = trainer or Trainer(
            net.collect_params(), "adam", {"learning_rate": 1e-3})
        self.context = context
        self.max_epoch = None

    def _batch(self, batch):
        """A batch's data and label on the training context: ``context``,
        else the device of the net's parameters (a ``DataLoader`` yields
        host arrays; from page-locked memory the copy does not block)."""
        ctx = self.context
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        if ctx is None:
            for p in self.net.collect_params().values():
                try:
                    ctx = p.data().context
                    break
                except Exception:  # a deferred shape: not placed yet
                    continue
        if ctx is None:
            return batch[0], batch[1]
        return batch[0].as_in_context(ctx), batch[1].as_in_context(ctx)

    def _handlers(self, event_handlers, epochs):
        handlers = list(event_handlers or [])
        if not any(isinstance(h, StoppingHandler) for h in handlers):
            handlers.append(StoppingHandler(max_epoch=epochs))
        return handlers

    def evaluate(self, val_data, batch_axis=0):
        from ... import autograd

        for m in self.val_metrics:
            m.reset()
        for batch in val_data:
            data, label = self._batch(batch)
            with autograd.predict_mode():
                out = self.net(data)
            for m in self.val_metrics:
                m.update(label, out)
        return {m.get()[0]: m.get()[1] for m in self.val_metrics}

    def fit(self, train_data, val_data=None, epochs=1, event_handlers=None,
            batch_axis=0, hybridize=True):
        from ... import autograd
        from ..block import HybridBlock

        if hybridize and isinstance(self.net, HybridBlock) and \
                not getattr(self.net, "_active", False):
            self.net.hybridize()
        self.max_epoch = epochs
        handlers = self._handlers(event_handlers, epochs)

        def fire(kind, *a):
            for h in handlers:
                fn = getattr(h, kind, None)
                if fn is not None and hasattr(type(h), kind):
                    fn(self, *a)

        stoppers = [h for h in handlers
                    if hasattr(h, "stop_training")]
        fire("train_begin")
        for _epoch in range(epochs):
            # checked at loop top so a train_begin resume that already
            # exhausted the epoch budget runs zero epochs
            if any(s.stop_training for s in stoppers):
                break
            for m in self.train_metrics:
                m.reset()
            fire("epoch_begin")
            for batch in train_data:
                data, label = self._batch(batch)
                fire("batch_begin")
                with autograd.record():
                    out = self.net(data)
                    loss = self.loss(out, label)
                loss.backward()
                self.trainer.step(data.shape[batch_axis])
                for m in self.train_metrics:
                    m.update(label, out)
                fire("batch_end")
                if any(s.stop_training for s in stoppers):
                    break
            if val_data is not None:
                self.evaluate(val_data, batch_axis)
            fire("epoch_end")
        fire("train_end")
        return self

"""Legacy ``mx.model`` namespace: FeedForward and the checkpoint helpers.

Counterpart of ``mxnet_tpu/model.py`` (reference ``python/mxnet/model.py``):
the pre-Module training API; ``FeedForward`` wraps ``mx.mod.Module``, so
one implementation serves all three API generations (model, module,
gluon).
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError
from .callback import BatchEndParam  # noqa: F401  (reference re-export)
from .serialization import load_checkpoint, save_checkpoint  # noqa: F401

__all__ = ["FeedForward", "BatchEndParam", "save_checkpoint",
           "load_checkpoint"]


class FeedForward:
    """Reference ``mx.model.FeedForward``: symbol + fit/predict."""

    def __init__(self, symbol, ctx=None, num_epoch=None, optimizer="sgd",
                 initializer=None, arg_params=None, aux_params=None,
                 begin_epoch=0, **optimizer_params):
        from . import context as ctx_mod

        self.symbol = symbol
        self.ctx = ctx or ctx_mod.current_context()
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.optimizer_params = optimizer_params or {}
        self.initializer = initializer
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self._module = None

    def _create_module(self, data_iter):
        from . import module as mod

        label_descs = data_iter.provide_label or []
        m = mod.Module(self.symbol,
                       data_names=[d.name for d in data_iter.provide_data],
                       label_names=[l.name for l in label_descs],
                       context=self.ctx)
        self._module = m
        return m

    def _ensure_bound(self, data_iter):
        """Bind + init from stored params (the load-then-infer path)."""
        from . import initializer as init_mod

        if self._module is not None and self._module.binded:
            return self._module
        m = self._module or self._create_module(data_iter)
        m.bind(data_shapes=data_iter.provide_data,
               label_shapes=data_iter.provide_label or None,
               for_training=False)
        m.init_params(self.initializer or init_mod.Uniform(0.01),
                      arg_params=self.arg_params,
                      aux_params=self.aux_params,
                      allow_missing=self.arg_params is not None)
        return m

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            batch_end_callback=None, epoch_end_callback=None,
            logger=None, **kwargs):
        """Reference ``FeedForward.fit``: X is a DataIter (or arrays);
        delegates to the Module fit loop (one implementation serves all
        API generations)."""
        from . import io

        if self.num_epoch is None:
            raise MXNetError("num_epoch is required for fit")
        if hasattr(X, "provide_data"):
            data_iter = X
        else:
            if y is None:
                raise MXNetError("y must be specified when X is an array")
            data_iter = io.NDArrayIter(np.asarray(X), np.asarray(y),
                                       batch_size=32)
        m = self._create_module(data_iter)
        m.fit(data_iter, eval_data=eval_data, eval_metric=eval_metric,
              optimizer=self.optimizer,
              optimizer_params=dict(self.optimizer_params),
              initializer=self.initializer,
              arg_params=self.arg_params, aux_params=self.aux_params,
              allow_missing=self.arg_params is not None,
              begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
              batch_end_callback=batch_end_callback,
              epoch_end_callback=epoch_end_callback)
        self.arg_params, self.aux_params = m.get_params()
        return self

    def predict(self, X, num_batch=None):
        from . import io

        data_iter = X if hasattr(X, "provide_data") else \
            io.NDArrayIter(np.asarray(X), batch_size=32)
        m = self._ensure_bound(data_iter)
        outs = []
        data_iter.reset()
        for i, batch in enumerate(data_iter):
            if num_batch is not None and i >= num_batch:
                break
            m.forward(batch, is_train=False)
            out = m.get_outputs()[0].asnumpy()
            if batch.pad:
                out = out[:out.shape[0] - batch.pad]
            outs.append(out)
        return np.concatenate(outs, axis=0)

    def score(self, X, eval_metric="acc"):
        from . import metric as metric_mod

        m = self._ensure_bound(X)
        em = metric_mod.create(eval_metric)
        X.reset()
        for batch in X:
            m.forward(batch, is_train=False)
            m.update_metric(em, batch.label)
        return em.get()[1]

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, epoch if epoch is not None
                        else (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(sym, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @classmethod
    def create(cls, symbol, X, y=None, ctx=None, num_epoch=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", **kwargs):
        """Reference ``FeedForward.create``: construct AND train."""
        model = cls(symbol, ctx=ctx, num_epoch=num_epoch,
                    optimizer=optimizer, initializer=initializer,
                    **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric)
        return model

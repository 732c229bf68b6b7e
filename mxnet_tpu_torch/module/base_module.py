"""BaseModule: the fit/score/predict training-loop contract.

Counterpart of ``mxnet_tpu/module/base_module.py`` (reference
``python/mxnet/module/base_module.py``): ``fit()`` drives
forward_backward/update/update_metric over a DataIter, with the
initializer, optimizer, kvstore, checkpoint and Speedometer hooks.
"""
from __future__ import annotations

import logging
import time

from .. import metric as _metric
from ..base import MXNetError

_logger = logging.getLogger(__name__)


class BaseModule:
    """Abstract interface; Module and BucketingModule implement it."""

    def __init__(self, logger=None):
        self.logger = logger or _logger
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.for_training = False
        self.inputs_need_grad = False

    # --- abstract surface ---------------------------------------------------

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    # --- shared loop machinery ----------------------------------------------

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        if not (self.binded and self.params_initialized):
            raise MXNetError("module must be bound and initialized")
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(_BatchEndParam(epoch, nbatch, eval_metric))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True):
        from .. import nd

        if reset:
            eval_data.reset()
        outputs = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            outs = self.get_outputs()
            pad = getattr(batch, "pad", 0) or 0
            if pad:
                outs = [o[:o.shape[0] - pad] for o in outs]
            outputs.append(outs)
        if not outputs:
            return []
        if merge_batches:
            n_out = len(outputs[0])
            merged = [nd.concat(*[b[i] for b in outputs], dim=0)
                      for i in range(n_out)]
            return merged[0] if n_out == 1 else merged
        return outputs

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """The reference's one-call training loop."""
        if num_epoch is None:
            raise MXNetError("num_epoch is required for fit")
        from .. import initializer as _init

        initializer = initializer or _init.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    for cb in _as_list(batch_end_callback):
                        cb(_BatchEndParam(epoch, nbatch, eval_metric))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_p, aux_p = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    def install_monitor(self, monitor):
        pass

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    @property
    def symbol(self):
        return getattr(self, "_symbol", None)


class _BatchEndParam:
    __slots__ = ("epoch", "nbatch", "eval_metric", "locals")

    def __init__(self, epoch, nbatch, eval_metric):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = None


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]

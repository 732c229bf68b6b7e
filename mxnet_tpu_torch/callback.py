"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py`` (reference
``python/mxnet/callback.py``): ``Speedometer`` (samples/s and the metrics
every ``frequent`` batches), ``ProgressBar``, ``do_checkpoint`` (the
epoch-end ``.params`` save of ``serialization.save_checkpoint``),
``log_train_metric`` and ``LogValidationMetricsCallback``.
"""
from __future__ import annotations

import logging
import math
import sys
import time

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint", "log_train_metric",
           "LogValidationMetricsCallback"]


class Speedometer:
    """Log throughput + metrics every ``frequent`` batches (reference:
    ``mx.callback.Speedometer``)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                try:
                    speed = self.frequent * self.batch_size / (
                        time.time() - self.tic)
                except ZeroDivisionError:
                    speed = float("inf")
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    msg += "\t%s=%f" * len(name_value)
                    logging.info(msg, param.epoch, count, speed,
                                 *sum(name_value, ()))
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        sys.stdout.write(f"[{prog_bar}] {percents}%\r")


class BatchEndParam:
    """The namedtuple-like param passed to batch-end callbacks (reference:
    ``mx.model.BatchEndParam``)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint callback (reference ``mx.callback.
    do_checkpoint`` — saves symbol+params via module.save_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            from . import serialization

            serialization.save_checkpoint(prefix, iter_no + 1, sym,
                                          arg or {}, aux or {})

    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class LogValidationMetricsCallback:
    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)

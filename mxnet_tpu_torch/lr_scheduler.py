"""Learning-rate schedulers.

Counterpart of ``mxnet_tpu/lr_scheduler.py`` (reference
``python/mxnet/lr_scheduler.py``), ported whole: the ``LRScheduler`` base
with linear or constant warmup and the Factor/MultiFactor/Poly/Cosine
schedules, consulted by the optimizer per update count (``num_update``),
not per epoch.  Pure Python.
"""
from __future__ import annotations

import math

from .base import MXNetError

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        if warmup_steps < 0:
            raise MXNetError("warmup_steps must be >= 0")
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        if warmup_mode not in ("linear", "constant"):
            raise MXNetError(f"bad warmup_mode {warmup_mode!r}")
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            increase = (self.warmup_final_lr - self.warmup_begin_lr) * \
                float(num_update) / float(self.warmup_steps)
            return self.warmup_begin_lr + increase
        return self.warmup_begin_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates (reference ``FactorScheduler``)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise MXNetError("step must be >= 1")
        if factor > 1.0:
            raise MXNetError("factor must be <= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(step, list) or not step:
            raise MXNetError("step must be a non-empty list")
        for i, s in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise MXNetError("steps must be increasing")
            if s < 1:
                raise MXNetError("steps must be >= 1")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(max_update, int):
            raise MXNetError("max_update must be an int")
        if max_update < 1:
            raise MXNetError("max_update must be >= 1")
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + \
                (self.base_lr_orig - self.final_lr) * pow(
                    1 - float(num_update - self.warmup_steps) /
                    float(self.max_steps), self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(max_update, int):
            raise MXNetError("max_update must be an int")
        if max_update < 1:
            raise MXNetError("max_update must be >= 1")
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (
                self.base_lr_orig - self.final_lr) * (1 + math.cos(
                    math.pi * (num_update - self.warmup_steps) /
                    self.max_steps)) / 2
        return self.base_lr

"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``; reference
``python/mxnet/gluon/data/sampler.py``)."""
from __future__ import annotations

import numpy as np

from ...base import MXNetError

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A fresh ``np.random.permutation`` an epoch (numpy's global
    generator, as in the reference)."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(np.random.permutation(self._length))

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Group a sampler into batches; ``last_batch`` is 'keep', 'discard'
    or 'rollover' (reference ``BatchSampler``)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []
        if last_batch not in ("keep", "discard", "rollover"):
            raise MXNetError(
                f"last_batch must be keep/discard/rollover, got {last_batch}")

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // \
                self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._sampler) + len(self._prev)) // self._batch_size

"""Top-level ``mx.rnn`` namespace: ``BucketSentenceIter`` and the legacy
cell names.

Counterpart of ``mxnet_tpu/rnn/__init__.py`` (reference
``python/mxnet/rnn/{io,rnn_cell}.py``).  Each batch comes from one
bucket, padded to that bucket's length, so each bucket is one shape (on
the card: one CUDA graph of a hybridized net).  The legacy cell names are
the ``gluon.rnn`` cells.  Batches are made on the context current when
the iterator was built, as ``io.NDArrayIter``'s are.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..context import current_context
from ..io import DataBatch, DataDesc, _to_device
from ..gluon.rnn import (LSTMCell, GRUCell, RNNCell,  # noqa: F401
                         SequentialRNNCell)
from ..ndarray import NDArray  # noqa: F401

__all__ = ["BucketSentenceIter", "LSTMCell", "GRUCell", "RNNCell",
           "SequentialRNNCell"]


class BucketSentenceIter:
    """Reference ``mx.rnn.BucketSentenceIter``: variable-length token
    sequences bucketed by length; each batch comes from one bucket,
    padded with ``invalid_label`` to its length, with ``bucket_key``, and
    the label is the data shifted one step left."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="int32",
                 layout="NT", seed=1):
        if not buckets:
            lengths = [len(s) for s in sentences]
            ladder = (8, 16, 32, 64, 128, 256, 512)
            fitting = [n for n in lengths if n <= ladder[-1]]
            if not fitting:
                raise MXNetError("no bucket can hold the given sentences")
            # the smallest rung over the longest fitting sentence caps the
            # ladder; longer sentences are discarded below
            top = next(b for b in ladder if max(fitting) <= b)
            buckets = [b for b in ladder if b <= top]
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self._dtype = np.dtype(dtype)
        self._ctx = current_context()
        self.data = [[] for _ in self.buckets]
        ndiscard = 0
        for s in sentences:
            idx = next((i for i, b in enumerate(self.buckets)
                        if len(s) <= b), None)
            if idx is None:
                ndiscard += 1
                continue
            buf = np.full((self.buckets[idx],), invalid_label, self._dtype)
            buf[:len(s)] = s
            self.data[idx].append(buf)
        if ndiscard:
            print(f"WARNING: discarded {ndiscard} sentences longer than "
                  f"the largest bucket")
        self.data = [np.asarray(x) for x in self.data]
        self.default_bucket_key = max(self.buckets)
        self._plan = []
        self._shuffled = [None] * len(self.buckets)
        # one generator across resets: each epoch shuffles anew, a run is
        # reproducible from ``seed``
        self._rng = np.random.RandomState(seed)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size, self.default_bucket_key))]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.default_bucket_key))]

    def reset(self):
        self._plan = []
        rng = self._rng
        for i, arr in enumerate(self.data):
            if len(arr) == 0:
                continue
            order = rng.permutation(len(arr))
            self._shuffled[i] = arr[order]
            for lo in range(0, len(arr) - self.batch_size + 1,
                            self.batch_size):
                self._plan.append((i, lo))
        rng.shuffle(self._plan)
        self._cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        i, lo = self._plan[self._cursor]
        self._cursor += 1
        buf = self._shuffled[i][lo:lo + self.batch_size]
        label = np.full_like(buf, self.invalid_label)
        label[:, :-1] = buf[:, 1:]
        return DataBatch(
            data=[_to_device(buf, self._ctx)],
            label=[_to_device(label, self._ctx)], pad=0,
            bucket_key=self.buckets[i],
            provide_data=[DataDesc(self.data_name, buf.shape)],
            provide_label=[DataDesc(self.label_name, label.shape)])

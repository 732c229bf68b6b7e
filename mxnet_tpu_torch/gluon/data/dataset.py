"""Gluon datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``;
reference ``python/mxnet/gluon/data/dataset.py``)."""
from __future__ import annotations

import os
import threading

from ...base import MXNetError
from ...ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([s for s in self if fn(s)])

    def shard(self, num_shards, index):
        if not 0 <= index < num_shards:
            raise MXNetError(f"shard index {index} out of range for "
                             f"{num_shards} shards")
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count):
        return SimpleDataset([self[i] for i in
                              range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirst(fn), lazy)


class _TransformFirst:
    """``fn`` on a sample's first element (a class, not a closure, so a
    transformed dataset pickles into process workers)."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Zip of equal-length arrays (reference ``ArrayDataset``)."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise MXNetError(f"all arrays must have the same length; "
                                 f"arg {i} differs")
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over an indexed RecordIO file (reference
    ``RecordFileDataset``): item ``i`` is the raw record of the ``.idx``'s
    ``i``-th key.  A lock makes each seek and read one step, so thread
    workers may share the dataset; it pickles into process workers (each
    reopens the file)."""

    def __init__(self, filename):
        from ... import recordio

        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                  self.filename, "r")
        self._lock = threading.Lock()

    def __getstate__(self):
        d = dict(self.__dict__)
        del d["_lock"]
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()

    def __getitem__(self, idx):
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)

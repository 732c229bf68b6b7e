"""Data iterators (the ``mx.io`` surface).

Counterpart of ``mxnet_tpu/io/__init__.py`` (reference
``python/mxnet/io/io.py`` and the C++ iterators of ``src/io/``):
``DataDesc``, ``DataBatch``, ``DataIter``, ``NDArrayIter``, ``CSVIter``,
``ResizeIter``, ``PrefetchingIter``, ``ImageRecordIter`` and
``MNISTIter``.

Iterators build host (numpy) batches and place each on the context that
was current when the iterator was made, in one copy a batch; on a card
the copy is from pinned memory and does not block the host.
``ImageRecordIter`` reads records through the native prefetcher
(``_native``; ``no_native=True`` is the explicit Python reader), decodes
on ``preprocess_threads`` threads, applies the geometric augmentations on
the host in the reference's draw order, and runs the numeric half (cast,
scale, mean, std, NCHW) as torch ops on the batch's device after a uint8
copy.

``LibSVMIter`` reads LibSVM text into ``CSRNDArray`` batches
(``ndarray/sparse.py``) on the iterator's context, with the label file
override and ``round_batch`` wrap-around padding of the reference.
"""
from __future__ import annotations

import os
import queue as _queue
import threading
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..base import MXNetError
from ..context import current_context
from ..ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "ResizeIter", "PrefetchingIter",
           "ImageRecordIter", "MNISTIter"]



def _to_device(host, ctx):
    """One host numpy array as an NDArray on ``ctx``: on a card, copied
    from pinned memory without blocking the host (torch's pinned
    allocator keeps the buffer until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if ctx.device.type == "cuda":
        t = t.pin_memory().to(ctx.device, non_blocking=True)
    return NDArray(t)


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Shape and type descriptor (reference ``mx.io.DataDesc``)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One batch: data list, label list, pad and index bookkeeping."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator base (reference ``mx.io.DataIter``)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and not data:
            raise MXNetError("data cannot be empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise MXNetError(
            "data must be NDArray, numpy.ndarray, list or dict of them")
    return [(k, np.asarray(v.asnumpy() if isinstance(v, NDArray) else v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Batches over in-memory arrays with shuffle and pad/discard
    last-batch handling (reference ``mx.io.NDArrayIter``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self._ctx = current_context()
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:],
                         dtype=v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:],
                         dtype=v.dtype) for k, v in self.label]

    def reset(self):
        self.cursor = 0
        if self.shuffle:
            self.order = np.random.permutation(self.num_data)
        else:
            self.order = np.arange(self.num_data)

    def iter_next(self):
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        lo = self.cursor
        hi = min(lo + self.batch_size, self.num_data)
        idx = self.order[lo:hi]
        pad = self.batch_size - len(idx)
        if pad and self.last_batch_handle == "pad":
            idx = np.concatenate([idx, self.order[:pad]])
        self.cursor += self.batch_size
        data = [_to_device(arr[idx], self._ctx) for _, arr in self.data]
        label = [_to_device(arr[idx], self._ctx) for _, arr in self.label]
        return DataBatch(data=data, label=label or None, pad=pad,
                         index=idx, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def getpad(self):
        return 0


class CSVIter(DataIter):
    """CSV reader (reference C++ ``CSVIter``, ``src/io/iter_csv.cc``)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2).reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard")

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label


class LibSVMIter(DataIter):
    """LibSVM text reader to CSR batches (reference C++ ``LibSVMIter``,
    ``src/io/iter_libsvm.cc``): each line ``label idx:value ...``; a
    ``label_libsvm`` file overrides the labels (one row a data row);
    with ``round_batch`` the last batch wraps around to the first rows
    (``pad`` counts them), else it is dropped when short.  Batches lie
    on the context current at construction."""

    def __init__(self, data_libsvm, data_shape, batch_size=1,
                 label_libsvm=None, round_batch=True, **kwargs):
        super().__init__(batch_size)
        self._num_features = int(data_shape[0]) \
            if isinstance(data_shape, (tuple, list)) else int(data_shape)
        labels, indices, values = [], [], []
        indptr = [0]
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    i, v = tok.split(":")
                    indices.append(int(i))
                    values.append(float(v))
                indptr.append(len(indices))
        if label_libsvm is not None:
            labels = []
            with open(label_libsvm) as f:
                for line in f:
                    parts = line.split()
                    if parts:
                        labels.append(float(parts[0]))
            if len(labels) != len(indptr) - 1:
                raise MXNetError(
                    f"label file has {len(labels)} rows but data file has "
                    f"{len(indptr) - 1}")
        self._labels = np.asarray(labels, np.float32)
        self._indptr = np.asarray(indptr, np.int64)
        self._indices = np.asarray(indices, np.int64)
        self._values = np.asarray(values, np.float32)
        self._n = len(labels)
        self._cursor = 0
        self._round = round_batch
        self._ctx = current_context()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._num_features))]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        self._cursor = 0

    def _rows(self, lo, hi):
        """(values, indices, indptr) of rows [lo, hi), on the host."""
        start, end = self._indptr[lo], self._indptr[hi]
        return (self._values[start:end], self._indices[start:end],
                self._indptr[lo:hi + 1] - start)

    def next(self):
        from ..ndarray import sparse as sp

        if self._cursor >= self._n:
            raise StopIteration
        lo = self._cursor
        hi = min(lo + self.batch_size, self._n)
        pad = self.batch_size - (hi - lo)
        if pad and not self._round:
            raise StopIteration
        vals, idx, ptr = self._rows(lo, hi)
        label = self._labels[lo:hi]
        if pad:
            # wrap around to the first rows, as often as a batch larger
            # than the data needs
            vals, idx, ptrs, labels = [vals], [idx], [ptr], [label]
            remaining = pad
            while remaining > 0:
                take = min(remaining, self._n)
                v, i, p = self._rows(0, take)
                vals.append(v)
                idx.append(i)
                ptrs.append(p[1:] + ptrs[-1][-1])
                labels.append(self._labels[:take])
                remaining -= take
            vals, idx = np.concatenate(vals), np.concatenate(idx)
            ptr, label = np.concatenate(ptrs), np.concatenate(labels)
        self._cursor = hi
        csr = sp.CSRNDArray(_to_device(vals, self._ctx),
                            _to_device(idx, self._ctx),
                            _to_device(ptr, self._ctx),
                            (self.batch_size, self._num_features))
        return DataBatch(data=[csr], label=[_to_device(label, self._ctx)],
                         pad=pad)


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches an epoch
    (reference ``mx.io.ResizeIter``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label


class PrefetchingIter(DataIter):
    """Threaded prefetch decorator (reference ``mx.io.PrefetchingIter``):
    one thread runs the wrapped iterator ahead of the consumer."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter wraps one iterator")
        self.iter = iters[0]
        super().__init__(self.iter.batch_size)
        self._depth = prefetch_depth
        self._start()

    def _start(self):
        self._queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        q, stop, it = self._queue, self._stop, self.iter

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                try:
                    batch = it.next()
                except StopIteration:
                    put(None)
                    return
                except Exception as e:  # raised at the consumer's next()
                    put(e)
                    return
                if not put(batch):
                    return

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="mxt-io-prefetch")
        self._thread.start()

    def _halt(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        self._thread.join(timeout=5)

    def reset(self):
        self._halt()
        self.iter.reset()
        self._start()

    def close(self):
        self._halt()

    def next(self):
        item = self._queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label


def _numeric_finish(x, mean, std, scale):
    """The numeric half of the augmentation on the batch's device: (B, H,
    W, C) uint8 to contiguous (B, C, H, W) float32, times ``scale``, minus
    ``mean``, over ``std`` (tensors on ``x``'s device, or None where the
    step is the identity, as in the reference)."""
    y = x.to(torch.float32)
    if scale != 1.0:
        y = y * scale
    if mean is not None:
        y = y - mean
    if std is not None:
        y = y / std
    return y.permute(0, 3, 1, 2).contiguous()


class ImageRecordIter(DataIter):
    """RecordIO image pipeline: read, decode, augment, batch (reference
    C++ ``ImageRecordIter``, ``src/io/iter_image_recordio_2.cc``).

    The native prefetcher reads ``prefetch_buffer`` batches of records
    ahead on ``preprocess_threads`` engine threads; ``next()`` decodes the
    batch on a pool of ``preprocess_threads`` threads (OpenCV releases the
    GIL), draws the crops and mirrors in record order from one
    ``np.random.RandomState(seed)`` (the reference's draws, so the two
    packages give the same batches), copies the uint8 batch to the
    iterator's context and finishes it there."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 rand_crop=False, rand_mirror=False, resize=-1,
                 path_imgidx=None, num_parts=1, part_index=0,
                 preprocess_threads=2, prefetch_buffer=2,
                 round_batch=True, seed=0, no_native=False, **kwargs):
        super().__init__(batch_size)
        from .. import recordio

        self._ctx = current_context()
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._rng = np.random.RandomState(seed)
        self._aug = dict(rand_crop=rand_crop, rand_mirror=rand_mirror,
                         resize=resize)
        # the normalization's constants live on the context from the
        # start: a copy made for each batch would wait for the card
        mean = np.asarray((mean_r, mean_g, mean_b), np.float32)
        std = np.asarray((std_r, std_g, std_b), np.float32)
        self._scale = float(scale)
        self._mean = torch.from_numpy(mean).to(self._ctx.device) \
            if mean.any() else None
        self._std = torch.from_numpy(std).to(self._ctx.device) \
            if (std != 1).any() else None
        self._pool = ThreadPoolExecutor(
            max_workers=max(int(preprocess_threads), 1),
            thread_name_prefix="mxt-imdecode")
        self._pf = None
        self._records = None
        if not no_native:
            from .. import _native

            # one prefetcher for the iterator's life: the index scan and
            # the thread pool happen once, not every epoch
            self._cap = max(int(prefetch_buffer), 1)
            self._pf = _native.Prefetcher(path_imgrec,
                                          nthreads=preprocess_threads,
                                          capacity=self._cap)
            self._sched = self._consumed = 0
            self._batches = []
            if path_imgidx and os.path.isfile(path_imgidx):
                # shard in the .idx's key order (a pre-shuffle or a
                # subset), mapping byte offsets to scan-order indices
                off2pos = {self._pf.offset(i): i
                           for i in range(len(self._pf))}
                positions = [off2pos[off] for _, off in
                             recordio.read_idx_file(path_imgidx)]
                self._indices = np.asarray(
                    positions[part_index::num_parts], dtype=np.int64)
            else:
                self._indices = np.arange(
                    len(self._pf))[part_index::num_parts]
        else:
            # the Python reader: the shard's records in memory
            if path_imgidx:
                rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec,
                                                 "r")
                keys = rec.keys
            else:
                rec = recordio.MXRecordIO(path_imgrec, "r")
                keys = None
            self._records = []
            if keys is not None:
                for k in keys[part_index::num_parts]:
                    self._records.append(rec.read_idx(k))
            else:
                i = 0
                while True:
                    payload = rec.read()
                    if payload is None:
                        break
                    if i % num_parts == part_index:
                        self._records.append(payload)
                    i += 1
            rec.close()
        self.shuffle = shuffle
        self.round_batch = round_batch
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def _plan_batches(self, order):
        """An epoch order as (index array, pad) batch plans; the last
        batch wraps around the order (a shard smaller than one batch
        still fills it)."""
        plans = []
        for s in range(0, len(order), self.batch_size):
            idx = order[s:s + self.batch_size]
            pad = self.batch_size - len(idx)
            if pad:
                if not self.round_batch:
                    break
                idx = np.concatenate([idx, np.resize(order, pad)])
            plans.append((idx, pad))
        return plans

    def reset(self):
        if self._pf is not None:
            # drain batches scheduled but not consumed (an early reset)
            while self._consumed < self._sched:
                self._pf.next()
                self._consumed += 1
            order = self._indices.copy()
            if self.shuffle:
                self._rng.shuffle(order)
            self._batches = self._plan_batches(order)
            self._sched = self._consumed = 0
            while self._sched < min(len(self._batches), self._cap + 1):
                self._pf.schedule(self._batches[self._sched][0])
                self._sched += 1
        else:
            order = np.arange(len(self._records))
            if self.shuffle:
                self._rng.shuffle(order)
            self._batches = self._plan_batches(order)
            self._consumed = 0

    def _make_batch(self, payloads, pad):
        from .. import recordio
        from ..image import augment_geom, imdecode_raw

        unpacked = [recordio.unpack(p) for p in payloads]
        images = list(self._pool.map(lambda hp: imdecode_raw(hp[1]),
                                     unpacked))
        datas, labels = [], []
        for (header, _), img in zip(unpacked, images):
            datas.append(augment_geom(
                img, self.data_shape, self._rng,
                rand_crop=self._aug["rand_crop"],
                rand_mirror=self._aug["rand_mirror"],
                resize=self._aug["resize"]))
            label = header.label
            if isinstance(label, np.ndarray) and self.label_width == 1:
                label = label[0] if label.size else 0.0
            labels.append(label)
        batch_u8 = _to_device(np.stack(datas), self._ctx)
        data = NDArray(_numeric_finish(batch_u8._data, self._mean,
                                       self._std, self._scale))
        label = _to_device(np.asarray(labels, dtype=np.float32), self._ctx)
        return DataBatch(data=[data], label=[label], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def next(self):
        if self._consumed >= len(self._batches):
            raise StopIteration
        idx, pad = self._batches[self._consumed]
        self._consumed += 1
        if self._pf is not None:
            payloads = self._pf.next()
            if self._sched < len(self._batches):
                self._pf.schedule(self._batches[self._sched][0])
                self._sched += 1
        else:
            payloads = [self._records[i] for i in idx]
        return self._make_batch(payloads, pad)

    def close(self):
        """Stop the reader and decode threads."""
        if self._pf is not None:
            self._pf.close()
        self._pool.shutdown(wait=True)


class MNISTIter(NDArrayIter):
    """MNIST idx-format reader (reference ``src/io/iter_mnist.cc``)."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, **kwargs):
        from ..gluon.data.vision.datasets import _read_idx

        images = _read_idx(image).astype(np.float32) / 255.0
        labels = _read_idx(label).astype(np.float32)
        if flat:
            images = images.reshape(len(images), -1)
        else:
            images = images.reshape(len(images), 1, *images.shape[1:])
        super().__init__(images, labels, batch_size, shuffle=shuffle,
                         last_batch_handle="discard")

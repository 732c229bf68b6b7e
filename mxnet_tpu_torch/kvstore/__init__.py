"""KVStore: gradient aggregation and parameter distribution.

Counterpart of ``mxnet_tpu/kvstore/__init__.py`` (reference
``src/kvstore/``).  ``local``/``device`` (and their aliases) are the
single-process store: with one device there is nothing to reduce, so
``push`` stores the pushed value (a list pushed to one key is summed)
and ``pull`` binds the target to it; with an updater installed
(``set_optimizer``, ``set_updater``: ``update_on_kvstore``) a push
updates the stored weight in place instead.  Gradient compression
quantizes each pushed value with its per-key residual.

``dist_tpu_sync`` and its aliases ``dist_sync``, ``dist_device_sync``
and ``horovod`` return ``parallel.TPUSyncKVStore``, the synchronous
store (NCCL on the card, gloo on the host), with the reference's alias
warning.  ``dist_async`` returns ``dist_async.AsyncPSKVStore``, the
asynchronous parameter server (its wire is the reference's).

Row-sparse values (``ndarray/sparse.py``) pass through every store: a
pushed ``RowSparseNDArray`` reaches the updater as it is (the
optimizers' lazy row update), a list of them is summed over the union
of their rows, and ``row_sparse_pull`` gives a ``RowSparseNDArray``
target the requested rows, or writes only those rows of a dense target
in place (the reference's ``PullRowSparse``).

Telemetry, under the reference's names: the ``kvstore.push`` and
``kvstore.pull`` spans and the ``kvstore.push_bytes`` /
``kvstore.pull_bytes`` counters (a row-sparse value counts its stored
rows and indices; ``row_sparse_pull`` counts the rows it pulls).
"""
from __future__ import annotations

import warnings

import torch

from .. import telemetry
from ..telemetry import memwatch as _mw
from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray import sparse as sp

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu",
          "local_allreduce_device", "device", "nccl")
_SYNC = ("dist_tpu_sync", "dist_sync", "dist_device_sync", "horovod")


class KVStore:
    """Single-process store: ``local``/``device`` (reference
    ``KVStoreLocal``)."""

    def __init__(self, name="local"):
        self.type = name
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._residuals = {}

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        """Store a copy of each value (a key already held is kept)."""
        for k, v in zip(*_pairs(key, value)):
            if str(k) not in self._store:
                self._store[str(k)] = _merge(v).copy()

    def push(self, key, value, priority=0):
        """Aggregate value(s) into the store: a list pushed to one key is
        summed (the reference's device reduce); with an updater the stored
        weight is updated in place, else the value replaces it."""
        with telemetry.span("kvstore.push"):
            self._push_impl(key, value)

    def _push_impl(self, key, value):
        keys, values = _pairs(key, value)
        if telemetry.is_enabled():
            telemetry.count("kvstore.push_bytes",
                            sum(telemetry.nbytes_of(v) for v in values))
        for k, v in zip(keys, values):
            k = str(k)
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            merged = _merge(v)
            if self._compression is not None:
                merged, self._residuals[k] = self._compression.roundtrip(
                    _dense(merged), self._residuals.get(k))
            if self._updater is not None:
                self._updater(int(k) if k.isdigit() else k, merged,
                              self._store[k])
            else:
                self._store[k] = merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Bind each target to the stored value (cast to the target's
        dtype; no copy when it already has it).  With an updater the
        stored value is the weight the store owns, so the target gets a
        copy of it."""
        with telemetry.span("kvstore.pull"):
            self._pull_impl(key, out)

    def _pull_impl(self, key, out):
        keys, outs = _pairs(key, out)
        if telemetry.is_enabled():
            telemetry.count("kvstore.pull_bytes",
                            sum(telemetry.nbytes_of(o) for o in outs))
        for k, o in zip(keys, outs):
            k = str(k)
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            stored = _dense(self._store[k])._data
            for target in (o if isinstance(o, (list, tuple)) else [o]):
                if isinstance(target, sp.RowSparseNDArray):
                    sp.cast_storage(NDArray(stored), "row_sparse") \
                        .copyto(target)
                elif self._updater is not None:
                    with torch.no_grad():
                        target._data.copy_(stored)
                else:
                    target._data = stored.to(target.dtype)
                    if _mw._enabled:
                        _mw.track(target._data)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def broadcast(self, key, value, out=None, priority=0):
        """``init`` then ``pull`` (reference ``KVStore.broadcast``)."""
        self.init(key, value)
        if out is not None:
            self.pull(key, out, priority)

    def allreduce_grads(self, params):
        """The Trainer's hook: ``init``/``push``/``pull`` each gradient
        under its index in ``params``."""
        for i, param in enumerate(params):
            if param.grad_req != "null":
                self.init(i, param.grad())
                self.push(i, param.grad())
                self.pull(i, param.grad())
        return params

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` (reference ``PullRowSparse``,
        the embedding-table path): a ``RowSparseNDArray`` target gets
        them, a dense target has just those rows written in place."""
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        keys, outs = _pairs(key, out)
        rids = row_ids if isinstance(row_ids, (list, tuple)) and \
            isinstance(key, (list, tuple)) else [row_ids] * len(keys)
        with telemetry.span("kvstore.pull"):
            for k, o, r in zip(keys, outs, rids):
                k = str(k)
                if k not in self._store:
                    raise MXNetError(f"key {k!r} not initialized")
                dense = _dense(self._store[k])._data
                idx = sp._index_tensor(r, dense.device)
                rows = dense[idx]
                if telemetry.is_enabled():
                    telemetry.count("kvstore.pull_bytes",
                                    telemetry.nbytes_of(rows) +
                                    telemetry.nbytes_of(idx))
                write_rows(o, idx, rows, dense.shape)

    def set_optimizer(self, optimizer):
        """Updates move into the store (``update_on_kvstore``)."""
        from .. import optimizer as opt_mod

        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)

    def set_updater(self, updater):
        """``updater(key, grad, stored_weight)`` runs at each push."""
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """2-bit compression with a per-key residual on pushed values
        (``gradient_compression.py``)."""
        from . import gradient_compression as gc

        self._compression = gc.create(compression_params)
        self._residuals = {}

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer installed on this kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer installed on this kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def _pairs(key, value):
    if isinstance(key, (list, tuple)):
        return list(key), list(value)
    return [key], [value]


def _merge(v):
    """One value: a list of values is summed (row_sparse ones over the
    union of their rows, others dense)."""
    if isinstance(v, (list, tuple)):
        total = v[0]
        for x in v[1:]:
            total = _add(total, x)
        return total
    return v


def _add(a, b):
    if isinstance(a, sp.RowSparseNDArray) and \
            isinstance(b, sp.RowSparseNDArray):
        return sp.add(a, b)
    return NDArray(_dense(a)._data + _dense(b)._data)


def _dense(v):
    return v.todense() if isinstance(v, sp.BaseSparseNDArray) else v


def write_rows(targets, idx, rows, shape):
    """Deliver pulled rows ``rows`` (at ``idx`` of a table of ``shape``):
    a ``RowSparseNDArray`` target takes them; a dense target has only
    those rows written, in place, on its own device and in its dtype."""
    for target in (targets if isinstance(targets, (list, tuple))
                   else [targets]):
        if isinstance(target, sp.RowSparseNDArray):
            sp.RowSparseNDArray(NDArray(rows.clone()), idx.clone(),
                                shape).copyto(target)
        else:
            t = target._data
            with torch.no_grad():
                t[idx.to(t.device)] = rows.to(device=t.device,
                                              dtype=t.dtype)


def create(name="local"):
    """Reference ``mx.kv.create``: a store by type name."""
    if isinstance(name, KVStore):
        return name
    if not isinstance(name, str):
        raise MXNetError("kvstore name must be a string")
    lname = name.lower()
    if lname in _LOCAL:
        return KVStore(lname)
    if lname in _SYNC:
        from ..parallel import TPUSyncKVStore

        if lname != "dist_tpu_sync":
            warnings.warn(
                f"kvstore {name!r} maps to 'dist_tpu_sync' on this backend "
                "(NCCL all-reduce over the process group replaces "
                "ps-lite)")
        return TPUSyncKVStore()
    if lname == "dist_async":
        from .dist_async import AsyncPSKVStore

        return AsyncPSKVStore()
    raise MXNetError(f"unknown kvstore type {name!r}")


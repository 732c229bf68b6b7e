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
asynchronous parameter server (host-side: its table and updates live in
host memory, its wire is the reference's).  ``row_sparse_pull`` raises
(sparse storage, Queue 1 item 8e).
"""
from __future__ import annotations

import warnings

from ..base import MXNetError
from ..ndarray import NDArray

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
                self._store[str(k)] = NDArray(_merge(v)._data.clone())

    def push(self, key, value, priority=0):
        """Aggregate value(s) into the store: a list pushed to one key is
        summed (the reference's device reduce); with an updater the stored
        weight is updated in place, else the value replaces it."""
        for k, v in zip(*_pairs(key, value)):
            k = str(k)
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            merged = _merge(v)
            if self._compression is not None:
                merged, self._residuals[k] = self._compression.roundtrip(
                    merged, self._residuals.get(k))
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
        for k, o in zip(*_pairs(key, out)):
            k = str(k)
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            stored = self._store[k]._data
            for target in (o if isinstance(o, (list, tuple)) else [o]):
                if self._updater is not None:
                    import torch

                    with torch.no_grad():
                        target._data.copy_(stored)
                else:
                    target._data = stored.to(target.dtype)

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
        raise MXNetError("KVStore.row_sparse_pull (sparse storage) is not "
                         "ported yet (ROADMAP.md, Queue 1 item 8e)")

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
    """One NDArray: a list of values is summed."""
    if isinstance(v, (list, tuple)):
        total = v[0]._data
        for x in v[1:]:
            total = total + x._data
        return NDArray(total)
    return v


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

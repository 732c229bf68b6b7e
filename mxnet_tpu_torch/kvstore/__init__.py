"""KVStore: gradient aggregation for one device.

Counterpart of ``mxnet_tpu/kvstore/__init__.py`` (reference
``src/kvstore/kvstore_local.h``) for the single-process, single-device
types ``local``/``device`` (and their aliases).  With one device there is
nothing to reduce: ``push`` stores the pushed value and ``pull`` binds
the target to it, so a push then a pull leaves a gradient as it was and
moves no data.  The store keeps the tensor it was given, not a copy.

The distributed types (``dist_*``, ``horovod``) raise ``MXNetError``: an
NCCL all-reduce across cards ports with multi-GPU (ROADMAP Queue 1
item 5), as do server-side updates (``set_optimizer``) and gradient
compression.
"""
from __future__ import annotations

from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu",
          "local_allreduce_device", "device", "nccl")
_MULTI_GPU = "is not ported yet (ROADMAP.md, Queue 1 item 5, multi-GPU)"


class KVStore:
    """Single-device store: ``local``/``device`` (reference
    ``KVStoreLocal``)."""

    def __init__(self, name="local"):
        self.type = name
        self._store = {}

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        for k, v in zip(*_pairs(key, value)):
            self._store.setdefault(str(k), NDArray(v._data))

    def push(self, key, value, priority=0):
        """Store value(s) under key(s); a list pushed to one key is
        summed (the reference's device reduce)."""
        for k, v in zip(*_pairs(key, value)):
            k = str(k)
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            if isinstance(v, (list, tuple)):
                total = v[0]._data
                for x in v[1:]:
                    total = total + x._data
                v = NDArray(total)
            self._store[k] = v

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Bind each target to the stored value (cast to the target's
        dtype; no copy when it already has it)."""
        for k, o in zip(*_pairs(key, out)):
            k = str(k)
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            stored = self._store[k]._data
            for target in (o if isinstance(o, (list, tuple)) else [o]):
                target._data = stored.to(target.dtype)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def set_optimizer(self, optimizer):
        raise MXNetError(f"KVStore.set_optimizer (update_on_kvstore) "
                         f"{_MULTI_GPU}")

    def set_gradient_compression(self, compression_params):
        raise MXNetError(f"gradient compression {_MULTI_GPU}")


def _pairs(key, value):
    if isinstance(key, (list, tuple)):
        return list(key), list(value)
    return [key], [value]


def create(name="local"):
    """Reference ``mx.kv.create``: a store by type name."""
    if isinstance(name, KVStore):
        return name
    if not isinstance(name, str):
        raise MXNetError("kvstore name must be a string")
    lname = name.lower()
    if lname in _LOCAL:
        return KVStore(lname)
    if lname in ("dist_tpu_sync", "dist_sync", "dist_device_sync",
                 "dist_async", "horovod"):
        raise MXNetError(f"kvstore {name!r} {_MULTI_GPU}")
    raise MXNetError(f"unknown kvstore type {name!r}")

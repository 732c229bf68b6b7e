"""Sharded streaming readers over ``.rec``/``.idx`` shard sets.

Counterpart of ``mxnet_tpu/data/reader.py``.  The elastic data contract
says the checkpointed step IS the data-pipeline position: sample order
must be a pure function of ``(seed, step)``, identical at every world
size.  This module extends that contract from an in-memory array to a
directory of RecordIO shards:

- the **global sample table** is the concatenation of every shard's
  ``.idx`` keys, in shard order — a stable enumeration ``0..N-1`` that
  every host derives identically from the same file set;
- ``batch_indices_for_step`` composes ``elastic.global_batch_indices``
  with ``elastic.shard_indices``, so a 2→1→2-worker resize replays the
  exact same global batches (the data-plane tests hold it);
- ``read`` is random access via the ``.idx`` sidecar — a host only ever
  touches the bytes its rank draws, which is what makes the per-host
  partitioning real rather than read-everything-filter-later.

File handles are per-thread (``threading.local``): a seek+read pair on
one shared handle is not atomic, and the prefetch pipeline reads from
worker threads.
"""
from __future__ import annotations

import glob
import os
import threading

from .. import recordio
from ..base import MXNetError
from .. import elastic

__all__ = ["ShardedRecordReader"]


def _resolve_shards(path):
    """Expand ``path`` (one ``.rec``, a glob, a directory, or a list)
    into a sorted list of ``(rec, idx)`` pairs."""
    if isinstance(path, (list, tuple)):
        recs = [str(p) for p in path]
    elif os.path.isdir(path):
        recs = sorted(glob.glob(os.path.join(path, "*.rec")))
    elif any(ch in str(path) for ch in "*?["):
        recs = sorted(glob.glob(str(path)))
    else:
        recs = [str(path)]
    if not recs:
        raise MXNetError(f"no .rec shards found at {path!r}")
    pairs = []
    for rec in recs:
        idx = os.path.splitext(rec)[0] + ".idx"
        if not os.path.isfile(rec):
            raise MXNetError(f"record shard not found: {rec!r}")
        if not os.path.isfile(idx):
            raise MXNetError(
                f"missing .idx sidecar for shard {rec!r} (expected "
                f"{idx!r}; indexed random access needs it)")
        pairs.append((rec, idx))
    return pairs


class ShardedRecordReader:
    """Deterministic random-access reader over one or many RecordIO
    shards, sharded per host through ``elastic``.

    Parameters
    ----------
    path : str or list
        A ``.rec`` file, a glob, a directory of ``*.rec``, or an
        explicit list of ``.rec`` paths.  Each shard needs its ``.idx``
        sidecar.
    batch_size : int
        GLOBAL batch size (summed over ranks); must divide evenly by
        every world size the job may run at.
    seed, shuffle
        Forwarded to ``elastic.global_batch_indices``.
    """

    def __init__(self, path, batch_size, seed=0, shuffle=True):
        self._shards = _resolve_shards(path)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        # global sample table: position -> (shard_no, key); built from
        # the .idx sidecars alone (no record payload is touched)
        self._table = []
        for shard_no, (rec, idx_path) in enumerate(self._shards):
            keys = [k for k, _ in recordio.read_idx_file(idx_path)]
            if not keys:
                raise MXNetError(f"empty index {idx_path!r}")
            self._table.extend((shard_no, k) for k in keys)
        self._local = threading.local()
        self._opened = []  # every thread's handles, for close()
        self._opened_lock = threading.Lock()

    def __len__(self):
        return len(self._table)

    @property
    def num_shards(self):
        return len(self._shards)

    def _handle(self, shard_no):
        """Per-thread MXIndexedRecordIO handles (seek+read is stateful)."""
        handles = getattr(self._local, "handles", None)
        if handles is None:
            handles = self._local.handles = {}
        h = handles.get(shard_no)
        if h is None:
            rec, idx = self._shards[shard_no]
            h = handles[shard_no] = recordio.MXIndexedRecordIO(
                idx, rec, "r")
            with self._opened_lock:
                self._opened.append(h)
        return h

    def read(self, global_idx):
        """Raw record bytes for one global sample position."""
        shard_no, key = self._table[int(global_idx)]
        return self._handle(shard_no).read_idx(key)

    def batch_indices_for_step(self, step, world_size=None, rank=None):
        """This rank's slice of the step's global batch, as global
        sample positions.  Defaults to the live ``elastic.world_info``.
        """
        if world_size is None or rank is None:
            r, w = elastic.world_info()
            rank = r if rank is None else rank
            world_size = w if world_size is None else world_size
        return elastic.shard_for_step(len(self._table), self.batch_size,
                                      step, world_size, rank,
                                      seed=self.seed, shuffle=self.shuffle)

    def global_indices_for_step(self, step):
        """The FULL global batch for a step (every rank's draw) — what
        sequence packing consumes so all ranks pack identically."""
        return elastic.global_batch_indices(
            len(self._table), self.batch_size, step, seed=self.seed,
            shuffle=self.shuffle)

    def batch_for_step(self, step, world_size=None, rank=None):
        """Payload bytes for this rank's slice of the step's batch."""
        idxs = self.batch_indices_for_step(step, world_size, rank)
        return [self.read(i) for i in idxs]

    def close(self):
        """Close every thread's handles (a later read reopens its own)."""
        with self._opened_lock:
            opened, self._opened = self._opened, []
        for h in opened:
            h.close()
        self._local = threading.local()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

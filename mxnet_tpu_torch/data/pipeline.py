"""StreamingLoader: the step-keyed pipeline tying the data plane
together.

Counterpart of ``mxnet_tpu/data/pipeline.py``: reader (``.rec`` shards)
→ decode/transform on worker threads → optional sequence packing →
``DevicePrefetcher`` (the copy to the card on a stream of its own,
overlapped with the step in flight).

The loader is **step-keyed, not epoch-keyed**: batch N is a pure
function of ``(seed, step=N)`` through ``elastic``, so resuming from a
checkpoint at step S is just ``StreamingLoader(..., start_step=S)`` —
there is no sampler state to save, and a job resumed at a different
world size replays the identical global batch sequence
(the data-plane tests hold the 2→1→2 contract through this class).

Two modes:

- **sample mode** (``transform=``): each step draws THIS RANK's slice
  of the global batch, decodes each record with ``transform(raw_bytes)``
  on the worker threads, and stacks the samples;
- **packed mode** (``packer=`` + ``tokenize=``): each step decodes the
  FULL global draw (every rank tokenizes the same documents — the cost
  of rank-independent determinism), packs it with the shared
  ``SequencePacker``, then keeps this rank's contiguous row slice via
  ``elastic.shard_rows``.
"""
from __future__ import annotations

import threading

import numpy as np

from .. import elastic
from ..base import MXNetError
from .prefetch import DevicePrefetcher

__all__ = ["StreamingLoader"]


def _default_batchify(samples):
    """Stack decoded samples into one host batch (tuple samples →
    tuple of stacked arrays, the Gluon (data, label) convention)."""
    s0 = samples[0]
    if isinstance(s0, (tuple, list)):
        return tuple(np.stack([np.asarray(s[i]) for s in samples])
                     for i in range(len(s0)))
    return np.stack([np.asarray(s) for s in samples])


class StreamingLoader:
    """Elastic streaming loader over a ``ShardedRecordReader``.

    Parameters
    ----------
    reader : ShardedRecordReader
        Supplies raw record bytes + the deterministic (seed, step)
        index draw.
    transform : callable, optional
        ``raw_bytes -> sample`` decode for sample mode.
    packer : SequencePacker, optional
        Enables packed mode (requires ``tokenize``).  The packer's
        ``stats`` accumulate across the stream.
    tokenize : callable, optional
        ``raw_bytes -> 1-D int token array`` for packed mode.
    batchify : callable, optional
        Sample-mode stacking override (default stacks with np.stack).
    num_workers : int
        Decode worker threads; 0 decodes inline on the prefetch thread.
    prefetch_depth : int
        Device batches resident ahead of the consumer (2 = double
        buffer).
    ctx : Context, optional
        Where the batches go (default: the current context).
    mesh : DeviceMesh, optional
        Every rank assembles the global batch and the prefetcher copies
        only its ``dp`` rows (one sharded array over the mesh).
    start_step, num_steps
        First step to emit and how many (None = endless stream).
    world_size, rank
        Override the live ``elastic.world_info`` (tests).
    """

    def __init__(self, reader, *, transform=None, packer=None,
                 tokenize=None, batchify=None, num_workers=2,
                 prefetch_depth=2, mesh=None, start_step=0,
                 num_steps=None, world_size=None, rank=None, ctx=None):
        if packer is not None and tokenize is None:
            raise MXNetError("packed mode needs tokenize= (raw bytes -> "
                             "1-D int token array)")
        if packer is None and transform is None:
            raise MXNetError("need transform= (sample mode) or "
                             "packer= + tokenize= (packed mode)")
        self._reader = reader
        self._transform = transform
        self._packer = packer
        self._tokenize = tokenize
        self._batchify = batchify or _default_batchify
        self._num_workers = max(0, int(num_workers))
        self._prefetch_depth = max(1, int(prefetch_depth))
        self._start_step = int(start_step)
        self._num_steps = None if num_steps is None else int(num_steps)
        if world_size is None or rank is None:
            r, w = elastic.world_info()
            rank = r if rank is None else rank
            world_size = w if world_size is None else world_size
        if mesh is not None:
            # every rank assembles the global batch; the prefetcher
            # copies only its own dp rows of it
            world_size, rank = 1, 0
        self._world, self._rank = int(world_size), int(rank)
        self._stop = threading.Event()
        self._threads = []
        self._prefetcher = DevicePrefetcher(self._host_batches(),
                                            depth=self._prefetch_depth,
                                            mesh=mesh, ctx=ctx)

    @property
    def prefetcher(self):
        return self._prefetcher

    def stats(self):
        """The prefetcher's ``stats()``."""
        return self._prefetcher.stats()

    @property
    def packing_stats(self):
        return self._packer.stats if self._packer is not None else None

    # -- host-side assembly --------------------------------------------------

    def _build_host_batch(self, step):
        if self._packer is not None:
            # every rank decodes + packs the SAME global draw (packing
            # must be rank-independent for elastic parity), then keeps
            # its contiguous row slice
            idxs = self._reader.global_indices_for_step(step)
            docs = [self._tokenize(self._reader.read(i)) for i in idxs]
            batch = self._packer.pack(docs)
            rows = elastic.shard_rows(self._packer.batch_size,
                                      self._world, self._rank)
            return batch.rows(rows)
        idxs = self._reader.batch_indices_for_step(step, self._world,
                                                   self._rank)
        return self._batchify(
            [self._transform(self._reader.read(i)) for i in idxs])

    def _host_batches(self):
        """Ordered host-batch generator: ``num_workers`` threads decode
        steps ahead inside a bounded window, the generator yields them
        in step order (the DataLoader's order-restoration shape)."""
        end = (None if self._num_steps is None
               else self._start_step + self._num_steps)
        if self._num_workers == 0:
            step = self._start_step
            while (end is None or step < end) and \
                    not self._stop.is_set():
                yield self._build_host_batch(step)
                step += 1
            return

        results = {}
        cond = threading.Condition()
        next_fetch = [self._start_step]
        consumed = [self._start_step]
        errors = []
        window = self._prefetch_depth + self._num_workers
        stop = self._stop

        def worker():
            while True:
                with cond:
                    while (not stop.is_set() and not errors and
                           (end is None or next_fetch[0] < end) and
                           next_fetch[0] - consumed[0] >= window):
                        cond.wait(0.1)
                    if stop.is_set() or errors or \
                            (end is not None and next_fetch[0] >= end):
                        return
                    step = next_fetch[0]
                    next_fetch[0] += 1
                try:
                    batch = self._build_host_batch(step)
                except BaseException as exc:
                    with cond:
                        errors.append(exc)
                        cond.notify_all()
                    return
                with cond:
                    results[step] = batch
                    cond.notify_all()

        self._threads = [threading.Thread(target=worker,
                                          name=f"mxt-data-decode-{i}",
                                          daemon=True)
                         for i in range(self._num_workers)]
        for t in self._threads:
            t.start()
        step = self._start_step
        try:
            while end is None or step < end:
                with cond:
                    while step not in results and not errors and \
                            not stop.is_set():
                        cond.wait(0.1)
                    if errors:
                        raise errors[0]
                    if stop.is_set():
                        return
                    batch = results.pop(step)
                    consumed[0] = step + 1
                    cond.notify_all()
                yield batch
                step += 1
        finally:
            stop.set()
            with cond:
                cond.notify_all()
            for t in self._threads:
                t.join(timeout=5)

    # -- consumer API --------------------------------------------------------

    def get(self, timeout=None):
        """Next device-resident batch for this rank, in step order."""
        return self._prefetcher.get(timeout=timeout)

    def __iter__(self):
        return self

    def __next__(self):
        return self._prefetcher.get()

    def close(self):
        self._stop.set()
        self._prefetcher.close()
        for t in self._threads:
            t.join(timeout=5)
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Host-to-device prefetch on a CUDA stream of its own.

Counterpart of ``mxnet_tpu/data/prefetch.py``.  A producer thread pulls
host batches (numpy pytrees, host tensors or NDArrays, ``PackedBatch``)
from the source and, on a card:

- puts each leaf in page-locked memory (a leaf already pinned, as a
  ``DataLoader(pin_memory=True)`` batch, is used as it is);
- copies it with ``non_blocking=True`` on the prefetcher's own
  ``torch.cuda.Stream`` and records an event there after the batch;
- keeps the pinned host buffers alive until that event has completed.

``get()`` hands the batches out in order: it makes the consumer's current
stream wait for the batch's event (on the card; the host does not
synchronize) and marks every leaf with ``record_stream``, so the caching
allocator does not reuse its memory before the consumer's work on it has
run.  A graph replay (``FusedTrainStep``, a hybridized block) copies its
inputs on the current stream, so it runs after the copy too.

On the CPU (a ``cpu`` context) the leaves become host NDArrays and no
stream is involved.  ``stats()`` gives the consumer's wait (ms, p50/p99)
and the queue depth sampled at each ``get()``, as plain numbers.
Telemetry, under the reference's names, at each ``get()``: the wait as
``data.wait_ms``, the queue depth as the ``data.prefetch_depth`` gauge,
and ``data.overlap_dispatch`` when a later batch's copy had already been
issued as this one was handed out (the consumer's step then overlaps a
copy; the reference counts its dispatches during a copy).

With ``mesh=`` (a ``DeviceMesh`` with the ``axis_name`` axis, default
``dp``) the source yields the global batch and each rank copies only its
own rows of every leaf (dim 0 split over the axis), which ``get()``
hands out as one ``dp``-sharded array over the mesh
(``parallel.shard_batch``'s layout).
"""
from __future__ import annotations

import collections
import queue
import threading
import time

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError
from ..context import current_context
from ..ndarray import NDArray
from .packing import PackedBatch
from .. import engine  # noqa: F401  (the reference's import)

__all__ = ["DevicePrefetcher"]


def _map_leaves(fn, batch):
    """``fn`` on every array leaf of a batch (dict, tuple, list,
    PackedBatch, or a bare array)."""
    if isinstance(batch, PackedBatch):
        return PackedBatch(fn(batch.tokens), fn(batch.segment_ids),
                           fn(batch.labels), fn(batch.loss_mask))
    if isinstance(batch, dict):
        return {k: _map_leaves(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_leaves(fn, v) for v in batch)
    return fn(batch)


def _iter_leaves(batch):
    out = []
    _map_leaves(out.append, batch)
    return out


def _host_tensor(leaf):
    """A host leaf (numpy, tensor, NDArray, number) as a CPU tensor."""
    if isinstance(leaf, NDArray):
        leaf = leaf._data
    if isinstance(leaf, torch.Tensor):
        if leaf.is_cuda:
            raise MXNetError("DevicePrefetcher takes host batches; got a "
                             "leaf already on the card")
        return leaf
    return torch.from_numpy(np.ascontiguousarray(leaf))


def _percentile(values, q):
    return float(np.percentile(values, q)) if values else 0.0


class DevicePrefetcher:
    """Pull host batches from ``source`` and land them on ``ctx`` (default:
    the current context) ahead of the consumer, in order.

    Parameters
    ----------
    source : iterable
        Host batches in step order.  Exhaustion ends the stream; an
        exception in the source is raised at the consumer's next
        ``get()``.
    depth : int
        Device batches resident ahead of the consumer (2 = double
        buffering).
    ctx : Context, optional
        Where the batches go.
    mesh : DeviceMesh, optional
        Shard every leaf's rows over ``axis_name`` (default ``dp``):
        each rank copies only its own rows.
    """

    def __init__(self, source, depth=2, mesh=None, ctx=None,
                 axis_name="dp"):
        self._mesh, self._axis = mesh, axis_name
        if mesh is not None:
            names = getattr(mesh, "mesh_dim_names", None) or ()
            if axis_name not in names:
                raise MXNetError(
                    f"DevicePrefetcher(mesh=) needs a DeviceMesh with a "
                    f"{axis_name!r} axis (parallel.make_mesh), got {mesh!r}")
            n = mesh.size(names.index(axis_name))
            self._shard = (mesh.get_local_rank(axis_name), n)
        if depth < 1:
            raise MXNetError("prefetch depth must be >= 1")
        self._source = iter(source)
        self._depth = int(depth)
        self._ctx = ctx if ctx is not None else current_context()
        self._q = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._started = False
        self._closed = False
        self._waits_ms = []
        self._depths = []
        self._stream = None  # the copy stream, made by the producer
        self._thread = threading.Thread(target=self._produce,
                                        name="mxt-data-prefetch",
                                        daemon=True)

    # -- producer side -------------------------------------------------------

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        device = self._ctx.device
        try:
            if device.type == "cuda":
                self._produce_cuda(device)
            else:
                for host in self._source:
                    if self._stop.is_set():
                        return
                    # a copy, as a copy to a card would be: the source
                    # may reuse its buffers
                    if not self._put(("ok", (_map_leaves(
                            lambda x: self._local_rows(x).clone(),
                            host), None))):
                        return
            self._put(("end", None))
        except BaseException as exc:  # raised at the consumer's get()
            self._put(("err", exc))

    def _produce_cuda(self, device):
        stream = self._stream = torch.cuda.Stream(device=device)
        inflight = collections.deque()  # (event, pinned leaves) per batch
        try:
            for host in self._source:
                if self._stop.is_set():
                    return
                # host buffers of copies that have landed can go
                while inflight and inflight[0][0].query():
                    inflight.popleft()
                pinned = _map_leaves(
                    lambda x: x if x.is_pinned() else x.pin_memory(),
                    _map_leaves(self._local_rows, host))
                with torch.cuda.stream(stream):
                    dev = _map_leaves(
                        lambda x: x.to(device, non_blocking=True), pinned)
                    event = torch.cuda.Event()
                    event.record(stream)
                inflight.append((event, pinned))
                if not self._put(("ok", (dev, event))):
                    return
        finally:
            # the last buffers live until their copies have run
            for event, _ in inflight:
                event.synchronize()

    # -- consumer side -------------------------------------------------------

    def get(self, timeout=None):
        """The next batch on the prefetcher's context, in step order (its
        leaves as NDArrays).  On a card the current stream waits for the
        copy on the card; the host does not."""
        if self._closed:
            raise MXNetError("DevicePrefetcher is closed")
        if not self._started:
            self._started = True
            self._thread.start()
        t0 = time.perf_counter()
        try:
            kind, payload = self._q.get(timeout=timeout)
        except queue.Empty:
            raise MXNetError(
                f"DevicePrefetcher timed out after {timeout}s waiting "
                "for the next batch") from None
        waited = (time.perf_counter() - t0) * 1e3
        depth = self._q.qsize()
        self._waits_ms.append(waited)
        self._depths.append(depth)
        telemetry.count("data.wait_ms", waited)
        telemetry.gauge("data.prefetch_depth", depth)
        if depth:
            telemetry.count("data.overlap_dispatch")
        if kind == "err":
            self.close()
            raise payload
        if kind == "end":
            self.close()
            raise StopIteration
        batch, event = payload
        if event is not None:
            current = torch.cuda.current_stream(self._ctx.device)
            current.wait_event(event)
            for leaf in _iter_leaves(batch):
                leaf.record_stream(current)
        return _map_leaves(lambda t: NDArray(self._global(t)), batch)

    def _local_rows(self, x):
        """The host tensor of a leaf: this rank's rows under a mesh."""
        t = _host_tensor(x)
        if self._mesh is None:
            return t
        i, n = self._shard
        if t.shape[0] % n:
            raise MXNetError(f"DevicePrefetcher: batch of {t.shape[0]} rows "
                             f"is not divisible by {self._axis}={n}")
        rows = t.shape[0] // n
        return t[i * rows:(i + 1) * rows]

    def _global(self, t):
        """A copied leaf as the consumer sees it: under a mesh, this
        rank's rows of one array sharded over the axis."""
        if self._mesh is None:
            return t
        from torch.distributed.tensor import DTensor

        from ..parallel import placements

        spec = (self._axis,) + (None,) * (t.dim() - 1)
        return DTensor.from_local(t, self._mesh,
                                  placements(spec, self._mesh),
                                  run_check=False)

    def depth(self):
        """Batches waiting on the card right now."""
        return self._q.qsize()

    def stats(self):
        """The consumer's waits and the sampled queue depth so far."""
        return {"batches": len(self._waits_ms),
                "wait_ms_p50": _percentile(self._waits_ms, 50),
                "wait_ms_p99": _percentile(self._waits_ms, 99),
                "wait_ms_total": float(sum(self._waits_ms)),
                "depth_mean": (float(np.mean(self._depths))
                               if self._depths else 0.0),
                "depth_samples": list(self._depths)}

    def __iter__(self):
        return self

    def __next__(self):
        return self.get()

    def close(self):
        """Stop the producer thread (it finishes the batch in hand)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._started:
            while True:  # unblock a producer stuck on a full queue
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


"""DataLoader.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py`` (reference
``python/mxnet/gluon/data/dataloader.py``: multiprocessing workers that
return batches through CPU shared memory).

Batches are host (CPU) NDArrays, as MXNet's DataLoader gives them;
``pin_memory=True`` puts them in page-locked memory, so that the copy to
the card (``as_in_context``, ``gluon.utils.split_and_load``, or a
``data.DevicePrefetcher``) runs without blocking the host.  Samples are
fetched and batched under ``mx.cpu()`` on every route, so no worker
touches a card.  Two worker types:

- ``worker_type='thread'`` (the default): OpenCV and numpy release the
  GIL, so threads with a bounded prefetch window cover most jobs;
- ``worker_type='process'``: the reference's design for GIL-bound Python
  transforms.  Workers are *spawned*, never forked (a fork of a process
  that has initialized CUDA breaks the card), hide every card from
  themselves before they unpickle the dataset, and send each batch back
  through POSIX shared memory (``multiprocessing.shared_memory``) with
  only (name, dtype, shape) pickled.  The dataset and ``batchify_fn``
  must pickle; each worker seeds numpy's global generator apart
  (reference ``_worker_initializer``).
"""
from __future__ import annotations

import os
import pickle
import queue as _queue
import threading
import time
import traceback

import numpy as np
import torch

from ...base import MXNetError
from ...context import cpu
from ...ndarray import NDArray
from . import sampler as _sampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference ``default_batchify_fn``):
    NDArrays stack on their device, tuples batch field by field, anything
    else becomes a host array (float64 as float32)."""
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d._data for d in data]))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = np.asarray(data)
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    return NDArray(torch.from_numpy(np.ascontiguousarray(data)))


default_mp_batchify_fn = default_batchify_fn


def _pin(batch):
    """Every tensor leaf of a batch in page-locked host memory (when the
    process can see a card; without one there is nothing to pin for)."""
    if isinstance(batch, (list, tuple)):
        return type(batch)(_pin(b) for b in batch)
    if isinstance(batch, NDArray) and not batch._data.is_cuda and \
            torch.cuda.is_available():
        return NDArray(batch._data.pin_memory())
    return batch


# --- process workers: the shared-memory hand-off ----------------------------

def _flatten_host(obj, arrays):
    """A nested list/tuple of array-likes as a template of leaf indices;
    the leaves are collected as contiguous host numpy arrays."""
    if isinstance(obj, (list, tuple)):
        return [_flatten_host(o, arrays) for o in obj]
    a = obj.asnumpy() if isinstance(obj, NDArray) else np.asarray(obj)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    arrays.append(np.ascontiguousarray(a))
    return len(arrays) - 1


def _unflatten(tmpl, leaves):
    if isinstance(tmpl, list):
        return [_unflatten(t, leaves) for t in tmpl]
    return leaves[tmpl]


def _shm_unregister(name):
    """The worker hands a block to the parent: take it off the worker's
    resource tracker, which would unlink it when the worker exits."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(f"/{name}", "shared_memory")
    except (ImportError, KeyError, ValueError):
        pass


def _proc_start_ticks(pid):
    """The process's start time in clock ticks since boot (field 22 of
    ``/proc/<pid>/stat``); with the pid it names a process uniquely on
    this boot, so a recycled pid is told apart.  None if unreadable."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
        # the command name may hold spaces and parentheses: fields resume
        # after the last ')'
        return int(stat[stat.rindex(b")") + 2:].split()[19])
    except (OSError, ValueError, IndexError):
        return None


#: a leaked block is reclaimed only when this old (seconds): a block in
#: flight lives for seconds, and a neighbour in another pid namespace
#: that shares /dev/shm cannot be told from a dead owner otherwise
_SHM_SWEEP_MIN_AGE = 3600.0


def _shm_name(owner_pid):
    """``mxt-<owner pid>-<start ticks>-<random>``: the owner is the
    loader's process, captured when the worker was spawned."""
    import secrets

    ticks = _proc_start_ticks(owner_pid) or 0
    return f"mxt-{owner_pid}-{ticks}-{secrets.token_hex(6)}"


def _sweep_stale_shm():
    """Unlink ``/dev/shm/mxt-<pid>-<ticks>-*`` blocks left by a loader
    that died without ``close()`` (a block belongs to the parent once the
    worker sent it, so a killed parent leaks it).  A block goes only when
    its owner is gone (the pid's start ticks differ from the name's) and
    it is older than ``_SHM_SWEEP_MIN_AGE``."""
    shm_dir = "/dev/shm"
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return
    now = time.time()
    for fn in names:
        parts = fn.split("-")
        if parts[0] != "mxt" or len(parts) < 4:
            continue
        try:
            pid, ticks = int(parts[1]), int(parts[2])
        except ValueError:
            continue
        if ticks and _proc_start_ticks(pid) == ticks:
            continue  # the owner is alive: in flight
        path = os.path.join(shm_dir, fn)
        try:
            if now - os.stat(path).st_mtime > _SHM_SWEEP_MIN_AGE:
                os.unlink(path)
        except OSError:
            pass


def _process_worker_loop(payload, index_q, result_q, worker_id, owner_pid):
    """A spawned worker's main: fetch and batchify on the host, export
    each leaf through shared memory, send only the metadata.  Jobs and
    results carry the parent's epoch counter, so an abandoned epoch never
    leaks into the next."""
    from multiprocessing import shared_memory

    # this process never touches a card, whatever the dataset does; and
    # one torch thread each, or the workers' torch ops oversubscribe the
    # host's cores (as torch's own DataLoader workers do)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    np.random.seed((os.getpid() * 2654435761 + worker_id) % (2 ** 31 - 1))
    dataset, batchify_fn = pickle.loads(payload)
    with cpu():
        while True:
            job = index_q.get()
            if job is None:
                return
            epoch, i, indices = job
            try:
                batch = batchify_fn([dataset[j] for j in indices])
                arrays = []
                tmpl = _flatten_host(batch, arrays)
                metas = []
                for a in arrays:
                    shm = shared_memory.SharedMemory(
                        name=_shm_name(owner_pid), create=True,
                        size=max(a.nbytes, 1))
                    np.ndarray(a.shape, a.dtype, buffer=shm.buf)[...] = a
                    metas.append((shm.name, str(a.dtype), a.shape))
                    shm.close()
                    _shm_unregister(shm.name)
                result_q.put((epoch, i, tmpl, metas, None))
            except Exception:
                result_q.put((epoch, i, None, None, traceback.format_exc()))


def _free_metas(metas):
    """Unlink blocks the parent will never turn into a batch."""
    from multiprocessing import shared_memory

    for name, _dtype, _shape in metas or ():
        try:
            shm = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            continue
        shm.close()
        shm.unlink()


def _attach_result(tmpl, metas, pin):
    """Parent side: copy each block out (straight into page-locked memory
    when ``pin``), unlink it, and rebuild the batch of host NDArrays."""
    from multiprocessing import shared_memory

    leaves = []
    for name, dtype, shape in metas:
        shm = shared_memory.SharedMemory(name=name)
        src = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf)
        dst = torch.empty(shape, dtype=torch.from_numpy(src[:0]).dtype,
                          pin_memory=pin)
        dst.numpy()[...] = src
        del src
        shm.close()
        shm.unlink()
        leaves.append(NDArray(dst))
    return _unflatten(tmpl, leaves)


class DataLoader:
    """Loads batches from a Dataset (reference ``gluon.data.DataLoader``).
    ``thread_pool=True`` forces thread workers, as the reference flag."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120, worker_type="thread"):
        if worker_type not in ("thread", "process"):
            raise MXNetError(f"bad worker_type {worker_type!r}")
        self._worker_type = "thread" if thread_pool else worker_type
        self._dataset = dataset
        self._timeout = timeout
        self._pin = bool(pin_memory) and torch.cuda.is_available()
        self._pool = None
        self._epoch = 0
        self._iter_lock = threading.Lock()
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError(
                    "batch_size is required when batch_sampler is not given")
            if sampler is None:
                sampler = _sampler.RandomSampler(len(dataset)) if shuffle \
                    else _sampler.SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError(
                    "shuffle must be False when sampler is given")
            batch_sampler = _sampler.BatchSampler(sampler, batch_size,
                                                  last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise MXNetError(
                "batch_size/shuffle/sampler/last_batch must not be set "
                "when batch_sampler is given")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch or 2 * max(self._num_workers, 1))
        self._batchify_fn = batchify_fn or default_batchify_fn

    def __len__(self):
        return len(self._batch_sampler)

    def _fetch(self, indices):
        with cpu():
            batch = self._batchify_fn([self._dataset[i] for i in indices])
        return _pin(batch) if self._pin else batch

    def __iter__(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._fetch(indices)
            return
        if self._worker_type == "process":
            yield from self._process_iter()
            return
        yield from self._threaded_iter()

    # --- process workers ----------------------------------------------------

    def _ensure_pool(self):
        """Spawn the worker pool at first use; it lives as long as the
        loader (as the reference's)."""
        if self._pool is not None:
            return self._pool
        import multiprocessing as mp

        _sweep_stale_shm()
        ctx = mp.get_context("spawn")
        payload = pickle.dumps((self._dataset, self._batchify_fn))
        index_q = ctx.Queue()
        result_q = ctx.Queue()
        procs = []
        for wid in range(self._num_workers):
            p = ctx.Process(target=_process_worker_loop,
                            args=(payload, index_q, result_q, wid,
                                  os.getpid()),
                            daemon=True)
            p.start()
            procs.append(p)
        self._pool = (procs, index_q, result_q)
        return self._pool

    def _process_iter(self):
        if not self._iter_lock.acquire(blocking=False):
            raise MXNetError("a process-worker DataLoader runs one iterator "
                             "at a time")
        buffered = {}
        failed = False
        try:
            procs, index_q, result_q = self._ensure_pool()
            self._epoch = epoch = self._epoch + 1
            batches = list(self._batch_sampler)
            window = max(self._prefetch, self._num_workers)
            submitted = 0
            for _ in range(min(window, len(batches))):
                index_q.put((epoch, submitted, list(batches[submitted])))
                submitted += 1
            for i in range(len(batches)):
                deadline = time.monotonic() + self._timeout
                while i not in buffered:
                    try:
                        ep, j, tmpl, metas, err = result_q.get(timeout=1.0)
                    except _queue.Empty:
                        dead = [p for p in procs if not p.is_alive()]
                        if dead:
                            raise MXNetError(
                                f"{len(dead)} DataLoader worker(s) died "
                                f"(exitcode {dead[0].exitcode}). Spawned "
                                "workers re-import __main__: scripts "
                                "using worker_type='process' must guard "
                                "their entry point with "
                                "if __name__ == '__main__':")
                        if time.monotonic() > deadline:
                            raise MXNetError(
                                f"DataLoader worker timeout after "
                                f"{self._timeout}s (batch {i})")
                        continue
                    if ep != epoch:  # an abandoned epoch's leftovers
                        _free_metas(metas)
                        continue
                    if err is not None:
                        raise MXNetError(
                            f"DataLoader worker failed on batch {j}:\n"
                            f"{err}")
                    buffered[j] = (tmpl, metas)
                tmpl, metas = buffered.pop(i)
                if submitted < len(batches):
                    index_q.put((epoch, submitted,
                                 list(batches[submitted])))
                    submitted += 1
                yield _attach_result(tmpl, metas, self._pin)
        except GeneratorExit:
            # the consumer left the epoch (break, del): the pool stays
            raise
        except BaseException:
            # a failed epoch (a dead worker, a timeout, a bad sample)
            # leaves no worker behind; the next epoch spawns a new pool
            failed = True
            raise
        finally:
            for _tmpl, metas in buffered.values():
                _free_metas(metas)
            while self._pool is not None:
                try:
                    _ep, _j, _tmpl, metas, err = self._pool[2].get_nowait()
                except _queue.Empty:
                    break
                if err is None:
                    _free_metas(metas)
            self._iter_lock.release()
            if failed:
                self.close()

    def close(self):
        """Shut the worker pool down (also at garbage collection), freeing
        the shared memory of results still in flight."""
        if self._pool is None:
            return
        procs, index_q, result_q = self._pool
        self._pool = None
        for _ in procs:
            index_q.put(None)
        deadline = time.monotonic() + 10
        while any(p.is_alive() for p in procs) and \
                time.monotonic() < deadline:
            # workers may still finish queued jobs: free their results
            try:
                _ep, _j, _tmpl, metas, err = result_q.get(timeout=0.2)
            except _queue.Empty:
                continue
            if err is None:
                _free_metas(metas)
        for p in procs:
            p.join(timeout=1)
            if p.is_alive():
                p.terminate()
        while True:
            try:
                _ep, _j, _tmpl, metas, err = result_q.get_nowait()
            except _queue.Empty:
                break
            if err is None:
                _free_metas(metas)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # --- thread workers -----------------------------------------------------

    def _threaded_iter(self):
        """Ordered parallel fetch: workers fill per-batch slots at most
        ``prefetch`` batches ahead of the consumer, which yields them in
        order (the reference's order restoration)."""
        batches = list(self._batch_sampler)
        results = {}
        cond = threading.Condition()
        next_fetch = [0]
        consumed = [0]
        errors = []
        done = [False]
        window = max(self._prefetch, self._num_workers)

        def worker():
            while True:
                with cond:
                    while True:
                        i = next_fetch[0]
                        if i >= len(batches) or errors or done[0]:
                            return
                        if i < consumed[0] + window:
                            next_fetch[0] = i + 1
                            break
                        cond.wait()
                try:
                    out = self._fetch(batches[i])
                except Exception as e:
                    with cond:
                        errors.append(e)
                        cond.notify_all()
                    return
                with cond:
                    results[i] = out
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"mxt-dataloader-w{i}")
                   for i in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with cond:
                    ok = cond.wait_for(lambda: i in results or errors,
                                       timeout=self._timeout)
                    if errors:
                        raise errors[0]
                    if not ok:
                        raise MXNetError(
                            f"DataLoader worker timeout after "
                            f"{self._timeout}s (batch {i})")
                    out = results.pop(i)
                    consumed[0] = i + 1
                    cond.notify_all()
                yield out
        finally:
            with cond:
                done[0] = True
                cond.notify_all()
            for t in threads:
                t.join(timeout=self._timeout)

"""Atomic training checkpoints, asynchronous writes and resume, on one
host.

Counterpart of ``mxnet_tpu/checkpoint.py``:

- **Atomic**: a checkpoint is staged in ``<dir>/.tmp-<step>-<seq>-<pid>``
  and renamed to ``<dir>/ckpt-<step>`` (atomic on POSIX); a crash leaves
  the previous complete checkpoint and a stray staging directory, which
  ``resume`` and ``prune_checkpoints`` sweep once its process is gone.
- **Complete**: the weights (``model.params``, the ``.params`` file of
  ``save_parameters``), the trainer's optimizer states
  (``trainer.states``, ``Trainer.save_states``), the package's random
  state (``rng.npz``: the seed and each device generator's state) and a
  user ``extra`` dict, tied together by ``manifest.json`` with the step.
- **Resumable**: ``resume(dir, net, trainer)`` loads the newest complete
  checkpoint and returns ``(step, extra)`` (``(0, {})`` when there is
  none); a torn newest checkpoint falls back to the previous one.
- **Asynchronous** (``save_checkpoint_async``, ``AsyncCheckpointer``): the
  device-to-host copy happens in the call; serialization, fsync and the
  rename run on a writer thread.
- **Drain** (``drain_checkpoint_and_exit``): after a preemption signal
  (``gluon.trainer.install_preemption_handler``), wait for the writer,
  cut a final checkpoint and exit with ``PREEMPTED_EXIT_CODE`` (75).

- **Sharded** (``sharded=True``): each rank writes only the pieces of the
  parameters it holds (``shards/rank<r>.pt``; a piece replicated over
  ranks is written once, by its first holder), and the manifest records
  each parameter's global shape, dtype, mesh, placement and pieces.
  Over a process group the save is collective: the ranks write into one
  staging directory (rank 0's name), meet at a barrier, then rank 0
  writes the trainer's states (gathered whole by every rank), the random
  state and the manifest, and renames the directory.  Resume lays each
  parameter out on its CURRENT placement, so a checkpoint saved on one
  mesh restores onto another (or onto none).  The format is the port's
  own: the reference writes orbax/tensorstore, and a directory it wrote
  raises, saying why.  ``.params`` stays the interchange format.

Telemetry, under the reference's names: the ``ckpt.snapshot`` and
``ckpt.write`` spans, and the ``ckpt.save``, ``ckpt.bytes``,
``ckpt.async_overlap_ms`` (the asynchronous writer's time) and
``trainer.drain_checkpoint`` counters.
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import shutil
import sys
import threading
import time
import warnings

import numpy as np

from . import telemetry
from .base import MXNetError

__all__ = ["save_checkpoint", "save_checkpoint_async", "AsyncCheckpointer",
           "async_checkpointer", "wait_async", "latest_checkpoint",
           "resume", "prune_checkpoints", "drain_checkpoint_and_exit"]

_PREFIX = "ckpt-"


def _fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_tree(root):
    """fsync every file and directory under ``root`` (bottom-up)."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for fn in filenames:
            _fsync_file(os.path.join(dirpath, fn))
        _fsync_dir(dirpath)


# -- snapshot / write / commit ------------------------------------------------

_STAGE_LOCK = threading.Lock()
_STAGE_SEQ = 0


class _Snapshot:
    """Host image of one checkpoint: what the writer needs, with no
    reference to a device tensor (``shards``: this rank's pieces of a
    sharded checkpoint, else None)."""

    __slots__ = ("step", "params", "shards", "rng", "manifest")


# -- sharded pieces -------------------------------------------------------------

_SHARD_FORMAT = "mxnet_tpu_torch.sharded/1"


def _pieces_of(t):
    """[(rank, offset, shape)] of every rank's piece of ``t`` (a DTensor:
    its mesh's ranks, each dim split over the axes that shard it, in mesh
    order, as ``torch.chunk`` splits; a plain tensor: rank 0 holds it
    whole), each distinct piece once, held by its lowest rank."""
    from .parallel.local import is_dtensor

    shape = list(t.shape)
    if not is_dtensor(t):
        return [(0, [0] * len(shape), shape)]
    mesh = t.device_mesh
    ranks = mesh.mesh
    seen, out = set(), []
    for coord in itertools.product(*(range(n) for n in ranks.shape)):
        off, shp = [0] * len(shape), list(shape)
        for ax, pl in enumerate(t.placements):
            if not pl.is_shard():
                continue
            d, n = pl.dim, ranks.shape[ax]
            step = -(-shp[d] // n)
            lo = min(coord[ax] * step, shp[d])
            hi = min(lo + step, shp[d])
            off[d] += lo
            shp[d] = hi - lo
        key = (tuple(off), tuple(shp))
        if key not in seen:
            seen.add(key)
            out.append((int(ranks[coord]), off, shp))
    return sorted(out)


def _placement_meta(t):
    from .parallel.local import is_dtensor

    if not is_dtensor(t):
        return None, []
    mesh = t.device_mesh
    return (dict(zip(mesh.mesh_dim_names, mesh.shape)),
            [str(p) for p in t.placements])


def _stage_shards(net):
    """This rank's pieces of the net's initialized parameters, on the host
    ({name: tensor}), and every parameter's manifest entry."""
    from . import parallel
    from .parallel.local import local

    me = parallel.rank()
    pieces, meta = {}, {}
    for name, p in net._collect_params_with_prefix().items():
        if p._data is None:
            continue
        t = p.data()._data.detach()
        owners = _pieces_of(t)
        mesh, placements = _placement_meta(t)
        meta[name] = {"shape": list(t.shape),
                      "dtype": str(t.dtype).removeprefix("torch."),
                      "mesh": mesh, "placements": placements,
                      "pieces": [[r, off, shp] for r, off, shp in owners]}
        if any(r == me for r, _, _ in owners):
            pieces[name] = local(t).to("cpu", copy=True)
    return pieces, meta


def _write_shards(tmp, rank, pieces):
    import torch

    os.makedirs(os.path.join(tmp, "shards"), exist_ok=True)
    path = os.path.join(tmp, "shards", f"rank{rank}.pt")
    torch.save(pieces, path)
    _fsync_file(path)


def _stage_snapshot(ckpt_dir, step, net, trainer, extra, sharded=False):
    """Create the staging directory and copy all state to the host: the
    weights, the trainer's states (written into the staging directory),
    the random state.  Training may go on once this returns."""
    global _STAGE_SEQ
    step = int(step)
    os.makedirs(ckpt_dir, exist_ok=True)
    with _STAGE_LOCK:
        _STAGE_SEQ += 1
        seq = _STAGE_SEQ
    # the pid last: the sweeper's liveness probe parses it
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{seq}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    snap = _Snapshot()
    snap.step = step
    try:
        with telemetry.span("ckpt.snapshot"):
            _fill_snapshot(snap, tmp, step, net, trainer, extra, sharded)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return tmp, snap


def _fill_snapshot(snap, tmp, step, net, trainer, extra, sharded):
    """The host copies of ``_stage_snapshot``."""
    from . import random as mx_random

    snap.params = snap.shards = None
    manifest = {"step": step, "time": time.time(),
                "has_trainer": trainer is not None,
                "sharded": bool(sharded), "extra": extra or {}}
    if sharded:
        snap.shards, manifest["params"] = _stage_shards(net)
        manifest.update(format=_SHARD_FORMAT, world_size=1)
    else:
        # the member set of Block.save_parameters, copied to the host
        snap.params = {
            key: val.data().asnumpy()
            for key, val in net._collect_params_with_prefix().items()
            if val._data is not None or val._deferred_init is None}
    if trainer is not None:
        trainer.save_states(os.path.join(tmp, "trainer.states"))
    snap.rng = mx_random.get_state()
    snap.manifest = manifest


def _write_snapshot(tmp, snap):
    """Serialize the host image into the staging directory and make it
    durable (host I/O only)."""
    from .serialization import save_ndarrays

    if snap.shards is not None:
        _write_shards(tmp, 0, snap.shards)
    else:
        save_ndarrays(os.path.join(tmp, "model.params"), snap.params)
    _write_sidecars(tmp, snap)


def _write_sidecars(tmp, snap):
    """The random state and the manifest (written last), made durable."""
    gens = snap.rng["generators"]
    np.savez(os.path.join(tmp, "rng.npz"),
             seed=np.array(-1 if snap.rng["seed"] is None
                           else snap.rng["seed"], dtype=np.int64),
             devices=np.array(list(gens), dtype=str),
             **{f"gen{i}": state for i, state in enumerate(gens.values())})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(snap.manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_tree(tmp)


def _commit_stage(ckpt_dir, tmp, step):
    """Atomic publish: staging directory → ``ckpt-<step>``."""
    final = os.path.join(ckpt_dir, f"{_PREFIX}{step}")
    if telemetry.is_enabled():
        telemetry.count("ckpt.bytes", _tree_bytes(tmp))
    if os.path.exists(final):
        shutil.rmtree(final)  # a re-checkpoint of the same step
    os.rename(tmp, final)
    _fsync_dir(ckpt_dir)
    telemetry.count("ckpt.save")
    return final


def _tree_bytes(root):
    """Total file bytes under ``root`` (the ``ckpt.bytes`` counter)."""
    total = 0
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            try:
                total += os.path.getsize(os.path.join(dirpath, fn))
            except OSError:
                pass
    return total


def _save_sharded_collective(ckpt_dir, step, net, trainer, extra, keep):
    """The sharded save over a process group (every rank calls it): the
    ranks write their pieces into rank 0's staging directory, then a
    barrier, then rank 0 writes the trainer's states (gathered by every
    rank), the random state and the manifest, and renames the directory;
    a last barrier returns every rank after the rename."""
    import pickle

    from . import parallel
    from . import random as mx_random

    global _STAGE_SEQ
    step = int(step)
    me = parallel.rank()
    tmp = None
    if me == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        with _STAGE_LOCK:
            _STAGE_SEQ += 1
            seq = _STAGE_SEQ
        tmp = os.path.join(ckpt_dir, f".tmp-{step}-{seq}-{os.getpid()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    tmp = parallel.broadcast_object(tmp)
    pieces, meta = _stage_shards(net)
    _write_shards(tmp, me, pieces)
    del pieces
    payload = trainer._states_payload() if trainer is not None else None
    parallel.barrier()
    final = os.path.join(ckpt_dir, f"{_PREFIX}{step}")
    if me == 0:
        try:
            if payload is not None:
                path = os.path.join(tmp, "trainer.states")
                with open(path, "wb") as f:
                    pickle.dump(payload, f)
            snap = _Snapshot()
            snap.rng = mx_random.get_state()
            snap.manifest = {"step": step, "time": time.time(),
                             "has_trainer": trainer is not None,
                             "sharded": True, "format": _SHARD_FORMAT,
                             "world_size": parallel.world_size(),
                             "params": meta, "extra": extra or {}}
            _write_sidecars(tmp, snap)
            final = _commit_stage(ckpt_dir, tmp, step)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if keep is not None:
            prune_checkpoints(ckpt_dir, keep)
    parallel.barrier()
    return final


def save_checkpoint(ckpt_dir, step, net, trainer=None, extra=None,
                    keep=None, sharded=False):
    """Write ``<ckpt_dir>/ckpt-<step>`` atomically and return its path;
    ``keep``: then prune to the newest ``keep`` checkpoints.
    ``sharded=True``: each rank writes its own pieces (the module
    docstring); over a process group every rank calls it, on a shared
    file system."""
    from . import parallel

    if sharded and parallel.world_size() > 1:
        return _save_sharded_collective(ckpt_dir, step, net, trainer, extra,
                                        keep)
    tmp, snap = _stage_snapshot(ckpt_dir, step, net, trainer, extra,
                                sharded)
    try:
        with telemetry.span("ckpt.write"):
            _write_snapshot(tmp, snap)
            final = _commit_stage(ckpt_dir, tmp, snap.step)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep is not None:
        prune_checkpoints(ckpt_dir, keep)
    return final


# -- asynchronous checkpoints ---------------------------------------------------

class CheckpointTicket:
    """Handle of one checkpoint being written."""

    __slots__ = ("step", "_event", "_path", "_error")

    def __init__(self, step):
        self.step = step
        self._event = threading.Event()
        self._path = None
        self._error = None

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """Wait for the commit; the checkpoint's path, or the writer's
        error raised."""
        if not self._event.wait(timeout):
            raise MXNetError(f"async checkpoint for step {self.step} still "
                             f"in flight after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._path


class AsyncCheckpointer:
    """Checkpoints written on one background thread, in order: ``save``
    returns once the host copy is taken.  ``max_pending`` bounds host
    memory (a ``save`` beyond it waits for the oldest write).  A writer
    error raises on that save's ``ticket.result()``, on ``wait()`` and on
    the next ``save()``."""

    def __init__(self, max_pending=2):
        self._max_pending = max(1, int(max_pending))
        self._queue = queue.Queue()
        self._pending = []
        self._errors = []
        self._lock = threading.Lock()
        self._thread = None

    def save(self, ckpt_dir, step, net, trainer=None, extra=None,
             keep=None, sharded=False):
        """Take the host copy now, queue the write; a ``CheckpointTicket``."""
        from . import parallel

        if sharded and parallel.world_size() > 1:
            raise MXNetError(
                "multi-process sharded checkpoints are a collective write; "
                "call save_checkpoint(sharded=True) on every process")
        self._raise_pending_error()
        self._backpressure()
        tmp, snap = _stage_snapshot(ckpt_dir, step, net, trainer, extra,
                                    sharded)
        ticket = CheckpointTicket(snap.step)
        with self._lock:
            self._pending.append(ticket)
        self._queue.put((ckpt_dir, tmp, snap, keep, ticket))
        self._ensure_thread()
        return ticket

    def wait(self, timeout=None):
        """Wait for every queued write; raise the first writer error."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for ticket in self._drain_done():
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if not ticket._event.wait(left):
                raise MXNetError(f"async checkpoint for step {ticket.step} "
                                 f"still in flight after {timeout}s")
        self._raise_pending_error()

    def pending(self):
        """Checkpoints not yet committed."""
        return len(self._drain_done())

    def close(self):
        """Wait for the writes and stop the writer thread."""
        self.wait()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            self._queue.put(None)
            thread.join()

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._worker, name="mxt-ckpt-writer", daemon=True)
                self._thread.start()

    def _drain_done(self):
        with self._lock:
            self._pending = [t for t in self._pending if not t.done()]
            return list(self._pending)

    def _backpressure(self):
        while True:
            live = self._drain_done()
            if len(live) < self._max_pending:
                return
            live[0]._event.wait()

    def _raise_pending_error(self):
        with self._lock:
            if not self._errors:
                return
            err = self._errors.pop(0)
        raise MXNetError(
            f"a previous async checkpoint write failed: {err}") from err

    def _worker(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            ckpt_dir, tmp, snap, keep, ticket = item
            try:
                t0 = time.perf_counter()
                with telemetry.span("ckpt.write"):
                    _write_snapshot(tmp, snap)
                    path = _commit_stage(ckpt_dir, tmp, snap.step)
                # the writer's wall time while the training loop ran on:
                # what a synchronous save would have added to the step
                telemetry.count("ckpt.async_overlap_ms",
                                (time.perf_counter() - t0) * 1e3)
                ticket._path = path
                if keep is not None:
                    prune_checkpoints(ckpt_dir, keep)
            except BaseException as exc:  # raised by ticket/wait/save
                shutil.rmtree(tmp, ignore_errors=True)
                ticket._error = exc
                with self._lock:
                    self._errors.append(exc)
            finally:
                ticket._event.set()


_DEFAULT_ASYNC = None
_DEFAULT_ASYNC_LOCK = threading.Lock()


def async_checkpointer():
    """The process-wide ``AsyncCheckpointer``."""
    global _DEFAULT_ASYNC
    with _DEFAULT_ASYNC_LOCK:
        if _DEFAULT_ASYNC is None:
            _DEFAULT_ASYNC = AsyncCheckpointer()
        return _DEFAULT_ASYNC


def save_checkpoint_async(ckpt_dir, step, net, trainer=None, extra=None,
                          keep=None, sharded=False):
    """``save_checkpoint`` with the write on the default writer thread;
    returns a ``CheckpointTicket``."""
    return async_checkpointer().save(ckpt_dir, step, net, trainer,
                                     extra=extra, keep=keep, sharded=sharded)


def wait_async(timeout=None):
    """Wait for the default writer (nothing to do when it was never
    used)."""
    with _DEFAULT_ASYNC_LOCK:
        ckpt = _DEFAULT_ASYNC
    if ckpt is not None:
        ckpt.wait(timeout)


def drain_checkpoint_and_exit(ckpt_dir, step, net, trainer=None, extra=None,
                              keep=None):
    """The preemption drain's tail: wait for queued writes, cut a final
    checkpoint at ``step`` and exit with ``PREEMPTED_EXIT_CODE`` (75), the
    code a launcher reads as "relaunch", not as a crash.  Call it when
    ``gluon.trainer.drain_requested()`` turns true after a step."""
    from .gluon import trainer as _trainer_mod

    wait_async()
    save_checkpoint(ckpt_dir, step, net, trainer, extra=extra, keep=keep)
    telemetry.count("trainer.drain_checkpoint")
    sys.exit(_trainer_mod.PREEMPTED_EXIT_CODE)


# -- discovery / resume -------------------------------------------------------

def _complete_checkpoints(ckpt_dir):
    """[(step, path)] of the complete (manifest-bearing) checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith(_PREFIX):
            continue
        path = os.path.join(ckpt_dir, name)
        if not os.path.exists(os.path.join(path, "manifest.json")):
            continue  # torn or foreign
        try:
            out.append((int(name[len(_PREFIX):]), path))
        except ValueError:
            continue
    return sorted(out)


def _sweep_stale_tmp(ckpt_dir):
    """Remove the ``.tmp-*`` staging directories of processes that are
    gone (a live process may still be writing its own)."""
    for name in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []:
        if not name.startswith(".tmp-"):
            continue
        try:
            pid = int(name.rsplit("-", 1)[-1])
            os.kill(pid, 0)
            alive = True
        except (ValueError, ProcessLookupError):
            alive = False
        except PermissionError:
            alive = True  # exists, owned elsewhere
        if not alive:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def latest_checkpoint(ckpt_dir):
    """Path of the newest complete checkpoint, or None."""
    ckpts = _complete_checkpoints(ckpt_dir)
    return ckpts[-1][1] if ckpts else None


class _ResumeContractError(MXNetError):
    """A complete checkpoint that cannot serve this resume (no trainer
    state, a trainer given): raised, never a fallback."""


def _load_rng(path):
    from . import random as mx_random

    with np.load(path) as z:
        seed = int(z["seed"])
        gens = {str(dev): z[f"gen{i}"]
                for i, dev in enumerate(z["devices"])}
    mx_random.set_state({"seed": None if seed < 0 else seed,
                         "generators": gens})


def _load_checkpoint(path, net, trainer, ctx):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    step = int(manifest["step"])
    if trainer is not None and not manifest.get("has_trainer"):
        raise _ResumeContractError(
            f"checkpoint {path!r} has no trainer state; pass trainer=None "
            "or checkpoint with the trainer")
    if manifest.get("sharded"):
        _restore_params_sharded(path, manifest, net)
    else:
        net.load_parameters(os.path.join(path, "model.params"), ctx=ctx)
    if trainer is not None:
        trainer.load_states(os.path.join(path, "trainer.states"))
    rng = os.path.join(path, "rng.npz")
    if os.path.exists(rng):
        _load_rng(rng)
    return step, manifest.get("extra", {})


def _restore_params_sharded(path, manifest, net):
    """Load a sharded checkpoint into the net's initialized parameters,
    each laid out on its CURRENT placement (the mesh the resumed job runs
    on, or none): the pieces are read (memory-mapped) into the global
    array, and each rank keeps its own part of it."""
    import torch

    from .parallel.local import copy_global_into

    if manifest.get("format") != _SHARD_FORMAT:
        orbax = os.path.isdir(os.path.join(path, "model.orbax"))
        raise _ResumeContractError(
            f"sharded checkpoint at {path!r} is not in this port's format"
            + (" (an orbax/tensorstore tree written by the JAX package, "
               "which this port cannot read; save it there with "
               "sharded=False, whose .params file crosses)" if orbax else
               f" (manifest format {manifest.get('format')!r})"))
    params = {name: p for name, p in net._collect_params_with_prefix()
              .items() if p._data is not None}
    saved = manifest["params"]
    missing = sorted(set(params) - set(saved))
    extra = sorted(set(saved) - set(params))
    wrong = sorted(n for n in set(params) & set(saved)
                   if list(params[n].shape) != saved[n]["shape"])
    if missing or extra or wrong:
        raise _ResumeContractError(
            f"sharded checkpoint at {path!r} does not match this model's "
            f"parameter structure: missing {missing[:5]}, unexpected "
            f"{extra[:5]}, shape differs {wrong[:5]}")
    files = {}

    def shard(rank):
        if rank not in files:
            files[rank] = torch.load(
                os.path.join(path, "shards", f"rank{rank}.pt"),
                mmap=True, weights_only=True)
        return files[rank]

    for name, p in params.items():
        entry = saved[name]
        dst = p.data()._data
        full = torch.empty(entry["shape"],
                           dtype=getattr(torch, entry["dtype"]))
        for rank, off, shp in entry["pieces"]:
            idx = tuple(slice(o, o + n) for o, n in zip(off, shp))
            full[idx] = shard(rank)[name]
        copy_global_into(dst, full.to(dst.dtype))


def resume(ckpt_dir, net, trainer=None, ctx=None):
    """Load the newest complete checkpoint into ``net`` (and ``trainer``)
    → ``(step, extra)``, ``(0, {})`` when there is none.  A torn
    checkpoint (bad manifest, missing or unreadable member) is skipped
    with a warning for the previous complete one; stale staging
    directories are swept first.  Raises when every checkpoint is torn."""
    _sweep_stale_tmp(ckpt_dir)
    torn = []
    for _step, path in reversed(_complete_checkpoints(ckpt_dir)):
        try:
            return _load_checkpoint(path, net, trainer, ctx)
        except _ResumeContractError:
            raise
        except Exception as exc:  # a torn member or manifest: fall back
            torn.append((path, exc))
            warnings.warn(f"checkpoint {path!r} is torn ({exc!r}); falling "
                          "back to the previous complete checkpoint")
    if torn:
        raise MXNetError(f"every checkpoint in {ckpt_dir!r} is torn; newest "
                         f"error: {torn[0][1]}") from torn[0][1]
    return 0, {}


def prune_checkpoints(ckpt_dir, keep=3):
    """Delete all but the newest ``keep`` complete checkpoints, and the
    stale staging directories."""
    ckpts = _complete_checkpoints(ckpt_dir)
    for _step, path in ckpts[:-keep] if keep > 0 else ckpts:
        shutil.rmtree(path, ignore_errors=True)
    _sweep_stale_tmp(ckpt_dir)


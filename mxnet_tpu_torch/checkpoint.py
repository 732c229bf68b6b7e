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

Sharded checkpoints (``sharded=True``) and the multi-host protocol raise:
they go with multi-GPU (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import sys
import threading
import time
import warnings

import numpy as np

from .base import MXNetError

__all__ = ["save_checkpoint", "save_checkpoint_async", "AsyncCheckpointer",
           "async_checkpointer", "wait_async", "latest_checkpoint",
           "resume", "prune_checkpoints", "drain_checkpoint_and_exit"]

_PREFIX = "ckpt-"


def _refuse_sharded(sharded):
    if sharded:
        raise MXNetError("sharded checkpoints are not ported yet "
                         "(ROADMAP.md, Queue 1 item 5, multi-GPU)")


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
    reference to a device tensor."""

    __slots__ = ("step", "params", "rng", "manifest")


def _stage_snapshot(ckpt_dir, step, net, trainer, extra):
    """Create the staging directory and copy all state to the host: the
    weights, the trainer's states (written into the staging directory),
    the random state.  Training may go on once this returns."""
    from . import random as mx_random

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
        # the member set of Block.save_parameters, copied to the host
        snap.params = {
            key: val.data().asnumpy()
            for key, val in net._collect_params_with_prefix().items()
            if val._data is not None or val._deferred_init is None}
        if trainer is not None:
            trainer.save_states(os.path.join(tmp, "trainer.states"))
        snap.rng = mx_random.get_state()
        snap.manifest = {"step": step, "time": time.time(),
                         "has_trainer": trainer is not None,
                         "sharded": False, "extra": extra or {}}
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return tmp, snap


def _write_snapshot(tmp, snap):
    """Serialize the host image into the staging directory and make it
    durable (host I/O only)."""
    from .serialization import save_ndarrays

    save_ndarrays(os.path.join(tmp, "model.params"), snap.params)
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
    if os.path.exists(final):
        shutil.rmtree(final)  # a re-checkpoint of the same step
    os.rename(tmp, final)
    _fsync_dir(ckpt_dir)
    return final


def save_checkpoint(ckpt_dir, step, net, trainer=None, extra=None,
                    keep=None, sharded=False):
    """Write ``<ckpt_dir>/ckpt-<step>`` atomically and return its path;
    ``keep``: then prune to the newest ``keep`` checkpoints."""
    _refuse_sharded(sharded)
    tmp, snap = _stage_snapshot(ckpt_dir, step, net, trainer, extra)
    try:
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
        _refuse_sharded(sharded)
        self._raise_pending_error()
        self._backpressure()
        tmp, snap = _stage_snapshot(ckpt_dir, step, net, trainer, extra)
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
                _write_snapshot(tmp, snap)
                ticket._path = _commit_stage(ckpt_dir, tmp, snap.step)
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
    _refuse_sharded(manifest.get("sharded"))
    net.load_parameters(os.path.join(path, "model.params"), ctx=ctx)
    if trainer is not None:
        trainer.load_states(os.path.join(path, "trainer.states"))
    rng = os.path.join(path, "rng.npz")
    if os.path.exists(rng):
        _load_rng(rng)
    return step, manifest.get("extra", {})


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

"""CUDA graphs: capture once, replay many times, with the kernels' launch
counts carried through the replays.

The port's counterpart of the reference's compiled programs (a jitted
function per signature: ``CachedOp``, ``FusedTrainStep``, the decoder's
``_step``): a captured ``torch.cuda.CUDAGraph`` replays every kernel of a
forward, a training step or a decode step with one host call.  Users are
``gluon.HybridBlock.hybridize``, ``gluon.FusedTrainStep``,
``LlamaDecoder.generate`` and the serving engine's decode tick.

A graph bakes in the addresses it was captured with: inputs are copied
into its static input tensors before a replay, outputs are the same
tensors after every replay (a caller copies them out before the next),
and weights are read where they lay at capture (callers key their graphs
on the weights' ``data_ptr``s and capture again when one moves).

The kernel wrappers count launches in Python (``count``), which runs
once, at capture, when nothing runs on the card.  A launch counted on a
stream that is capturing goes to that capture's tally, not to the
counter, and ``Graph.replay`` adds the tally, so ``.launches`` stays the
number of launches that ran on the card, also while other threads
launch, capture or replay.  The tally is keyed on the capture stream,
not on the thread: a captured backward runs on autograd's worker
thread, on the capture stream.

Several threads may capture and replay at once (two ``InferenceServer``
schedulers, a server beside a training loop): each thread captures on
a stream of its own, a capture takes the ``"thread_local"`` error mode
where its caller asks for it, and the garbage collector stays off while
any capture runs.  What another thread must not do during a capture is
a device-wide ``torch.cuda.synchronize()``: CUDA refuses it, and the
capture fails with it.

Collectives inside a graph (``FusedTrainStep`` and ``hybridize()`` over
a mesh or a ``dist_*`` store): ``warm_groups`` runs one eager collective
on every NCCL group a capture will use before it begins, because
creating a communicator cannot be captured.  gloo collectives cannot be
captured at all: on the CPU those calls run eagerly, as every CPU call
does.
"""
from __future__ import annotations

import gc
import threading

import torch

from .base import MXNetError

_STATE = threading.local()
_SIDE = {}  # device index -> the warm-up stream
_LOCK = threading.RLock()  # a finalizer run by a collection may take it
_GC = {"captures": 0, "was_on": True}  # under _LOCK
_TALLIES = {}  # capture stream handle -> its tally; under _LOCK


def count(fn, attr="launches", n=1):
    """Add ``n`` launches to ``fn.<attr>``, or, when the current stream is
    capturing, to that capture's tally (each replay of the graph adds
    them)."""
    with _LOCK:
        tally = _TALLIES.get(torch.cuda.current_stream().cuda_stream) \
            if _TALLIES else None
        if tally is None:
            setattr(fn, attr, getattr(fn, attr) + n)
        else:
            tally[(fn, attr)] = tally.get((fn, attr), 0) + n


def host_op(name):
    """Note that an op that runs host code (``nd.Custom``) ran on this
    thread; raises ``MXNetError`` naming it while the current stream
    captures: a graph would replay its first result.  ``CachedOp`` reads
    ``host_ops()`` around a signature's first run and runs such a
    signature eagerly on every call."""
    if torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            f"{name} runs host code, which a CUDA graph cannot capture "
            "(its replays would return the first call's result); run the "
            "block without capture (hybridize(False)) or outside "
            "FusedTrainStep")
    _STATE.host_ops = getattr(_STATE, "host_ops", 0) + 1


def host_ops():
    """How many host-code ops this thread has run (``host_op``)."""
    return getattr(_STATE, "host_ops", 0)


def capturing():
    """True while this thread runs a capture or its warm-up (nested
    hybridized blocks then run their forwards inline)."""
    return getattr(_STATE, "depth", 0) > 0


class _Scope:
    def __enter__(self):
        _STATE.depth = getattr(_STATE, "depth", 0) + 1

    def __exit__(self, *exc):
        _STATE.depth -= 1


def scope():
    """A context in which hybridized blocks run inline (a capture, its
    warm-up, or an eager pass that stands for one)."""
    return _Scope()


class Graph:
    """One captured graph: ``outputs`` is what the captured function
    returned (tensors the replays overwrite), ``pool_bytes`` the device
    memory reserved during the capture (what the graph's pool grew by)."""

    def __init__(self, graph, outputs, delta, pool_bytes):
        self.graph = graph
        self.outputs = outputs
        self.delta = delta
        self.pool_bytes = pool_bytes
        self.replays = 0

    def replay(self):
        """Run the graph on the current stream and count its launches."""
        self.graph.replay()
        self.replays += 1
        with _LOCK:
            for (fn, attr), d in self.delta.items():
                setattr(fn, attr, getattr(fn, attr) + d)


#: the share of the card's memory budget (``memory.planner.budget_bytes``)
#: that graphs kept for later calls may hold: the recorded graph pairs of
#: all hybridized blocks together, and each serving engine's graphs
GRAPH_SHARE = 0.25


def budget(device=None):
    """Bytes that kept graphs may hold on ``device`` (``GRAPH_SHARE``
    of its budget): past it, callers run eagerly and count the call."""
    from .memory import planner

    return int(GRAPH_SHARE * planner.budget_bytes(device))


def warmup(fn):
    """Run ``fn`` eagerly on a side stream (what torch asks of a capture's
    first run: lazy initialisations happen outside the capture); returns
    its result after the current stream has waited for it."""
    dev = torch.cuda.current_device()
    side = _SIDE.get(dev)
    if side is None:
        side = _SIDE[dev] = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), scope():
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


_FREE_STREAMS = {}  # device index -> capture streams of ended threads


class _Streams(dict):
    """A thread's capture streams by device, given back to
    ``_FREE_STREAMS`` when the thread ends: cuBLAS keeps a workspace for
    every stream it has run on, for the life of the process, so a server
    whose lane threads come and go must not make a new stream each."""

    def __del__(self):
        with _LOCK:
            for dev, stream in self.items():
                _FREE_STREAMS.setdefault(dev, []).append(stream)


def _capture_stream():
    """This thread's capture stream on the current device (torch's
    default capture stream is one for the process, and a stream holds one
    capture at a time): one an ended thread gave back, else a new one."""
    streams = getattr(_STATE, "capture_streams", None)
    if streams is None:
        streams = _STATE.capture_streams = _Streams()
    dev = torch.cuda.current_device()
    if dev not in streams:
        with _LOCK:
            free = _FREE_STREAMS.get(dev)
            streams[dev] = free.pop() if free else torch.cuda.Stream()
    return streams[dev]


def _gc_hold(on):
    """Hold the garbage collector off while any thread captures: a
    dropped graph's finalizer destroys it with a CUDA call that is not
    allowed while a capture runs (it invalidates the capture).  The first
    capture to open collects first; one that opens while another runs
    does not, and no capture opens during the collection."""
    with _LOCK:
        if on:
            if _GC["captures"] == 0:
                gc.collect()
                _GC["was_on"] = gc.isenabled()
                gc.disable()
            _GC["captures"] += 1
        else:
            _GC["captures"] -= 1
            if _GC["captures"] == 0 and _GC["was_on"]:
                gc.enable()


def capture(fn, pool=None, generators=(), mode="global"):
    """Capture ``fn`` (which runs nothing on the card now) into a new
    ``Graph``; ``pool``: a ``torch.cuda.graph_pool_handle()`` shared with
    other graphs; ``generators``: CUDA generators ``fn`` draws from, which
    then advance on every replay; ``mode``: the capture error mode
    (``"thread_local"`` where other threads keep using the card).
    ``pool_bytes`` is what the reserved memory grew by during the
    capture, other threads' allocations in that time included.

    Unlike ``torch.cuda.graph``, this makes no device-wide
    ``torch.cuda.synchronize()`` before the capture: CUDA refuses a
    device-wide synchronize while another thread captures, and the
    refusal invalidates that capture too (on an H100, torch 2.11, even in
    the thread-local mode).  The capture stream only waits, on the card,
    for the work queued before it.  Emptying the device and pinned-host
    caches stays: it erases the pools whose graphs are all gone, and a
    capture into such a pool (``pool`` kept by a caller whose graphs were
    dropped) fails torch's allocator checks otherwise."""
    if not torch.cuda.is_available():
        raise MXNetError("CUDA graph capture needs a CUDA card")
    _gc_hold(True)
    stream = _capture_stream()
    delta = {}
    with _LOCK:
        _TALLIES[stream.cuda_stream] = delta
    try:
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        torch.cuda.empty_cache()
        if hasattr(torch._C, "_host_emptyCache"):
            torch._C._host_emptyCache()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            graph.capture_begin(*(() if pool is None else (pool,)),
                                capture_error_mode=mode)
            try:
                reserved = torch.cuda.memory_reserved()
                with scope():
                    outputs = fn()
                grown = torch.cuda.memory_reserved() - reserved
            finally:
                graph.capture_end()
    finally:
        with _LOCK:
            del _TALLIES[stream.cuda_stream]
        _gc_hold(False)
    return Graph(graph, outputs, delta, grown)


def _nccl_groups(tensors):
    """The NCCL process groups the collectives of a step over ``tensors``
    use: every group of each DTensor's mesh, and the default group."""
    from .parallel.local import is_dtensor

    dist = torch.distributed
    if not dist.is_available() or not dist.is_initialized():
        return []
    groups, seen = [dist.group.WORLD], set()
    for t in tensors:
        if not is_dtensor(t):
            continue
        mesh = t.device_mesh
        if id(mesh) in seen:
            continue
        seen.add(id(mesh))
        groups.extend(mesh.get_group(d) for d in range(mesh.ndim))
    return [g for g in groups if dist.get_backend(g) == "nccl"]


def warm_groups(tensors=(), groups=()):
    """Run one eager all-reduce on every NCCL group that a capture over
    ``tensors`` may use (and on ``groups``), and wait for it.

    What torch's NCCL process group needs in order to be captured: the
    group's communicator must already exist, since ``ncclCommInitRank``
    (run at a group's first collective, or at ``init_process_group``
    when a ``device_id`` is bound) cannot run inside a capture; this
    warm-up creates it outside.  During the capture the process group
    sees that the current stream is capturing and leaves the collective's
    work object out of its watchdog (whose event queries would
    invalidate the capture); the collective runs on the group's NCCL
    stream, which joins the capture through the event it waits on, and
    the capture stream waits on the NCCL stream's end event in turn, so
    the collective lands in the graph and replays with it.  NCCL 2.9.6
    or later."""
    groups = _nccl_groups(tensors) + [
        g for g in groups if torch.distributed.get_backend(g) == "nccl"]
    if not groups:
        return
    dev = torch.cuda.current_device()
    probe = torch.zeros(1, device=f"cuda:{dev}")
    for g in groups:
        torch.distributed.all_reduce(probe, group=g)
    torch.cuda.current_stream().synchronize()

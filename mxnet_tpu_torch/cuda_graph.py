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

The kernel wrappers count launches in Python, which runs once, at
capture, when nothing runs on the card.  ``capture`` records each
counter's change during the capture and takes it back, and
``Graph.replay`` adds it, so ``.launches`` stays the number of launches
that ran on the card.
"""
from __future__ import annotations

import gc
import threading

import torch

from .base import MXNetError

_STATE = threading.local()
_SIDE = {}  # device index -> the warm-up stream


def _counters():
    """(function, attribute) of every launch counter of the port."""
    from .ops import conv_bn_relu as cbr
    from .ops import flash_attention as fa
    from .ops import multi_tensor as mt

    out = []
    for fn in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, cbr.fused_matmul_affine_relu):
        out += [(fn, "launches"), (fn, "launches_mma")]
    return out + [(cbr.conv1x1_bn_relu, "calls"),
                  (mt.multi_tensor_update, "launches")]


def _counts():
    return [getattr(fn, attr) for fn, attr in _counters()]


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
        for (fn, attr), d in zip(_counters(), self.delta):
            if d:
                setattr(fn, attr, getattr(fn, attr) + d)


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


def capture(fn, pool=None, generators=(), mode="global"):
    """Capture ``fn`` (which runs nothing on the card now) into a new
    ``Graph``; ``pool``: a ``torch.cuda.graph_pool_handle()`` shared with
    other graphs; ``generators``: CUDA generators ``fn`` draws from, which
    then advance on every replay; ``mode``: the capture error mode
    (``"thread_local"`` where other threads keep using the card)."""
    if not torch.cuda.is_available():
        raise MXNetError("CUDA graph capture needs a CUDA card")
    # a dropped graph's finalizer destroys it with a CUDA call that is not
    # allowed while a capture runs (it invalidates the capture): collect
    # the garbage now and let no collection run during the capture
    gc.collect()
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        torch.cuda.synchronize()
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=pool, capture_error_mode=mode):
            reserved = torch.cuda.memory_reserved()
            with scope():
                outputs = fn()
            grown = torch.cuda.memory_reserved() - reserved
    finally:
        if gc_was_on:
            gc.enable()
    delta = [a - b for a, b in zip(_counts(), before)]
    for (fn, attr), n in zip(_counters(), before):
        setattr(fn, attr, n)  # the capture itself ran nothing
    return Graph(graph, outputs, delta, grown)

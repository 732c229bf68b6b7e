"""Training monitor: per-layer output statistics.

Counterpart of ``mxnet_tpu/monitor.py`` (reference
``python/mxnet/monitor.py``): ``Monitor(interval, stat_func, pattern,
sort)``; ``install(block)`` watches every child block's forward output
(and inputs with ``monitor_all``), ``tic()`` before a forward, ``toc()``
after it returns ``[(step, name, stat_str), ...]`` every ``interval``
batches, ``toc_print()`` prints them; ``install_executor`` takes an
``Executor``'s monitor callback.

The hooks are block observers (``Block._register_observer``), which
leave a fused 1×1 conv + BatchNorm + ReLU run fused (the kernel still
launches) and report each of its blocks.  On an eager block the stats
(``stat_func``) stay on the device until ``toc``, which reads them with
one copy.  On a hybridized block, as in the reference, the hooks ride the
numerics tier (``telemetry.numerics``, switched on by ``install``): each
monitored output is tapped as ``monitor.<name>``, and since a CUDA graph
replay runs no Python, the taps made while the block's graph is captured
are outputs of that graph and record on every replay.  ``toc`` drains
them (``numerics.consume("monitor.")``, one copy) and shows their l2
norm; ``stat_func`` applies on the eager path only.  ``install`` drops
the graphs captured before the hooks existed, so the next call captures
again with them.
"""
from __future__ import annotations

import re

from .base import MXNetError  # noqa: F401  (the reference's name)
from .telemetry import numerics as _numerics


def _default_stat(x):
    from . import ndarray as nd

    return nd.norm(x) / (x.size ** 0.5)


class Monitor:
    """Reference ``mx.monitor.Monitor``: ``tic()`` before the forward,
    ``toc()`` after it → ``[(step, name, stat_str), ...]`` for the blocks
    whose name matches ``pattern``."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func or _default_stat
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.queue = []
        self._handles = []
        self._compiled = False

    def install(self, block, monitor_all=False):
        """Watch every child block's forward output (with
        ``monitor_all`` its inputs too)."""
        if getattr(block, "_active", False):
            # the graph route needs the tier on, and a graph captured
            # before these hooks existed must be captured again
            if not _numerics.is_enabled():
                _numerics.enable()
            self._compiled = True
            block.apply(lambda b: setattr(b, "_cached_op", None)
                        if hasattr(b, "_cached_op") else None)

        def make_hook(name):
            def hook(blk, inputs, outputs):
                outs = outputs if isinstance(outputs, (list, tuple)) \
                    else (outputs,)
                for i, o in enumerate(outs):
                    suffix = f"_output{i}" if len(outs) > 1 else "_output"
                    self._stat(name + suffix, o)
                if monitor_all:
                    for i, o in enumerate(inputs):
                        self._stat(f"{name}_input{i}", o)
            return hook

        for name, child in block._children.items():
            full = child.name or name
            self._handles.append(
                child._register_observer(make_hook(full)))
            self.install(child, monitor_all)
        return self

    def uninstall(self):
        for h in self._handles:
            h.detach()
        self._handles = []

    def install_executor(self, executor):
        executor.set_monitor_callback(self._stat)

    def _stat(self, name, arr):
        if not self.re_pattern.match(name):
            return
        if self._compiled and _numerics.is_enabled():
            # the numerics bundle, not stat_func: inside a capture no
            # host callable can run at replay time
            _numerics.tap("monitor." + name, arr, keep=True)
            return
        if not self.activated:
            return
        self.queue.append((self.step, name, self.stat_func(arr)))

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        # the graph route's taps record on every call: drain them each
        # toc (off-interval ones are dropped) so the queue stays bounded
        compiled = _numerics.consume("monitor.") \
            if _numerics.is_enabled() else {}
        if not self.activated:
            return []
        self.activated = False
        stats = self._gather_stats([arr for _, _, arr in self.queue])
        res = [(step, name, s)
               for (step, name, _), s in zip(self.queue, stats)]
        for path, st in compiled.items():
            res.append((self.step - 1, path[len("monitor."):],
                        str(st["l2"])))
        if self.sort:
            res.sort(key=lambda t: t[1])
        self.queue = []
        return res

    @staticmethod
    def _gather_stats(arrs):
        """Each stat's first element as a string, the NDArray ones read
        from the device with one copy (one ``host_sync``)."""
        import torch

        from . import telemetry

        out = [None] * len(arrs)
        slots = [i for i, a in enumerate(arrs) if hasattr(a, "_data")]
        if slots:
            telemetry.count("host_sync")
            firsts = torch.stack([arrs[i]._data.detach().reshape(-1)[0]
                                  .float() for i in slots]).cpu().tolist()
            for i, v in zip(slots, firsts):
                out[i] = str(v)
        for i, a in enumerate(arrs):
            if out[i] is None:
                out[i] = str(a)
        return out

    def toc_print(self):
        for step, name, stat in self.toc():
            print(f"Batch: {step:7d} {name:30s} {stat}")

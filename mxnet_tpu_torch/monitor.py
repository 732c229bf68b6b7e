"""Training monitor: per-layer output statistics.

Counterpart of ``mxnet_tpu/monitor.py`` (reference
``python/mxnet/monitor.py``): ``Monitor(interval, stat_func, pattern,
sort)``; ``install(block)`` watches every child block's forward output
(and inputs with ``monitor_all``), ``tic()`` before a forward, ``toc()``
after it returns ``[(step, name, stat_str), ...]`` every ``interval``
batches, ``toc_print()`` prints them; ``install_executor`` takes an
``Executor``'s monitor callback.

The eager path is ported: the hooks are block observers
(``Block._register_observer``), which leave a fused 1×1 conv +
BatchNorm + ReLU run fused (the kernel still launches) and report each of
its blocks.  The stats stay on the device until ``toc``, which reads them
with one copy.  On a hybridized block the reference bakes its stats into
the compiled graph through the numerics taps (ROADMAP.md Queue 1 item 9,
``telemetry/numerics``); a CUDA graph replay runs no Python, so
``install`` on a hybridized block raises ``MXNetError`` naming item 9.
"""
from __future__ import annotations

import re

from .base import MXNetError


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

    def install(self, block, monitor_all=False):
        """Watch every child block's forward output (with
        ``monitor_all`` its inputs too)."""
        if getattr(block, "_active", False):
            raise MXNetError(
                "Monitor on a hybridized block is not ported yet "
                "(ROADMAP.md, Queue 1 item 9, observability and tooling: "
                "the numerics taps); call it before hybridize() or on "
                "hybridize(False)")

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
        if not self.activated or not self.re_pattern.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(arr)))

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        if not self.activated:
            return []
        self.activated = False
        stats = self._gather_stats([arr for _, _, arr in self.queue])
        res = [(step, name, s)
               for (step, name, _), s in zip(self.queue, stats)]
        if self.sort:
            res.sort(key=lambda t: t[1])
        self.queue = []
        return res

    @staticmethod
    def _gather_stats(arrs):
        """Each stat's first element as a string, the NDArray ones read
        from the device with one copy."""
        import torch

        out = [None] * len(arrs)
        slots = [i for i, a in enumerate(arrs) if hasattr(a, "_data")]
        if slots:
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

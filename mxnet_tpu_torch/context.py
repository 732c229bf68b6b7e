"""Device contexts: ``mx.cpu()`` and ``mx.gpu()``.

Counterpart of ``mxnet_tpu/context.py`` (reference
``python/mxnet/context.py``): ``Context(device_type, device_id)`` with a
thread-local stack of current contexts used as the default placement.

Here ``mx.gpu(i)`` is the CUDA device ``cuda:i`` and the process default
is ``gpu(0)``.  Asking for a card that is not there raises ``MXNetError``;
nothing falls back to the CPU.  Only an explicit ``mx.cpu()`` (or
``with mx.cpu():``) runs on the host.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError


class Context:
    """A device context: ``device_type`` is 'cpu' or 'gpu'."""

    _local = threading.local()

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type not in ("cpu", "gpu"):
            raise MXNetError(f"unknown device type {device_type!r}")
        device_id = int(device_id)
        if device_type == "gpu":
            n = num_gpus()
            if device_id >= n:
                raise MXNetError(
                    f"gpu({device_id}) requested but this process sees "
                    f"{n} CUDA device(s); use mx.cpu() to run on the host")
        self.device_type = device_type
        self.device_id = device_id

    @property
    def device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __enter__(self):
        stack = getattr(Context._local, "stack", None)
        if stack is None:
            stack = Context._local.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._local.stack.pop()

    @staticmethod
    def default_ctx() -> "Context":
        stack = getattr(Context._local, "stack", None)
        if stack:
            return stack[-1]
        return Context("gpu", 0)


def context_of(device: torch.device) -> Context:
    """The Context of a tensor's ``torch.device``."""
    if device.type == "cpu":
        return Context("cpu", 0)
    if device.type == "cuda":
        return Context("gpu", 0 if device.index is None else device.index)
    raise MXNetError(f"unsupported device {device}")


def cpu(device_id: int = 0) -> Context:
    """CPU context (reference ``mx.cpu``)."""
    return Context("cpu", device_id)


def gpu(device_id: int = 0, mesh=None) -> Context:
    """CUDA device ``cuda:device_id`` (reference ``mx.gpu``); raises
    ``MXNetError`` when the process has no such card.

    ``mesh`` activates a device mesh for the process in the same call
    (``mx.gpu(mesh={'dp': 2, 'tp': 2})``, the counterpart of the
    reference's ``mx.tpu(mesh=)``): a dict builds one with
    ``parallel.make_mesh`` over the process group, a ``DeviceMesh`` is
    used as it is.  ``Trainer(partition_rules=...)`` and
    ``parallel.shard_batch`` then pick it up."""
    ctx = Context("gpu", device_id)
    if mesh is not None:
        from . import parallel  # deferred: parallel imports context

        if isinstance(mesh, dict):
            mesh = parallel.make_mesh(mesh)
        parallel.set_mesh(mesh)
    return ctx


def tpu(device_id: int = 0, mesh=None) -> Context:
    """The reference's accelerator context, so its scripts run unchanged:
    here the CUDA card ``gpu(device_id)`` (``mesh`` as ``gpu``'s)."""
    return gpu(device_id, mesh=mesh)


def num_tpus() -> int:
    """The reference's accelerator count: the CUDA cards here."""
    return num_gpus()


def current_context() -> Context:
    """The innermost ``with ctx:`` context, else ``gpu(0)``."""
    return Context.default_ctx()


def num_gpus() -> int:
    """Number of CUDA devices this process sees (reference
    ``mx.context.num_gpus``)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_devices(device_type=None) -> int:
    """Devices this process sees (reference ``num_devices``): its CUDA
    cards, or 1 for ``'cpu'``."""
    if device_type == "cpu":
        return 1
    return num_gpus()


def global_num_devices() -> int:
    """Devices across the process group: one a rank (reference
    ``global_num_devices``)."""
    from . import parallel

    return parallel.world_size()

"""Runtime kernels.

Counterpart of ``mxnet_tpu/rtc.py`` (reference ``python/mxnet/rtc.py``).
``PallasKernel`` keeps its name and role: it wraps a user's callable on
raw tensors (here ``torch.Tensor``s, which may launch the user's own
Triton or ``ctypes`` kernel) into an ``mx.nd`` op through
``ops.registry.apply_op``, so the autograd tape, amp's casts and the
profiler's events apply to it as to every built-in op; the gradient is
torch's, through the callable (a kernel the callable launches needs its
own ``torch.autograd.Function`` to be differentiable).  ``CudaModule``
(NVRTC) raises, as in the reference: the JAX package has no runtime CUDA
compiler to port (ROADMAP.md, "Not carried over").
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["CudaModule", "PallasKernel"]


class CudaModule:
    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "rtc.CudaModule (NVRTC runtime compilation) has no counterpart "
            "in the port (ROADMAP.md, Not carried over): wrap a callable "
            "on torch tensors, which may launch your own Triton or "
            "ctypes kernel, with mxnet_tpu_torch.rtc.PallasKernel")


class PallasKernel:
    """Wrap ``fn(*raw_tensors) -> tensor (or tuple)`` into an ``mx.nd``
    op named ``name``; ``launch(*ndarrays, **const)`` binds ``const`` as
    keyword arguments of ``fn``."""

    def __init__(self, fn, name=None):
        self._fn = fn
        self._name = name or getattr(fn, "__name__", "pallas_kernel")

    def launch(self, *args, **const):
        from .ops.registry import apply_op

        if const:
            fn = self._fn

            def bound(*raws):
                return fn(*raws, **const)

            return apply_op(bound, *args, name=self._name)
        return apply_op(self._fn, *args, name=self._name)

    __call__ = launch

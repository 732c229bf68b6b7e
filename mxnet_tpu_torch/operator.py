"""Custom operators written in Python.

Counterpart of ``mxnet_tpu/operator.py`` (reference
``python/mxnet/operator.py`` and ``src/operator/custom/custom.cc``):
users subclass ``CustomOp`` (``forward``/``backward`` writing through
``self.assign``) and ``CustomOpProp`` (shapes, types, the operator
factory), register the prop with ``@mx.operator.register("name")`` and
call it as ``mx.nd.Custom(..., op_type="name")``.

The user's Python runs on every call, inside ``with`` the inputs'
context (``mx.nd.array`` there lands beside them).  Under
``autograd.record()`` the op is one node of torch's graph (a
``torch.autograd.Function`` whose backward calls the user's
``backward``), as the reference's tape node is.  The reference's traced
route (``pure_callback`` inside a jitted graph) has no counterpart in a
CUDA graph, which would replay the first call's result: a hybridized
block whose forward reaches ``Custom`` runs eagerly on every call
(``cache_stats()["eager"]``), and any other capture that reaches it
raises ``MXNetError`` naming the op (``cuda_graph.host_op``).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, resolve_dtype
from .context import context_of

_REGISTRY = {}


class CustomOp:
    """Base class of user ops (reference ``mx.operator.CustomOp``)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` by the request ``req``: ``"write"``
        and ``"inplace"`` replace, ``"add"`` accumulates, ``"null"``
        skips."""
        if req == "null":
            return
        from .ndarray import NDArray

        if isinstance(src, NDArray):
            s = src._data
        elif isinstance(src, torch.Tensor):
            s = src
        else:
            s = torch.as_tensor(np.asarray(src))
        s = s.to(device=dst._data.device, dtype=dst.dtype)
        dst._data = dst._data + s if req == "add" else s


class CustomOpProp:
    """Op metadata and factory (reference ``mx.operator.CustomOpProp``)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def infer_storage_type(self, in_stype):
        return in_stype, ["default"] * len(self.list_outputs()), []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        return list(out_grad) + list(in_data) + list(out_data)

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError

    def need_top_grad(self):
        return self.need_top_grad_


def register(reg_name):
    """Decorator registering a ``CustomOpProp`` subclass under
    ``reg_name`` (reference ``mx.operator.register``)."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register() expects a CustomOpProp subclass")
        _REGISTRY[reg_name] = prop_cls
        return prop_cls

    return deco


def get_all_registered_operators():
    return sorted(_REGISTRY)


def _make_prop(op_type, kwargs):
    if op_type not in _REGISTRY:
        raise MXNetError(
            f"custom op {op_type!r} is not registered; known: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[op_type](**{k: str(v) for k, v in kwargs.items()})


def _zeros(shapes, dtypes, device):
    from .ndarray import NDArray

    return [NDArray(torch.zeros(tuple(s), dtype=resolve_dtype(t),
                                device=device))
            for s, t in zip(shapes, dtypes)]


class _CustomFunction(torch.autograd.Function):
    """One recorded call: the user's ``forward`` and ``backward`` as a
    node of torch's graph."""

    @staticmethod
    def forward(ctx, call, *raws):
        from .ndarray import NDArray

        ctx.call = call
        ins = [NDArray(r) for r in raws]
        outs = call.run_forward(True, ins)
        ctx.save_for_backward(*raws, *(o._data for o in outs))
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cots):
        from . import autograd as ag
        from .ndarray import NDArray

        call = ctx.call
        if torch.is_grad_enabled():
            raise MXNetError(
                f"Custom({call.op_type}): a custom op's backward is not "
                "differentiable (autograd.grad(create_graph=True))")
        saved = ctx.saved_tensors
        k = len(saved) - call.n_out
        ins = [NDArray(r) for r in saved[:k]]
        outs = [NDArray(r) for r in saved[k:]]
        device = saved[0].device
        grads = _zeros(call.in_shapes, call.in_types, device)
        with ag.pause(), context_of(device):
            call.op.backward(["write"] * k,
                             [NDArray(c.contiguous()) for c in cots], ins,
                             outs, grads, [])
        return (None,) + tuple(g._data for g in grads)


class _Call:
    def __init__(self, op, op_type, in_shapes, in_types, out_shapes,
                 out_types):
        self.op, self.op_type = op, op_type
        self.in_shapes, self.in_types = in_shapes, in_types
        self.out_shapes, self.out_types = out_shapes, out_types
        self.n_out = len(out_shapes)

    def run_forward(self, is_train, ins):
        from . import autograd as ag

        device = ins[0]._data.device
        outs = _zeros(self.out_shapes, self.out_types, device)
        with ag.pause(ag.is_training()), context_of(device):
            self.op.forward(is_train, ["write"] * self.n_out, ins, outs, [])
        return outs


def custom(*data, op_type=None, **kwargs):
    """``mx.nd.Custom``: run the registered op ``op_type`` on ``data``
    (the prop's constructor takes ``kwargs`` as strings, as in the
    reference)."""
    from . import autograd as ag
    from . import cuda_graph
    from .ndarray import NDArray

    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    cuda_graph.host_op(f"Custom(op_type={op_type!r})")
    prop = _make_prop(op_type, kwargs)
    in_shapes = [list(d.shape) for d in data]
    _, out_shapes, _ = prop.infer_shape(in_shapes)
    in_types = [d.dtype for d in data]
    _, out_types, _ = prop.infer_type(in_types)
    op = prop.create_operator(data[0].context, in_shapes, in_types)
    call = _Call(op, op_type, in_shapes, in_types, out_shapes, out_types)
    recording = ag.is_recording()
    if recording and any(d._data.requires_grad for d in data):
        with torch.enable_grad():
            raws = _CustomFunction.apply(call, *(d._data for d in data))
        outs = [NDArray(r) for r in raws]
    else:
        outs = call.run_forward(recording, list(data))
    return outs[0] if call.n_out == 1 else tuple(outs)

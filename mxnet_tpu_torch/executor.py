"""Executor: bound evaluation of a symbolic graph.

Counterpart of ``mxnet_tpu/executor.py`` (reference
``python/mxnet/executor.py`` over ``src/executor/graph_executor.cc``).
``forward`` walks the graph in topological order through the op registry,
one NDArray op a node, on the arrays' device (the card's kernels where
an op has one); ``backward`` is torch autograd over what the training
forward recorded.  BatchNorm's moving statistics are committed into the
aux arrays after a training forward, where the reference's op mutated its
aux inputs in place.
"""
from __future__ import annotations

import torch

from . import autograd as ag
from .base import MXNetError, resolve_dtype
from .context import current_context
from .ndarray import NDArray
from .ops import registry as _op_registry

__all__ = ["Executor"]

# ops that return (out, new_moving_mean, new_moving_var): outputs 1,2 are
# commits into aux inputs 3,4 during training
_BN_OPS = {"BatchNorm", "batch_norm"}


class Executor:
    """Holds bound arg/grad/aux arrays and runs forward/backward."""

    def __init__(self, symbol, ctx, arg_dict, grad_dict, aux_dict,
                 grad_req):
        self._symbol = symbol
        self._ctx = ctx or current_context()
        self.arg_dict = arg_dict
        self.grad_dict = grad_dict
        self.aux_dict = aux_dict
        self._grad_req = grad_req          # name -> req string
        self._monitor_callback = None
        self._monitor_all = False
        self.outputs = []
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        for name, arr in arg_dict.items():
            req = grad_req.get(name, "null")
            if req != "null":
                arr.attach_grad(grad_req=req)
                self.grad_dict[name] = arr.grad

    # --- array views --------------------------------------------------------

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    # --- binding ------------------------------------------------------------

    @staticmethod
    def _simple_bind(symbol, ctx, grad_req, type_dict, shape_kwargs):
        arg_shapes, _out, aux_shapes = symbol.infer_shape(**shape_kwargs)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        type_dict = type_dict or {}
        device = (ctx or current_context()).device
        arg_dict, aux_dict = {}, {}
        for name, shape in zip(arg_names, arg_shapes):
            dt = resolve_dtype(type_dict.get(name, "float32"))
            arg_dict[name] = NDArray(torch.zeros(shape, dtype=dt,
                                                 device=device))
        for name, shape in zip(aux_names, aux_shapes):
            dt = resolve_dtype(type_dict.get(name, "float32"))
            fill = torch.ones if name.endswith("var") else torch.zeros
            aux_dict[name] = NDArray(fill(shape, dtype=dt, device=device))
        reqs = Executor._norm_grad_req(grad_req, arg_names)
        return Executor(symbol, ctx, arg_dict, {}, aux_dict, reqs)

    @staticmethod
    def _bind(symbol, ctx, args, args_grad, grad_req, aux_states):
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        arg_dict = Executor._to_dict(args, arg_names, "args")
        aux_dict = Executor._to_dict(aux_states, aux_names, "aux_states") \
            if aux_states is not None else {
                n: None for n in aux_names}
        if aux_names and any(v is None for v in aux_dict.values()):
            raise MXNetError("aux_states required for symbols with "
                             f"auxiliary states {aux_names}")
        reqs = Executor._norm_grad_req(grad_req, arg_names)
        exe = Executor(symbol, ctx, arg_dict, {}, aux_dict, reqs)
        if args_grad:
            # caller-provided gradient buffers: redirect commits
            gd = Executor._to_dict(args_grad, arg_names, "args_grad",
                                   allow_missing=True)
            for name, buf in gd.items():
                if buf is None:
                    continue
                arr = arg_dict[name]
                if arr._grad is not None:
                    ag.mark_variables([arr], [buf], arr._grad_req)
                    exe.grad_dict[name] = buf
        return exe

    @staticmethod
    def _to_dict(arrays, names, what, allow_missing=False):
        if arrays is None:
            raise MXNetError(f"{what} is required for bind")
        if isinstance(arrays, dict):
            out = {}
            for n in names:
                if n not in arrays and not allow_missing:
                    raise MXNetError(f"{what} missing entry for {n!r}")
                out[n] = arrays.get(n)
            return out
        arrays = list(arrays)
        if len(arrays) != len(names):
            raise MXNetError(
                f"{what} has {len(arrays)} entries, expected {len(names)}")
        return dict(zip(names, arrays))

    @staticmethod
    def _norm_grad_req(grad_req, arg_names):
        if isinstance(grad_req, str):
            return {n: grad_req for n in arg_names}
        if isinstance(grad_req, (list, tuple)):
            return dict(zip(arg_names, grad_req))
        return {n: grad_req.get(n, "null") for n in arg_names}

    # --- execution ----------------------------------------------------------

    def _run_graph(self, is_train):
        values = {}
        bn_commits = []
        for node in self._symbol._topo():
            if node.is_var():
                name = node.name
                if name in self.arg_dict:
                    values[id(node)] = (self.arg_dict[name],)
                elif name in self.aux_dict:
                    values[id(node)] = (self.aux_dict[name],)
                else:
                    raise MXNetError(f"unbound variable {name!r}")
                continue
            fn = _op_registry.get_op(node.op)
            if fn is None:
                raise MXNetError(f"op {node.op!r} not in registry")
            attrs = {k: v for k, v in node.attrs.items()
                     if not k.startswith("__")}
            ins = [values[id(s)][oi] for s, oi in node.inputs]
            out = fn(*ins, **attrs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            values[id(node)] = tuple(outs)
            if self._monitor_callback is not None:
                if getattr(self, "_monitor_all", False):
                    for ii, i_arr in enumerate(ins):
                        self._monitor_callback(
                            f"{node.name}_input{ii}", i_arr)
                for oi, o in enumerate(outs):
                    suffix = f"_output{oi}" if len(outs) > 1 else "_output"
                    self._monitor_callback(node.name + suffix, o)
            if node.op in _BN_OPS and is_train and len(outs) >= 3 and \
                    len(node.inputs) >= 5:
                bn_commits.append((node, outs))
        if is_train:
            for node, outs in bn_commits:
                for slot, new in ((3, outs[1]), (4, outs[2])):
                    src, _ = node.inputs[slot]
                    aux = self.aux_dict.get(src.name)
                    if aux is None:
                        aux = self.arg_dict.get(src.name)
                    if aux is not None:
                        aux._data = new._data.detach().to(aux.dtype)
        return [values[id(n)][oi] for n, oi in self._symbol._heads]

    def set_monitor_callback(self, callback, monitor_all=False):
        """Install a per-op-output callback ``cb(name, array)`` invoked
        during ``forward``; ``monitor_all`` also reports op inputs
        (reference ``MXExecutorSetMonitorCallback{,EX}``,
        src/c_api/c_api_executor.cc:?)."""
        self._monitor_callback = callback
        self._monitor_all = monitor_all

    def forward(self, is_train=False, **kwargs):
        for name, value in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError(f"unknown input {name!r}")
            arr = self.arg_dict[name]
            v = value._data if isinstance(value, NDArray) else \
                NDArray(value, ctx=arr.context)._data
            _rebind(arr, v.to(device=arr._data.device, dtype=arr.dtype))
        if is_train:
            with ag.record():
                self.outputs = self._run_graph(True)
        else:
            with ag.pause():
                self.outputs = self._run_graph(False)
        return self.outputs

    def backward(self, out_grads=None):
        """Backward from the outputs of the last training forward; an
        output with no recorded history (``BlockGrad``) contributes
        nothing, as in the reference."""
        if not self.outputs:
            raise MXNetError("call forward(is_train=True) before backward")
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        grads = [None] * len(self.outputs) if out_grads is None \
            else list(out_grads)
        pairs = [(h, g) for h, g in zip(self.outputs, grads)
                 if h._data.requires_grad]
        if pairs:
            heads, grads = zip(*pairs)
            ag.backward(list(heads), None if out_grads is None
                        else list(grads))

    # --- misc ---------------------------------------------------------------

    def copy_params_from(self, arg_params, aux_params=None):
        """Copy values into the bound arrays, each in its own dtype and on
        its own device (names the graph lacks are skipped)."""
        for table, params in ((self.arg_dict, arg_params),
                              (self.aux_dict, aux_params)):
            for name, arr in (params or {}).items():
                if name in table:
                    dst = table[name]
                    src = arr._data if isinstance(arr, NDArray) else \
                        torch.as_tensor(arr)
                    _rebind(dst, src.detach().to(device=dst._data.device,
                                                 dtype=dst.dtype))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """Re-bind with new input shapes; the parameters are carried over,
        the reshaped inputs are not (the reference copies the old inputs
        over the new ones, so its reshaped executor keeps the old
        shapes)."""
        shapes = {k: v for k, v in kwargs.items() if k in self.arg_dict}
        exe = Executor._simple_bind(
            self._symbol, self._ctx,
            {n: r for n, r in self._grad_req.items()}, None, shapes)
        exe.copy_params_from({k: v for k, v in self.arg_dict.items()
                              if k not in shapes}, self.aux_dict)
        return exe


def _rebind(arr, tensor):
    """Point ``arr`` at ``tensor`` (not recorded), keeping its
    variable state: an array with a gradient request stays a variable of
    the tape with the same gradient buffer."""
    req, grad = arr._grad_req, arr._grad
    if req == "null":
        arr._data = tensor.detach()
    else:  # a copy: the caller's tensor must not become a variable
        arr._data = tensor.detach().clone()
        ag.mark_variables([arr], [grad], req)

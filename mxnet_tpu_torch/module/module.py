"""Module: a Symbol bound to data shapes and an optimizer.

Counterpart of ``mxnet_tpu/module/module.py`` (reference
``python/mxnet/module/module.py`` and ``executor_group.py``).  The
reference slices each batch across a context list and keeps one
executor a device; here there is one executor on the module's context
(a list gives its first), as in the JAX package.  ``update`` applies the
optimizer to every parameter at once through ``Updater.update_many``:
on the card one launch of the fused multi-tensor kernel where its rule
applies (``ops/multi_tensor.py``), as ``gluon.Trainer`` does.
"""
from __future__ import annotations

import torch

from .. import initializer as _init
from .. import optimizer as _opt
from ..base import MXNetError
from ..context import current_context
from ..initializer import InitDesc
from ..ndarray import NDArray
from .base_module import BaseModule


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=None, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        if isinstance(context, (list, tuple)):
            context = context[0] if context else None
        self._context = context or current_context()
        self._fixed_param_names = set(fixed_param_names or [])
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._data_shapes = None
        self._label_shapes = None
        arg_names = symbol.list_arguments()
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()

    # --- bind ---------------------------------------------------------------

    @staticmethod
    def _shape_dict(shapes):
        out = {}
        for item in shapes or []:
            if hasattr(item, "name"):
                out[item.name] = tuple(item.shape)
            else:
                name, shape = item[0], item[1]
                out[name] = tuple(shape)
        return out

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self._data_shapes = self._shape_dict(data_shapes)
        self._label_shapes = self._shape_dict(label_shapes)
        shapes = dict(self._data_shapes)
        shapes.update(self._label_shapes)
        reqs = {}
        for n in self._symbol.list_arguments():
            if not for_training:
                reqs[n] = "null"
            elif n in self._fixed_param_names:
                reqs[n] = "null"
            elif n in self._data_names:
                reqs[n] = "write" if inputs_need_grad else "null"
            elif n in self._label_names:
                reqs[n] = "null"
            else:
                reqs[n] = grad_req
        old_exec = self._exec if shared_module is None else \
            shared_module._exec
        self._exec = self._symbol.simple_bind(
            ctx=self._context, grad_req=reqs, **shapes)
        if old_exec is not None and self.params_initialized:
            self._exec.copy_params_from(
                old_exec.arg_dict, old_exec.aux_dict)
        if shared_module is not None and shared_module.params_initialized:
            self.params_initialized = True
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    # --- params -------------------------------------------------------------

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        initializer = initializer or _init.Uniform(0.01)
        attr_dict = self._symbol.attr_dict()
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params and name in arg_params:
                self._set_array(arr, arg_params[name])
            elif arg_params and not allow_missing and name not in arg_params:
                raise MXNetError(f"arg_params missing {name!r}")
            else:
                desc = InitDesc(name, attr_dict.get(name, {}))
                initializer(desc, arr)
        for name in self._aux_names:
            arr = self._exec.aux_dict[name]
            if aux_params and name in aux_params:
                self._set_array(arr, aux_params[name])
            else:
                desc = InitDesc(name, attr_dict.get(name, {}))
                initializer(desc, arr)
        self.params_initialized = True

    @staticmethod
    def _set_array(dst, src):
        """Copy ``src`` into the bound array ``dst`` (its dtype, device
        and variable state)."""
        from ..executor import _rebind

        raw = src._data if isinstance(src, NDArray) else \
            NDArray(src, ctx=dst.context)._data
        _rebind(dst, raw.to(device=dst._data.device, dtype=dst.dtype))

    def get_params(self):
        if not self.binded:
            raise MXNetError("module not bound")
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    # --- optimizer ----------------------------------------------------------

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, _opt.Optimizer):
            self._optimizer = optimizer
        else:
            opt_params = dict(optimizer_params)
            idx2name = dict(enumerate(self._param_names))
            opt_params.setdefault("param_idx2name", idx2name)
            # the reference normalizes by batch size here (its
            # init_optimizer's rescale_grad default)
            if self._data_shapes:
                batch = next(iter(self._data_shapes.values()))[0]
                opt_params.setdefault("rescale_grad", 1.0 / batch)
            self._optimizer = _opt.create(optimizer, **opt_params)
        self._updater = _opt.get_updater(self._optimizer)
        from .. import kvstore as _kv

        self._kvstore = None
        if kvstore:
            kv = kvstore if not isinstance(kvstore, str) else \
                _kv.create(kvstore)
            # single-process local kvstore adds nothing over direct update;
            # keep it for dist modes where push/pull crosses the mesh
            if getattr(kv, "num_workers", 1) > 1 or \
                    not isinstance(kvstore, str) or \
                    "dist" in getattr(kv, "type", str(kvstore)):
                self._kvstore = kv
                for i, name in enumerate(self._param_names):
                    self._kvstore.init(i, self._exec.arg_dict[name])
        self.optimizer_initialized = True

    # --- compute ------------------------------------------------------------

    def forward(self, data_batch, is_train=None):
        if not self.binded:
            raise MXNetError("module not bound")
        if is_train is None:
            is_train = self.for_training
        feeds = {}
        data = data_batch.data if hasattr(data_batch, "data") else data_batch
        for name, arr in zip(self._data_names, data):
            feeds[name] = arr
        labels = getattr(data_batch, "label", None) or []
        for name, arr in zip(self._label_names, labels):
            if name in self._exec.arg_dict:
                feeds[name] = arr
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads)

    def update(self):
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer before update")
        idx, grads, weights = [], [], []
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            weight = self._exec.arg_dict[name]
            if self._kvstore is not None:
                self._kvstore.push(i, grad)
                self._kvstore.pull(i, out=grad)
            idx.append(i)
            grads.append(grad)
            weights.append(weight)
        if idx:
            with torch.no_grad():
                self._updater.update_many(idx, grads, weights)

    def get_outputs(self, merge_multi_context=True):
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # --- checkpoint ---------------------------------------------------------

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from .. import serialization

        arg, aux = self.get_params()
        serialization.save_checkpoint(prefix, epoch, symbol=self._symbol,
                                      arg_params=arg, aux_params=aux)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    def save_optimizer_states(self, fname):
        import pickle

        states = self._updater.get_states(dump_optimizer=False) if \
            hasattr(self._updater, "get_states") else pickle.dumps({})
        with open(fname, "wb") as f:
            f.write(states)

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            data = f.read()
        if hasattr(self._updater, "set_states"):
            self._updater.set_states(data)

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        from .. import serialization

        sym, arg_params, aux_params = serialization.load_checkpoint(
            prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._preloaded = (arg_params, aux_params)
        mod._arg_params_cache = arg_params
        mod._aux_params_cache = aux_params
        return mod

    def init_params_from_cache(self):
        if hasattr(self, "_preloaded"):
            arg, aux = self._preloaded
            self.init_params(arg_params=arg, aux_params=aux,
                             allow_missing=False, force_init=True)

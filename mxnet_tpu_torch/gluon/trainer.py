"""gluon.Trainer — applies an optimizer to a set of Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference
``python/mxnet/gluon/trainer.py``): ``step(batch_size)`` aggregates the
gradients through the KVStore (push then pull; on one device this moves
nothing) and applies the optimizer to each parameter in turn, with
``rescale_grad = scale / batch_size``, as the reference's eager path
does.

Not ported in this slice, each raising ``MXNetError`` that names its
ROADMAP item: ``partition_rules``/``mesh`` and ``update_on_kvstore=True``
and gradient compression (multi-GPU, Queue 1 item 5), ``offload="host"``
(Queue 1, "Left out of slice 2"), and ``save_states``/``load_states``
(checkpoints, Queue 1 item 4).  The reference's fused multi-tensor update
(one compiled program per step) is an XLA device; here each parameter's
update is a few eager kernels, and a fused update is later work (Queue 1
item 4).  The preemption-drain handlers port with checkpoints.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import kvstore as kvs
from .. import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _not_ported(what, item):
    return MXNetError(f"{what} is not ported yet (ROADMAP.md, Queue 1 "
                      f"{item})")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, partition_rules=None, mesh=None,
                 offload=None):
        if partition_rules is not None or mesh is not None:
            raise _not_ported("Trainer(partition_rules=..., mesh=...)",
                              "item 5, multi-GPU")
        if update_on_kvstore:
            raise _not_ported("Trainer(update_on_kvstore=True)",
                              "item 5, multi-GPU")
        if compression_params:
            raise _not_ported("gradient compression", "item 5, multi-GPU")
        if offload is not None:
            raise _not_ported(f"Trainer(offload={offload!r})",
                              "\"Left out of slice 2\"")
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError(
                "params must be a ParameterDict, dict, or list of Parameters")
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise MXNetError(f"element {i} is not a Parameter")
            self._param2idx[param.name] = i
            self._params.append(param)
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        self._kvstore_type = kvstore
        self._kvstore = None
        self._kv_initialized = False

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            if contexts is not None and contexts != ctx:
                raise MXNetError(
                    f"all Parameters must share contexts; {param.name} has "
                    f"{ctx} vs {contexts}")
            contexts = ctx
        return contexts or []

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError(
                    "optimizer_params must be None when optimizer is an "
                    "Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._states = [None] * len(self._params)
        self._states_initialized = [False] * len(self._params)

    def _init_states(self, i):
        if not self._states_initialized[i]:
            self._states[i] = self._optimizer.create_state_multi_precision(
                i, self._params[i].data())
            self._states_initialized[i] = True

    def _init_kvstore(self):
        if self._kvstore_type is not None:
            self._kvstore = kvs.create(self._kvstore_type)
        self._kv_initialized = True

    # -- public properties ---------------------------------------------------
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # -- the step ------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Aggregate gradients and apply one optimizer update, scaling
        gradients by 1/batch_size (reference ``Trainer.step``)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        for i, param in enumerate(self._params):
            if param.grad_req != "null":
                self._kvstore.init(i, param.grad())
                self._kvstore.push(i, param.grad())
                self._kvstore.pull(i, param.grad())

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if param._data is None:
                if param._deferred_init is not None:
                    continue  # untouched deferred param: nothing to update
                raise MXNetError(
                    f"parameter {param.name} was not initialized")
            self._init_states(i)
            self._optimizer.update_multi_precision(
                i, param.data(), param.grad(), self._states[i])

    def save_states(self, fname):
        raise _not_ported("Trainer.save_states", "item 4, checkpoints")

    def load_states(self, fname):
        raise _not_ported("Trainer.load_states", "item 4, checkpoints")

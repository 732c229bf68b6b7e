"""gluon.Trainer — applies an optimizer to a set of Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference
``python/mxnet/gluon/trainer.py``): ``step(batch_size)`` aggregates the
gradients through the KVStore (push then pull; on one device this moves
nothing) and applies the optimizer with ``rescale_grad = scale /
batch_size``.  The update is the reference's fused multi-tensor route
(``_try_fused_update``): every live parameter in one launch of the
hand-written kernel (``ops/multi_tensor.py``; its plain version, the
per-tensor rule, on the CPU).  Under ``NaiveEngine`` (the user's explicit
choice, ``engine.set_engine_type``) each parameter is updated in turn by
its eager rule, as the reference does.

``save_states``/``load_states`` write and read the reference's pickle of
numpy states, so the files interchange with it both ways.  The
single-host preemption handlers are here (``install_preemption_handler``,
``drain_requested``, ``request_drain``, ``reset_drain``);
``drain_consensus`` needs more than one host and raises (Queue 1 item
5).  Not ported, each raising ``MXNetError`` that names its ROADMAP
item: ``partition_rules``/``mesh`` and ``update_on_kvstore=True`` and
gradient compression (multi-GPU, Queue 1 item 5), and
``offload="host"`` (Queue 1, "Left out of slice 2").
"""
from __future__ import annotations

import pickle
import signal
import threading

import torch

from ..base import MXNetError
from .. import engine
from .. import kvstore as kvs
from .. import optimizer as opt
from ..ndarray import NDArray
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer", "PREEMPTED_EXIT_CODE", "install_preemption_handler",
           "drain_requested", "drain_consensus", "request_drain",
           "reset_drain"]

#: BSD EX_TEMPFAIL, "transient failure, retry later": the exit status of a
#: graceful preemption drain (``checkpoint.drain_checkpoint_and_exit``)
PREEMPTED_EXIT_CODE = 75

_DRAIN = threading.Event()


def install_preemption_handler(signums=(signal.SIGTERM,)):
    """Make the given signals set the drain flag instead of killing the
    process (call on the main thread, before training).  The training
    loop polls ``drain_requested()`` after each step, cuts a final
    checkpoint and exits with ``PREEMPTED_EXIT_CODE``
    (``checkpoint.drain_checkpoint_and_exit``).  Returns the flag."""
    def _on_signal(_signum, _frame):
        _DRAIN.set()

    for signum in signums:
        signal.signal(signum, _on_signal)
    return _DRAIN


def drain_requested():
    """True once a drain signal arrived: poll after each completed step."""
    return _DRAIN.is_set()


def drain_consensus():
    """Whether any rank asked to drain: a collective over the ranks of a
    multi-host job, which is ROADMAP Queue 1 item 5 (multi-GPU)."""
    raise MXNetError("drain_consensus (the ranks' agreement to drain) "
                     "needs more than one host and is not ported yet "
                     "(ROADMAP.md, Queue 1 item 5, multi-GPU); one process "
                     "polls drain_requested()")


def request_drain():
    """Programmatic drain (tests, in-process schedulers)."""
    _DRAIN.set()


def reset_drain():
    """Clear the drain flag (a new run in the same process)."""
    _DRAIN.clear()


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
        self._update_on_kvstore = False
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
        if self._try_fused_update():
            return
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

    def _live(self):
        """Indices of the parameters a step updates."""
        live = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if param._data is None:
                if param._deferred_init is not None:
                    continue  # untouched deferred param: nothing to update
                raise MXNetError(
                    f"parameter {param.name} was not initialized")
            live.append(i)
        return live

    def _fused_operands(self, live):
        """(mp flags, weights, masters, gradients, states) of the live
        parameters as raw tensors, as the fused update takes them
        (``masters`` holds only the multi-precision ones)."""
        optzr = self._optimizer
        mp_flags, m_raws, states = [], [], []
        for i in live:
            state = self._states[i]
            use_mp = optzr.multi_precision and \
                self._params[i].dtype in opt._LOW
            if use_mp:
                master, state = state
                m_raws.append(master._data)
            mp_flags.append(use_mp)
            states.append(opt._flatten_state(state))
        w_raws = [self._params[i].data()._data for i in live]
        g_raws = [self._params[i].grad()._data.contiguous() for i in live]
        return mp_flags, w_raws, m_raws, g_raws, states

    def _try_fused_update(self):
        """Every live parameter in one launch of the multi-tensor kernel
        (reference ``Trainer._try_fused_update``).  False when the
        NaiveEngine is chosen or the optimizer has no rule of the
        kernel (or overrides the rule's ``_step``): the caller then
        updates parameter by parameter."""
        optzr = self._optimizer
        if engine.is_naive() or optzr._kernel_rule() is None:
            return False
        live = self._live()
        if not live:
            return True
        for i in live:
            self._init_states(i)
            optzr._update_count(i)
        lrs = [optzr._get_lr(i) for i in live]
        wds = [optzr._get_wd(i) for i in live]
        ts = [optzr._index_update_count[i] for i in live]
        opt._fused_param_updates(optzr, *self._fused_operands(live), lrs,
                                 wds, ts)
        return True

    # -- state persistence ---------------------------------------------------
    def save_states(self, fname):
        """Pickle the optimizer states as numpy arrays with the update
        counts (the reference's payload: its ``load_states`` reads this
        file, and this one reads its files)."""
        if not self._kv_initialized:
            self._init_kvstore()
        for i, param in enumerate(self._params):
            if param.grad_req != "null" and param._data is not None:
                self._init_states(i)
        payload = {
            "states": {i: opt._states_to_numpy(s)
                       for i, s in enumerate(self._states)},
            "num_update": self._optimizer.num_update,
            "index_update_count": dict(
                self._optimizer._index_update_count),
        }
        with open(fname, "wb") as f:
            pickle.dump(payload, f)

    def load_states(self, fname):
        """Load ``save_states``' file (or the reference's): each state is
        copied into the parameter's own state tensors (created first if
        the trainer has not stepped yet), in their dtype and on their
        device, so a captured ``FusedTrainStep`` keeps its addresses."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "rb") as f:
            payload = pickle.load(f)
        saved = payload["states"]
        for i, param in enumerate(self._params):
            state = saved.get(i)
            if state is None:
                continue
            if param._data is None:
                raise MXNetError(f"load_states: parameter {param.name} is "
                                 "not initialized")
            self._init_states(i)
            _copy_state(self._states[i], state, param.name)
        self._optimizer.num_update = payload["num_update"]
        self._optimizer._index_update_count.update(
            payload["index_update_count"])


def _copy_state(holder, value, name):
    """Copy a numpy state (``_states_to_numpy``'s nesting) into the
    NDArrays of ``holder`` in place."""
    if holder is None and value is None:
        return
    if isinstance(holder, NDArray):
        src = torch.as_tensor(value)
        if tuple(src.shape) != holder.shape:
            raise MXNetError(f"load_states: state of {name} has shape "
                             f"{tuple(src.shape)}, expected {holder.shape}")
        with torch.no_grad():
            holder._data.copy_(src)
        return
    if not isinstance(holder, tuple) or not isinstance(value, tuple) or \
            len(holder) != len(value):
        raise MXNetError(f"load_states: the state of {name} does not match "
                         "this optimizer's")
    for h, v in zip(holder, value):
        _copy_state(h, v, name)

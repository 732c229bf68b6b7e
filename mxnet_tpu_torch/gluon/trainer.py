"""gluon.Trainer — applies an optimizer to a set of Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference
``python/mxnet/gluon/trainer.py``): ``step(batch_size)`` aggregates the
gradients through the KVStore and applies the optimizer with
``rescale_grad = scale / batch_size``.  The update is the reference's
fused multi-tensor route (``_try_fused_update``): every live parameter
in one launch of the hand-written kernel (``ops/multi_tensor.py``; its
plain version, the per-tensor rule, on the CPU), fed each rank's local
pieces (``parallel.local``).  Under ``NaiveEngine`` each parameter is
updated in turn by its eager rule, as the reference does.

Distributed training (``parallel``): ``kvstore="dist_sync"`` (or
``dist_tpu_sync``, ``dist_device_sync``, ``horovod``) sums the ranks'
gradients; ``mesh=`` (a ``DeviceMesh`` or a ``{'dp': 2, 'tp': 2}``
dict) with ``partition_rules=`` (a table, a family name such as
``"llama"``, or a ``PartitionRules``) places every parameter as a
``DTensor`` at construction (``mesh=`` alone: pure data parallelism),
and ``placement`` is the coverage report.  A gradient still ``Partial``
over the mesh when the update runs (no store, or a local one) is
reduced first, so the optimizer and ``clip_global_norm`` see the summed
gradient.  ``update_on_kvstore=True`` moves the update into the store
(``kvstore="dist_async"`` requires it: its parameter server applies the
updates, and ``step`` ships a changed lr, rescale_grad or wd to it);
``compression_params`` sets the store's 2-bit compression.

``save_states``/``load_states`` write and read the reference's pickle of
numpy states, so the files interchange with it both ways (states over a
mesh are gathered whole, and loaded into each rank's pieces).  The
preemption handlers are here (``install_preemption_handler``,
``drain_requested``, ``request_drain``, ``reset_drain``), with
``drain_consensus``, the ranks' agreement to drain: a host-vector sum
over the group.  ``offload="host"`` raises (Queue 1, "Left out of slice
2").
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
from ..parallel.local import copy_global_into, local
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
    """True iff ANY rank has ``drain_requested()``, agreed by every rank.

    A preemption signals one host, not the whole group; a rank leaving
    the step loop alone would strand its peers in the next gradient
    all-reduce.  Polled after each step instead, the flag rides a
    host-vector sum over the group (``parallel.process_sum_hostvec``, a
    synchronization point), so every rank learns of the drain at the same
    step boundary and the drain checkpoint is consistent.  Collective:
    every rank calls it.  One process: ``drain_requested()``."""
    import numpy as np

    from .. import parallel

    local_flag = _DRAIN.is_set()
    if not parallel.is_initialized():
        return local_flag
    return bool(parallel.process_sum_hostvec(
        np.array([1.0 if local_flag else 0.0]))[0] > 0)


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
        self._mesh = None
        self._placement = None
        if partition_rules is not None or mesh is not None:
            self._place(partition_rules, mesh)
        self._compression_params = compression_params
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        self._kvstore_type = kvstore
        self._update_on_kvstore_arg = update_on_kvstore
        self._update_on_kvstore = False
        self._kvstore = None
        self._kv_initialized = False
        self._data_prefetcher = None
        self._data_depths = []

    def _place(self, partition_rules, mesh):
        """Place every initialized parameter over the mesh by the rule
        table (``mesh=`` alone: all replicated, pure data parallelism);
        the mesh becomes the current one when none is."""
        from .. import parallel

        if isinstance(mesh, dict):
            mesh = parallel.make_mesh(mesh)
        mesh = mesh if mesh is not None else parallel.current_mesh()
        if mesh is None:
            raise MXNetError(
                "Trainer(partition_rules=...) needs a device mesh: pass "
                "mesh= or activate one (mx.gpu(mesh=...) / "
                "parallel.set_mesh)")
        if parallel.current_mesh() is None:
            parallel.set_mesh(mesh)
        self._mesh = mesh
        rules = parallel.as_rules(partition_rules) \
            if partition_rules is not None else \
            parallel.PartitionRules(((r".*", ()),))
        self._placement = parallel.place_params(self._params, rules,
                                                mesh=mesh)

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
        update_on_kvstore = self._update_on_kvstore_arg
        if self._kvstore_type is None:
            self._kvstore = None
            update_on_kvstore = False
        else:
            kv = kvs.create(self._kvstore_type) \
                if isinstance(self._kvstore_type, str) else self._kvstore_type
            self._kvstore = kv
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            if getattr(kv, "type", "") == "dist_async":
                # the parameter server applies each update as it arrives;
                # an update here would race stale pulls (reference
                # kvstore_dist.h has the same requirement)
                if update_on_kvstore is False:
                    raise MXNetError(
                        "dist_async requires update_on_kvstore=True")
                update_on_kvstore = True
            update_on_kvstore = bool(update_on_kvstore)
            if update_on_kvstore:
                for i, param in enumerate(self._params):
                    if param.grad_req != "null":
                        kv.init(i, param.data())
                kv.set_optimizer(self._optimizer)
                self._shipped_hparams = self._hparams_sig()
        self._update_on_kvstore = update_on_kvstore
        self._kv_initialized = True

    def _hparams_sig(self):
        lr = None if self._optimizer.lr_scheduler is not None \
            else self._optimizer.lr
        return (lr, self._optimizer.rescale_grad, self._optimizer.wd)

    def _sync_kvstore_hparams(self):
        """A parameter server holds a pickled copy of the optimizer: ship
        lr, rescale_grad and wd again whenever they changed here
        (``set_learning_rate``, another batch size).  An lr schedule
        advances on the server, with its own update count."""
        ship = getattr(self._kvstore, "set_optimizer_hparams", None)
        if ship is None:
            return
        sig = self._hparams_sig()
        if sig != getattr(self, "_shipped_hparams", None):
            ship(lr=sig[0], rescale_grad=sig[1], wd=sig[2])
            self._shipped_hparams = sig

    # -- public properties ---------------------------------------------------
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def placement(self):
        """The partition rules' ``Coverage`` report from construction
        (None without ``partition_rules``/``mesh``)."""
        return self._placement

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def attach_data_prefetcher(self, prefetcher):
        """Tie a ``data.DevicePrefetcher`` (or a ``data.StreamingLoader``
        over one) to this trainer: each ``step()`` samples its queue depth
        right after the update is dispatched, when the next batch's copy
        should already be in flight.  A fed pipeline holds the depth near
        its configured value; a starving one sits at 0 (``stats()``)."""
        self._data_prefetcher = getattr(prefetcher, "prefetcher",
                                        prefetcher)
        self._data_depths = []

    def stats(self):
        """Host-side numbers of this trainer: the attached prefetcher's
        depth samples (one a step) and their mean."""
        depths = self._data_depths
        return {"data_prefetch_depth_samples": len(depths),
                "data_prefetch_depth_mean":
                    sum(depths) / len(depths) if depths else 0.0}

    # -- the step ------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Aggregate gradients and apply one optimizer update, scaling
        gradients by 1/batch_size (reference ``Trainer.step``)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._sync_kvstore_hparams()
        self._allreduce_grads()
        self._update(ignore_stale_grad)
        if self._data_prefetcher is not None:
            self._data_depths.append(self._data_prefetcher.depth())

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError(
                "allreduce_grads() is not supported when update_on_kvstore "
                "is True (the store owns the update)")
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is not None and not self._update_on_kvstore:
            self._kvstore.allreduce_grads(self._params)

    def _reduce_partial_grads(self):
        """Gradients still ``Partial`` over a mesh (no store, a local
        store, or ``update_on_kvstore``) are summed here, and laid out as
        their weights: the optimizer never sees a partial sum.  Runs once
        an update, before it."""
        from ..parallel.local import is_dtensor

        for param in self._params:
            if param.grad_req == "null" or param._data is None:
                continue
            g = param._data._grad
            if isinstance(g, NDArray) and is_dtensor(g._data):
                from ..parallel import reduce_partial

                w = param._data._data
                g._data = reduce_partial(g._data)
                if g._data.placements != w.placements:
                    g._data = g._data.redistribute(w.device_mesh,
                                                   w.placements)

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError(
                "update() is not supported when update_on_kvstore is True")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        self._reduce_partial_grads()
        if self._update_on_kvstore:
            # every push before the first pull: a pull waits for the
            # store's queue, and the pushes queued together are updated
            # together (the parameter server's batch)
            live = [(i, p) for i, p in enumerate(self._params)
                    if p.grad_req != "null" and p._data is not None]
            for i, param in live:
                self._kvstore.push(i, param.grad())
            for i, param in live:
                self._kvstore.pull(i, param.data())
            return
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
            states.append(tuple(local(t) for t in opt._flatten_state(state)))
        # the kernel writes through data_ptr: each rank's local pieces
        w_raws = [local(self._params[i].data()._data) for i in live]
        g_raws = [local(self._params[i].grad()._data).contiguous()
                  for i in live]
        m_raws = [local(m) for m in m_raws]
        return mp_flags, w_raws, m_raws, g_raws, states

    def _try_fused_update(self):
        """Every live parameter in one launch of the multi-tensor kernel
        (reference ``Trainer._try_fused_update``).  False when the
        NaiveEngine is chosen or the optimizer has no rule of the
        kernel (or overrides the rule's ``_step``), or a gradient is
        sparse: the caller then updates parameter by parameter (a
        row-sparse gradient takes the optimizer's lazy row update)."""
        from ..ndarray import sparse as sp

        optzr = self._optimizer
        if engine.is_naive() or optzr._kernel_rule() is None:
            return False
        live = self._live()
        if not live:
            return True
        if any(isinstance(self._params[i].grad(), sp.BaseSparseNDArray)
               for i in live):
            return False
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
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        payload = self._states_payload()
        with open(fname, "wb") as f:
            pickle.dump(payload, f)

    def _states_payload(self):
        """``save_states``' payload (states over a mesh gathered whole:
        collective, every rank calls it)."""
        for i, param in enumerate(self._params):
            if param.grad_req != "null" and param._data is not None:
                self._init_states(i)
        return {
            "states": {i: opt._states_to_numpy(s)
                       for i, s in enumerate(self._states)},
            "num_update": self._optimizer.num_update,
            "index_update_count": dict(
                self._optimizer._index_update_count),
        }

    def load_states(self, fname):
        """Load ``save_states``' file (or the reference's): each state is
        copied into the parameter's own state tensors (created first if
        the trainer has not stepped yet), in their dtype and on their
        device, so a captured ``FusedTrainStep`` keeps its addresses."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
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
        copy_global_into(holder._data, src)
        return
    if not isinstance(holder, tuple) or not isinstance(value, tuple) or \
            len(holder) != len(value):
        raise MXNetError(f"load_states: the state of {name} does not match "
                         "this optimizer's")
    for h, v in zip(holder, value):
        _copy_state(h, v, name)


from .. import _left_out as _lo  # noqa: E402

__getattr__ = _lo.refuse(dict.fromkeys(("telemetry",), _lo._9),
                         "mxnet_tpu_torch.gluon.trainer")

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
over the group.

``offload="host"`` keeps the optimizer states and multi-precision
masters in pinned host memory between steps (``memory.offload``).  The
update fetches them, updates and stashes them back in groups of the
device table, one launch of the fused update kernel a group.  A group
holds at most as much state as the largest parameter has, so the one
staging buffer on the card that every group is fetched into is the
size that parameter needs anyway, and the update holds the weights, the
gradients and one group's state.  The rule is elementwise, so each
weight's result equals one launch over the whole table.  Each group is
fetched right before its launch, after the gradient reduction: the
current stream waits for the copy, so an earlier fetch would delay the
reduction rather than overlap it.  A ``FusedTrainStep`` over an offloading
trainer runs as the reference's does: its program takes the states
where they are, so they come to the card at its first call and stay
there (released from the host books) until an eager ``step`` stashes
them again.
"""
from __future__ import annotations

import pickle
import signal
import threading
import time

import torch

from ..base import MXNetError
from .. import engine
from .. import telemetry
from ..telemetry import costs as _costs
from ..telemetry import memwatch as _mw
from ..telemetry import numerics as _numerics
from ..telemetry import retrace as _retrace
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

#: alignment of each tensor in the offload staging buffer
_STAGE_ALIGN = 256


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


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, partition_rules=None, mesh=None,
                 offload=None):
        if offload not in (None, "host"):
            raise MXNetError(
                f'offload must be None or "host", got {offload!r}')
        if offload is not None and (partition_rules is not None or
                                    mesh is not None):
            raise MXNetError(
                'Trainer(offload="host") over a mesh is not ported yet '
                '(ROADMAP.md, "Left out of slice 21")')
        self._offload = offload
        self._offload_stage = None
        self._offload_fetched = []
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
        self._fused_sigs = set()  # the fused update's signatures seen
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
            if self._offload == "host":
                from ..memory import offload as _mem_offload

                for arr in self._offloaded_ndarrays(i):
                    _mem_offload.stash(arr)

    # -- host offload (memory.offload) ---------------------------------------
    def _offloaded_ndarrays(self, i):
        """The host-resident NDArrays of param i's optimizer state: the
        f32 master (multi-precision) plus every flattened state tensor."""
        st = self._states[i]
        if st is None:
            return []
        use_mp = self._optimizer.multi_precision and \
            self._params[i].dtype in opt._LOW
        if use_mp and isinstance(st, tuple) and len(st) == 2:
            master, sub = st
            return [master, *opt._state_holders(sub)]
        return list(opt._state_holders(st))

    def _offload_groups(self, live):
        """``live`` cut into consecutive groups, each holding at most the
        offloaded state of the largest live parameter."""
        sizes = [sum(_stage_bytes(a) for a in self._offloaded_ndarrays(i))
                 for i in live]
        cap = max(sizes, default=0)
        groups, cur, cur_b = [], [], 0
        for i, n in zip(live, sizes):
            if cur and cur_b + n > cap:
                groups.append(cur)
                cur, cur_b = [], 0
            cur.append(i)
            cur_b += n
        if cur:
            groups.append(cur)
        return groups

    def _stage(self, groups, device):
        """The staging buffer on ``device``: as large as the largest
        group's state, made once (and again when a group outgrows it)."""
        need = max(sum(_stage_bytes(a) for i in g
                       for a in self._offloaded_ndarrays(i))
                   for g in groups)
        stage = self._offload_stage
        if stage is None or stage.device != device or stage.numel() < need:
            self._offload_stage = stage = None  # the old one goes first
            stage = torch.empty(need, dtype=torch.uint8, device=device)
            self._offload_stage = stage
        return stage

    def _fetch_group(self, group, stage):
        """Fetch a group's stashed state into the staging buffer and bind
        each NDArray to its device copy (booked off the host)."""
        from ..memory import offload as _mem_offload

        off = 0
        for i in group:
            for arr in self._offloaded_ndarrays(i):
                n = _stage_bytes(arr)
                if _mem_offload.is_stashed(arr):
                    raw = arr._data
                    view = stage[off:off + raw.numel() * raw.element_size()]
                    dev = _mem_offload.fetch(
                        arr, stage.device,
                        out=view.view(raw.dtype).view(raw.shape))
                    _mem_offload.release(arr)
                    arr._data = dev
                    self._offload_fetched.append(arr)
                off += n

    def _fetch_param(self, i):
        """Fetch param i's stashed state into new device tensors (the
        eager route)."""
        from ..memory import offload as _mem_offload

        device = local(self._params[i].data()._data).device
        for arr in self._offloaded_ndarrays(i):
            if _mem_offload.is_stashed(arr):
                dev = _mem_offload.fetch(arr, device)
                _mem_offload.release(arr)
                arr._data = dev
                self._offload_fetched.append(arr)

    def _stash_offloaded(self, live):
        """Move the freshly updated state back to host (D2H, async on the
        card)."""
        from ..memory import offload as _mem_offload

        for i in live:
            for arr in self._offloaded_ndarrays(i):
                if not _mem_offload.is_stashed(arr):
                    _mem_offload.stash(arr)
        held = {id(a) for i in live for a in self._offloaded_ndarrays(i)}
        self._offload_fetched = [a for a in self._offload_fetched
                                 if id(a) not in held]

    def _stash_pending(self):
        """Stash whatever a failed update left fetched."""
        from ..memory import offload as _mem_offload

        pending, self._offload_fetched = self._offload_fetched, []
        for arr in pending:
            if not _mem_offload.is_stashed(arr):
                _mem_offload.stash(arr)

    def _offloaded_fused_update(self, live, lrs, wds, ts):
        """The fused update over offloaded state: per group, fetch into
        the staging buffer, one launch over the group's slice of the
        table, stash back."""
        pos = {i: k for k, i in enumerate(live)}
        groups = self._offload_groups(live)
        device = local(self._params[live[0]].data()._data).device
        stage = self._stage(groups, device)
        for group in groups:
            self._fetch_group(group, stage)
            ks = [pos[i] for i in group]
            opt._fused_param_updates(
                self._optimizer, *self._fused_operands(group),
                [lrs[k] for k in ks], [wds[k] for k in ks],
                [ts[k] for k in ks])
            self._stash_offloaded(group)

    def _bring_offloaded_to_device(self, live):
        """``FusedTrainStep`` over an offloading trainer: the states come
        to the weights' device and stay there (the reference's fused
        program takes them where they are and returns them on the
        device)."""
        for i in live:
            self._fetch_param(i)
        self._offload_fetched = []

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
        with telemetry.span("trainer.step"):
            self._optimizer.rescale_grad = self._scale / batch_size
            if not self._kv_initialized:
                self._init_kvstore()
            if self._update_on_kvstore:
                self._sync_kvstore_hparams()
            try:
                self._allreduce_grads()
                self._update(ignore_stale_grad)
            finally:
                if self._offload_fetched:
                    self._stash_pending()
            if self._data_prefetcher is not None:
                depth = self._data_prefetcher.depth()
                self._data_depths.append(depth)
                telemetry.gauge("data.prefetch_depth", depth)

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError(
                "allreduce_grads() is not supported when update_on_kvstore "
                "is True (the store owns the update)")
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None or self._update_on_kvstore:
            return
        if not telemetry.is_enabled():
            self._kvstore.allreduce_grads(self._params)
            return
        t0 = time.perf_counter()
        try:
            with telemetry.span("trainer.allreduce"):
                if type(self._kvstore) is kvs.KVStore:
                    # the push/pull path; a store with its own reducer
                    # counts the same payload as kvstore.allreduce_bytes
                    telemetry.count("trainer.allreduce_bytes", sum(
                        telemetry.nbytes_of(p._data.grad)
                        for p in self._params
                        if p.grad_req != "null" and p._data is not None))
                self._kvstore.allreduce_grads(self._params)
        finally:
            telemetry.count("trainer.allreduce_wait_ms",
                            (time.perf_counter() - t0) * 1e3)

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
        with telemetry.span("trainer.update"):
            self._update_impl()

    def _update_impl(self):
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
        live = self._live()

        def update_each():
            for i in live:
                self._init_states(i)
                if self._offload == "host":
                    self._fetch_param(i)
                self._optimizer.update_multi_precision(
                    i, self._params[i].data(), self._params[i].grad(),
                    self._states[i])
                if self._offload == "host":
                    self._stash_offloaded([i])

        from ..ndarray import sparse as sp

        if engine.is_naive() or any(
                isinstance(self._params[i].grad(), sp.BaseSparseNDArray)
                for i in live):
            update_each()  # the reference's eager routes take no stats
            return
        self._with_update_stats(
            live, [local(self._params[i].data()._data) for i in live],
            [local(self._params[i].grad()._data) for i in live],
            update_each)

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
        operands = self._fused_operands(live)
        mp_flags, w_raws, _, g_raws, states = operands
        sig = (type(optzr).__name__, tuple(mp_flags),
               tuple((tuple(w.shape), str(w.dtype).replace("torch.", ""))
                     for w in w_raws),
               tuple(len(st) for st in states), _numerics.signature())
        compiling = sig not in self._fused_sigs
        site = "mxnet_tpu_torch.gluon.trainer:Trainer._try_fused_update"
        if compiling:
            self._fused_sigs.add(sig)
            telemetry.count("trainer.fused_cache_miss")
            if _retrace._enabled:
                _retrace.observe(
                    "trainer_fused", id(self),
                    {"optimizer": sig[0], "mp_flags": sig[1],
                     "weights": sig[2], "state_widths": sig[3],
                     "mesh": None, "numerics": sig[4]}, site=site)

        def update():
            with telemetry.span("trainer.fused_compile" if compiling
                                else "trainer.fused_update"), \
                    _costs.first("trainer_fused", (id(self), sig)) as c:
                if self._offload == "host":
                    self._offloaded_fused_update(live, lrs, wds, ts)
                else:
                    opt._fused_param_updates(optzr, *operands, lrs, wds, ts)
            if _costs._enabled:
                _costs.note("trainer_fused", (id(self), sig), c, site=site)

        self._with_update_stats(live, w_raws, g_raws, update)
        return True

    def _with_update_stats(self, live, w_raws, g_raws, update):
        """Run ``update()`` (which updates ``w_raws`` in place); on a step
        whose numerics will be harvested, queue each parameter's
        ``grad.`` and ``update.`` statistics, the latter from a copy of
        the weights taken first.  An allocation failure becomes
        memwatch's post-mortem."""
        stats = _numerics.harvesting()
        old = [w.detach().clone() for w in w_raws] if stats else None
        try:
            update()
        except Exception as exc:
            if _mw._enabled:
                _mw.annotate_oom(exc, context="Trainer fused update")
            raise
        if stats:
            names, rows = [], []
            for i, g, nw, ow in zip(live, g_raws, w_raws, old):
                pname = self._params[i].name
                names += ["grad." + pname, "update." + pname]
                rows += [_numerics.stats_of(g),
                         _numerics.stats_of(nw.detach() - ow)]
            del old
            _numerics.record_compiled(names, torch.stack(rows))

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
        if self._offload == "host":
            from ..memory import offload as _mem_offload

            _mem_offload.synchronize()  # the stashed copies have landed
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
        if self._offload == "host":
            from ..memory import offload as _mem_offload

            _mem_offload.synchronize()  # no copy still reads a buffer
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


def _stage_bytes(arr):
    """Bytes an NDArray takes in the offload staging buffer (aligned)."""
    n = arr._data.numel() * arr._data.element_size()
    return -(-n // _STAGE_ALIGN) * _STAGE_ALIGN


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


"""K optimizer steps a call: ``FusedTrainStep``.

Counterpart of ``mxnet_tpu/gluon/step_fusion.py`` (``FusedTrainStep``,
Keras' ``steps_per_execution``), which compiles K whole steps (forward,
loss, backward, update) into one XLA program.  Here, on a CUDA card, one
step is captured into a CUDA graph (``cuda_graph.py``): the forward, the
loss, the backward (the flash-attention kernels included) and the fused
multi-tensor update kernel, after a warm-up step on a side stream; a call
replays it K times, one host call a step.  On the CPU the K steps run
eagerly, unrolled, through the same update (the kernel's plain version).
The route is chosen by the parameters' device.

Semantics, as the reference's:

- gradients are d(sum of every loss element)/dw, rescaled by
  ``scale / batch_size`` like ``Trainer.step``; each step's summed loss
  comes back in the (K,) result;
- lr and wd are read once a call (an lr schedule advances a call at a
  time); the update count t advances every step (Adam's bias correction
  stays exact): the update reads lr, wd and t from a device table the
  host rewrites before each replay (the kernel's table, or, for a
  per-tensor rule, a (3, n) f32 table whose entries ``_step`` takes as
  0-d tensors), so the graph is never captured again for a new lr or t.
  For f16/bf16 weights without f32 masters a per-tensor rule's replay
  meets lr and wd in the weight's dtype (torch casts a 0-d operand to
  the other operand's dtype) where the eager rule keeps them f32: a
  relative difference of up to 2^-9 (bf16) in lr and wd;
- BatchNorm's moving statistics (the ``grad_req="null"`` parameters) are
  updated in place by each step;
- ``stacked_inputs=True``: every batch array leads with K and step k reads
  slice k (copied into the graph's static inputs before replay k);
  otherwise every step of a call reads that call's batch (copied into
  the static inputs before the call's first replay);
- the first call of a signature snapshots the parameters, optimizer
  states and update counts, and restores them if it fails; then the
  error is raised.  No route falls back to another.

A recorded graph that is still referenced when a step is captured (the
loss NDArray of an earlier eager step) keeps the parameters' gradient
accumulators alive, and torch ties each to the stream it was made on:
the capture then fails with a stream-capture error.  Drop such
references before the first call.

A graph is keyed on the batch's shapes and dtypes, the optimizer's
hyperparameters, amp's dtype, the numerics mode (``telemetry.numerics``:
each mode keeps one graph), and the addresses of the weights, masters,
states and moving statistics (each rank's local pieces under a mesh):
after ``cast`` or ``load_states`` into new tensors the next call
captures again.

Over a ``Trainer(offload="host")`` the step does what the reference's
does: its program takes the optimizer states where they are and returns
them on the device, so the first call fetches them to the card, where
they stay (released from ``memory.offload``'s books) until an eager
``Trainer.step`` stashes them again.  A block hybridized with
``remat=`` runs its checkpointed forward inside the capture (the
recompute is part of the captured backward); the random draws of the
region are saved, not replayed (``memory.policy``).

Telemetry, under the reference's names: ``step_fusion.cache_miss`` (a
new signature, or moved addresses) with a ``retrace.observe``, the
``step_fusion.build``/``compile``/``replay`` spans, ``step_fusion.compile``
once a signature's first call has run, ``step_fusion.steps`` (K a call)
and the ``step_fusion.steps_per_execution`` gauge, and a ``costs.note``
whose work is counted in step 0 of the signature's first call (eager,
before the capture) and scaled by K, stamped with the last remat tier
the memory policy chose (``_mem_policy_tier``).  With numerics on, each
step also takes the forward's taps and every live parameter's ``grad.<name>`` and
``update.<name>`` (new weight − old weight, from a copy of the weights
taken before the in-place update) statistics, and folds them over the K
steps as the reference's ``_reduce_k`` does (nan and inf summed, l2 and
mean of the last step, maxabs the worst): inside the graph, into a
device accumulator that one copy queues after the call's last step.
The reference's fused program drops the forward's taps (its trace has
no collector there); the port keeps them, so ``first_nan`` names the
layer inside a fused step too.  ``update_on_kvstore`` is refused, as in the reference.

Over a mesh or a ``dist_*`` store (the reference's jitted step over a
mesh), each step also runs the store's ``allreduce_grads`` and sums what
is still ``Partial``, as ``Trainer.step`` does, so the collectives are
inside the graph (``DTensor`` redistributions included); every NCCL
group is warmed by an eager collective first (``cuda_graph.
warm_groups``), and step 0, the warm-up, runs them eagerly too.  gloo
collectives cannot be captured: on the CPU the K steps run eagerly, as
every CPU call does.  A capture that fails raises; nothing runs eagerly
in its place on the card.
"""
from __future__ import annotations

import torch

from .. import amp
from .. import autograd as ag
from .. import cuda_graph
from .. import optimizer as opt
from .. import random as mx_random
from .. import telemetry
from ..base import MXNetError
from ..ndarray import NDArray
from ..ops import multi_tensor
from ..parallel import reduce_partial
from ..parallel.local import is_dtensor, local
from ..telemetry import costs as _costs
from ..telemetry import memwatch as _mw
from ..telemetry import numerics as _numerics
from ..telemetry import retrace as _retrace
from .block import _quiet

__all__ = ["FusedTrainStep"]


def _leaves(loss):
    """The NDArrays of a loss (an NDArray, or nested lists, tuples and
    dicts of them)."""
    if isinstance(loss, NDArray):
        return [loss]
    if isinstance(loss, dict):
        loss = list(loss.values())
    if isinstance(loss, (list, tuple)):
        return [leaf for item in loss for leaf in _leaves(item)]
    raise MXNetError("forward_loss must return NDArrays (or nested lists, "
                     f"tuples or dicts of them), got {type(loss)}")


def _mem_policy_tier():
    """The last-selected remat tier, or None — probed via sys.modules so
    the memory package stays unimported unless the user opted in."""
    import sys

    mem = sys.modules.get("mxnet_tpu_torch.memory")
    if mem is None:
        return None
    pol = mem.policy.last_policy()
    return pol["tier"] if pol is not None else None


class FusedTrainStep:
    """``steps_per_execution`` trainer steps a call (reference
    ``gluon.FusedTrainStep``).

    ``forward_loss(net, *batch)`` runs the model and returns the loss;
    calling the instance with the batch NDArrays runs K steps and returns
    an NDArray (K,) of each step's summed loss, with the parameters,
    optimizer states and moving statistics updated in place."""

    def __init__(self, net, trainer, forward_loss, steps_per_execution=8,
                 batch_size=1, stacked_inputs=False):
        if steps_per_execution < 1:
            raise MXNetError("steps_per_execution must be >= 1")
        self.net = net
        self.trainer = trainer
        self.forward_loss = forward_loss
        self.k = int(steps_per_execution)
        self.batch_size = int(batch_size)
        self.stacked_inputs = bool(stacked_inputs)
        self._graphs = {}
        self._validated = set()
        self._seen = set()
        self._pool = None
        if not trainer._kv_initialized:
            trainer._init_kvstore()
        if trainer._update_on_kvstore:
            raise MXNetError(
                "FusedTrainStep cannot fuse update_on_kvstore modes (the "
                "store owns the update); use per-step Trainer.step")
        kv = trainer._kvstore
        # the collectives of Trainer.step run inside each step
        self._collective = trainer._mesh is not None or (
            kv is not None and (str(kv.type).startswith("dist") or
                                kv.num_workers > 1))
        self._live, self._aux = [], []
        for i, param in enumerate(trainer._params):
            if param._data is None:
                raise MXNetError(
                    f"parameter {param.name} has an unresolved deferred "
                    "shape or was not initialized: run one forward first")
            if param.grad_req == "null":
                self._aux.append(param)
                continue
            if param._grad_stype != "default":
                raise MXNetError(
                    f"parameter {param.name} has sparse grad "
                    f"({param._grad_stype}); not fusable")
            self._live.append(i)

    # -- one step ------------------------------------------------------------
    def _loss_and_grads(self, inputs):
        """Forward, summed f32 loss and backward of one step → the loss
        (a 0-d f32 tensor)."""
        with _quiet(), ag.record():
            leaves = _leaves(self.forward_loss(self.net, *inputs))
        total = sum(leaf._data.detach().float().sum() for leaf in leaves)
        ag.backward(leaves)
        if self._collective:
            self.trainer._allreduce_grads()
            self.trainer._reduce_partial_grads()
        if is_dtensor(total):  # each rank's copy of the summed loss
            total = reduce_partial(total).to_local()
        return total

    def _items(self, mp_flags, lrs, wds, t):
        """The fused update's operands for update counts ``t`` (a list,
        one per live parameter)."""
        _, w_raws, m_raws, g_raws, states = \
            self.trainer._fused_operands(self._live)
        return opt._update_items(mp_flags, w_raws, m_raws, g_raws, states,
                                 lrs, wds, t)

    @staticmethod
    def _update(optzr, items):
        """One eager update: the kernel's launch (its plain version on
        the CPU) for an optimizer with a rule code, else the optimizer's
        per-tensor rule."""
        if optzr._kernel_rule() is None:
            multi_tensor._update_plain(optzr, items)
        else:
            multi_tensor.multi_tensor_update(optzr, items)

    def _stat_step(self, stats, run):
        """One step ``run()`` → (loss, items); with ``stats`` inside a
        numerics scope that takes the forward's taps and, around the
        in-place update, each live parameter's ``grad.`` and ``update.``
        statistics → (loss, items, names, (n, 5) bundles)."""
        if not stats:
            loss, items = run(None)
            return loss, items, (), None
        with _numerics.collecting() as col:
            loss, items = run(col)
        names, rows = col.drain()
        return loss, items, names, rows

    def _update_with_stats(self, col, optzr, items, update):
        """``update()`` of ``items``; with a numerics scope ``col``, the
        weights copied first and the ``grad.``/``update.`` bundles
        appended to it after."""
        if col is None:
            update()
            return
        old = [it.w.detach().clone() for it in items]
        update()
        for i, it, ow in zip(self._live, items, old):
            pname = self.trainer._params[i].name
            col.names += ["grad." + pname, "update." + pname]
            col.stats += [_numerics.stats_of(it.g),
                          _numerics.stats_of(it.w.detach() - ow)]

    # -- dispatch ------------------------------------------------------------
    def __call__(self, *batch):
        trainer = self.trainer
        optzr = trainer._optimizer
        optzr.rescale_grad = trainer._scale / self.batch_size
        for i in self._live:
            trainer._init_states(i)
        if getattr(trainer, "_offload", None) == "host":
            trainer._bring_offloaded_to_device(self._live)
        if self.stacked_inputs:
            for b in batch:
                if b.ndim < 1 or b.shape[0] != self.k:
                    raise MXNetError(
                        "stacked_inputs=True requires every batch array to "
                        f"lead with K={self.k}, got shape {b.shape}")
        lrs = [float(optzr._get_lr(i)) for i in self._live]
        wds = [float(optzr._get_wd(i)) for i in self._live]
        # t of the first step, without touching the optimizer's counts: a
        # failed first call leaves them as they were
        t0 = [optzr._index_update_count.get(i, optzr.begin_num_update) + 1
              for i in self._live]
        mp_flags = tuple(optzr.multi_precision and
                         trainer._params[i].dtype in opt._LOW
                         for i in self._live)
        device = trainer._params[self._live[0]]._data._data.device \
            if self._live else torch.device("cpu")
        sig = (type(optzr).__name__, _hyper(optzr), mp_flags,
               tuple((b.shape, b.dtype, b._data.device) for b in batch),
               amp.target_dtype(), _numerics.signature())
        if sig not in self._seen:
            with telemetry.span("step_fusion.build"):
                self._miss(sig, batch, None)
            self._seen.add(sig)
        first = sig not in self._validated
        snapshot = self._snapshot() if first else None
        telemetry.gauge("step_fusion.steps_per_execution", self.k)
        telemetry.count("step_fusion.steps", self.k)
        key = (id(self), sig)
        try:
            with telemetry.span("step_fusion.compile" if first
                                else "step_fusion.replay"):
                if device.type == "cuda":
                    losses = self._run_graph(sig, batch, mp_flags, lrs, wds,
                                             t0, device, key)
                else:
                    losses = self._run_unrolled(batch, mp_flags, lrs, wds,
                                                t0, key)
                if snapshot is not None and device.type == "cuda":
                    torch.cuda.synchronize(device)  # a fault surfaces here
        except BaseException as exc:
            if snapshot is not None:
                self._restore(snapshot)
            if _mw._enabled and isinstance(exc, Exception):
                _mw.annotate_oom(exc, context="FusedTrainStep dispatch")
            raise
        if first:
            telemetry.count("step_fusion.compile")
        self._validated.add(sig)
        for i in self._live:
            optzr._index_update_count[i] = optzr._index_update_count.get(
                i, optzr.begin_num_update) + self.k
            optzr.num_update = max(optzr.num_update,
                                   optzr._index_update_count[i])
        return NDArray(losses)

    def _inputs(self, batch, k):
        return [b[k] for b in batch] if self.stacked_inputs else list(batch)

    def _miss(self, sig, batch, ptrs):
        """A new signature (or moved addresses): the counter and the
        sanitizer's observation."""
        telemetry.count("step_fusion.cache_miss")
        if not _retrace._enabled:
            return
        comps = {"optimizer": sig[0],
                 "rescale_grad": float(self.trainer._optimizer.rescale_grad),
                 "hyper": sig[1], "mp_flags": sig[2],
                 "batch": tuple((tuple(b.shape),
                                 str(b.dtype).replace("torch.", ""))
                                for b in batch),
                 "amp": str(sig[4]), "numerics": sig[5]}
        if ptrs is not None:
            comps["param_addresses"] = tuple(f"{p:#x}" for p, _ in ptrs)
        _retrace.observe("step_fusion", id(self), comps,
                         site="mxnet_tpu_torch.gluon.step_fusion:"
                              "FusedTrainStep.__call__")

    def _note_cost(self, key, counted):
        if _costs._enabled and key is not None:
            _costs.note("step_fusion", key, counted, scale=self.k,
                        site="mxnet_tpu_torch.gluon.step_fusion:"
                             "FusedTrainStep.__call__",
                        remat=_mem_policy_tier())

    def _run_unrolled(self, batch, mp_flags, lrs, wds, t0, key):
        """The K steps eagerly, one after another (CPU parameters); the
        numerics bundles folded over them."""
        optzr = self.trainer._optimizer
        stats = _numerics.signature()
        losses, acc, names = [], None, ()
        for k in range(self.k):
            inputs = self._inputs(batch, k)

            def run(col, k=k, inputs=inputs):
                loss = self._loss_and_grads(inputs)
                items = self._items(mp_flags, lrs, wds, [t + k for t in t0])
                self._update_with_stats(col, optzr, items,
                                        lambda: self._update(optzr, items))
                return loss, items

            with _costs.first("step_fusion", key) if k == 0 \
                    else _costs._NULL as c:
                loss, _, names, rows = self._stat_step(stats, run)
            if k == 0:
                self._note_cost(key, c)
            losses.append(loss)
            if rows is not None:
                acc = rows.clone() if acc is None else \
                    _numerics.fold(acc, rows)
        if names:
            _numerics.record_compiled(names, acc)
        return torch.stack(losses)

    def _addresses(self):
        """(data_ptr, dtype) of everything a graph reads or writes in
        place: the weights, the optimizer states and masters, the moving
        statistics (a freed tensor's address can come back with another
        dtype)."""
        trainer = self.trainer
        tensors = [trainer._params[i]._data._data for i in self._live]
        for i in self._live:
            tensors += [h._data for h in
                        opt._state_holders(trainer._states[i])]
        tensors += [p._data._data for p in self._aux]
        return tuple((local(t).data_ptr(), t.dtype) for t in tensors)

    def _run_graph(self, sig, batch, mp_flags, lrs, wds, t0, device,
                   key=None):
        """Replay this signature's step graph K times, capturing it first
        (after one eager warm-up step, which is step 0) when there is
        none or the addresses it baked in have moved."""
        optzr = self.trainer._optimizer
        losses = torch.empty(self.k, dtype=torch.float32, device=device)
        entry = self._graphs.get(sig)
        start = 0
        ptrs = self._addresses()
        if entry is None or entry["ptrs"] != ptrs:
            if entry is not None:  # moved addresses: a miss of its own
                with telemetry.span("step_fusion.build"):
                    self._miss(sig, batch, ptrs)
            entry = self._capture(batch, mp_flags, lrs, wds, t0, losses,
                                  key, sig[5])
            self._graphs[sig] = entry
            start = 1
        else:
            self._note_cost(key, None)  # a replayed call: a registry hit
            if entry.get("acc") is not None:
                entry["acc"].zero_()
        plan, graph = entry["plan"], entry["graph"]
        if start == 0 and not self.stacked_inputs:
            # this call's batch into the graph's static inputs (a capture
            # made its statics from the batch it ran on)
            for s, b in zip(entry["inputs"], batch):
                local(s).copy_(local(b._data))
        for k in range(start, self.k):
            if self.stacked_inputs:
                for s, b in zip(entry["inputs"], batch):
                    local(s).copy_(local(b._data)[k])
            t = [t + k for t in t0]
            if plan is None:
                _write_scalars(entry["scalars"], lrs, wds, t)
            else:
                plan.write(self._static_items(entry, lrs, wds, t), optzr)
            graph.replay()
            losses[k].copy_(graph.outputs[0])
        if entry.get("acc") is not None:
            # one copy of the folded bundles: the next call overwrites them
            _numerics.record_compiled(entry["names"], entry["acc"].clone())
        return losses

    def _static_items(self, entry, lrs, wds, t):
        return [it._replace(lr=lr, wd=wd, t=tk)
                for it, lr, wd, tk in zip(entry["items"], lrs, wds, t)]

    def _capture(self, batch, mp_flags, lrs, wds, t0, losses, key, stats):
        """Step 0 eagerly on a side stream (the warm-up, where the cost
        registry counts a step), then the capture of one step on static
        copies of the inputs.  With numerics on, the warm-up's bundles
        start the device accumulator the captured step folds into."""
        optzr = self.trainer._optimizer
        inputs = self._inputs(batch, 0)

        def eager_step(col):
            loss = self._loss_and_grads(inputs)
            items = self._items(mp_flags, lrs, wds, t0)
            self._update_with_stats(col, optzr, items,
                                    lambda: self._update(optzr, items))
            return loss, items

        with _costs.first("step_fusion", key) as c:
            loss0, _, names, rows0 = cuda_graph.warmup(
                lambda: self._stat_step(stats, eager_step))
        self._note_cost(key, c)
        losses[0].copy_(loss0)
        acc = rows0.clone() if rows0 is not None else None
        statics = [x._data.clone() for x in inputs]
        if optzr._kernel_rule() is None:
            plan = None
            scalars = torch.zeros((3, len(self._live)), dtype=torch.float32,
                                  device=losses.device)
        else:
            numels = [self.trainer._params[i]._data.size for i in self._live]
            plan = multi_tensor.UpdatePlan(numels, losses.device)
            scalars = None
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._collective:
            cuda_graph.warm_groups(
                [p._data._data for p in self.trainer._params
                 if p._data is not None] + [x._data for x in inputs])

        def one_step(col):
            loss = self._loss_and_grads([NDArray(s) for s in statics])
            if plan is None:
                # the per-tensor rule, reading lr, wd and t from the table
                items = self._items(mp_flags, list(scalars[0]),
                                    list(scalars[1]), list(scalars[2]))
                self._update_with_stats(
                    col, optzr, items,
                    lambda: multi_tensor._update_plain(optzr, items))
                return loss, None
            # the operands as the graph holds them (its own gradients):
            # their addresses go into the update's table before each replay
            items = self._items(mp_flags, lrs, wds, t0)
            self._update_with_stats(col, optzr, items,
                                    lambda: plan.launch(optzr))
            return loss, items

        def step():
            loss, items, _, rows = self._stat_step(stats, one_step)
            if rows is not None:
                _numerics.fold(acc, rows)  # inside the graph
            return loss, items

        graph = cuda_graph.capture(
            step, pool=self._pool,
            generators=(mx_random.generator(losses.device),))
        return {"graph": graph, "plan": plan, "scalars": scalars,
                "inputs": statics, "items": graph.outputs[1],
                "ptrs": self._addresses(), "acc": acc, "names": names}

    # -- first-call safety ---------------------------------------------------
    def _snapshot(self):
        trainer = self.trainer
        optzr = trainer._optimizer
        params = [(p, p._data._data.detach().clone())
                  for p in trainer._params if p._data is not None]
        states = [[(h, h._data.detach().clone())
                   for h in opt._state_holders(s)] for s in trainer._states]
        return (params, states, list(trainer._states),
                list(trainer._states_initialized),
                dict(optzr._index_update_count), optzr.num_update)

    def _restore(self, snapshot):
        params, states, state_objs, inited, counts, num_update = snapshot
        trainer = self.trainer
        optzr = trainer._optimizer
        with torch.no_grad():
            for p, saved in params:
                p._data._data.copy_(saved)
            for entry in states:
                for h, saved in entry:
                    h._data.copy_(saved)
        trainer._states[:] = state_objs
        trainer._states_initialized[:] = inited
        optzr._index_update_count.clear()
        optzr._index_update_count.update(counts)
        optzr.num_update = num_update


def _hyper(optzr):
    """What a captured update bakes in besides lr, wd and t: the kernel's
    scalars for an optimizer with a rule code, else the optimizer's
    scalar attributes (those its ``_step`` reads as python numbers)."""
    if optzr._kernel_rule() is not None:
        return multi_tensor.hyper(optzr)
    skip = ("lr", "wd", "num_update", "begin_num_update", "aggregate_num")
    return tuple(sorted(
        (k, v) for k, v in vars(optzr).items()
        if k not in skip and (v is None or isinstance(v, (bool, int, float,
                                                           str)))))


def _write_scalars(table, lrs, wds, t):
    """Copy this step's lr, wd and t into the (3, n) device table, from
    pinned memory (the host does not wait for the card)."""
    host = torch.tensor([lrs, wds, [float(x) for x in t]],
                        dtype=torch.float32).pin_memory()
    table.copy_(host, non_blocking=True)


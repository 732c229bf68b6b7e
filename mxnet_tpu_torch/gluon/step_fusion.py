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
hyperparameters, amp's dtype, and the addresses of the weights, masters,
states and moving statistics (each rank's local pieces under a mesh):
after ``cast`` or ``load_states`` into new tensors the next call
captures again.  ``update_on_kvstore`` is refused, as in the reference.

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
from ..base import MXNetError
from ..ndarray import NDArray
from ..ops import multi_tensor
from ..parallel import reduce_partial
from ..parallel.local import is_dtensor, local

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
        with ag.record():
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

    # -- dispatch ------------------------------------------------------------
    def __call__(self, *batch):
        trainer = self.trainer
        optzr = trainer._optimizer
        optzr.rescale_grad = trainer._scale / self.batch_size
        for i in self._live:
            trainer._init_states(i)
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
               amp.target_dtype())
        snapshot = None if sig in self._validated else self._snapshot()
        try:
            if device.type == "cuda":
                losses = self._run_graph(sig, batch, mp_flags, lrs, wds, t0,
                                         device)
            else:
                losses = self._run_unrolled(batch, mp_flags, lrs, wds, t0)
            if snapshot is not None and device.type == "cuda":
                torch.cuda.synchronize(device)  # a fault surfaces here
        except BaseException:
            if snapshot is not None:
                self._restore(snapshot)
            raise
        self._validated.add(sig)
        for i in self._live:
            optzr._index_update_count[i] = optzr._index_update_count.get(
                i, optzr.begin_num_update) + self.k
            optzr.num_update = max(optzr.num_update,
                                   optzr._index_update_count[i])
        return NDArray(losses)

    def _inputs(self, batch, k):
        return [b[k] for b in batch] if self.stacked_inputs else list(batch)

    def _run_unrolled(self, batch, mp_flags, lrs, wds, t0):
        """The K steps eagerly, one after another (CPU parameters)."""
        losses = []
        for k in range(self.k):
            losses.append(self._loss_and_grads(self._inputs(batch, k)))
            items = self._items(mp_flags, lrs, wds, [t + k for t in t0])
            self._update(self.trainer._optimizer, items)
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

    def _run_graph(self, sig, batch, mp_flags, lrs, wds, t0, device):
        """Replay this signature's step graph K times, capturing it first
        (after one eager warm-up step, which is step 0) when there is
        none or the addresses it baked in have moved."""
        optzr = self.trainer._optimizer
        losses = torch.empty(self.k, dtype=torch.float32, device=device)
        entry = self._graphs.get(sig)
        start = 0
        if entry is None or entry["ptrs"] != self._addresses():
            entry = self._capture(batch, mp_flags, lrs, wds, t0, losses)
            self._graphs[sig] = entry
            start = 1
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
        return losses

    def _static_items(self, entry, lrs, wds, t):
        return [it._replace(lr=lr, wd=wd, t=tk)
                for it, lr, wd, tk in zip(entry["items"], lrs, wds, t)]

    def _capture(self, batch, mp_flags, lrs, wds, t0, losses):
        """Step 0 eagerly on a side stream (the warm-up), then the capture
        of one step on static copies of the inputs."""
        optzr = self.trainer._optimizer
        inputs = self._inputs(batch, 0)

        def eager_step():
            loss = self._loss_and_grads(inputs)
            self._update(optzr, self._items(mp_flags, lrs, wds, t0))
            return loss

        losses[0].copy_(cuda_graph.warmup(eager_step))
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

        def step():
            loss = self._loss_and_grads([NDArray(s) for s in statics])
            if plan is None:
                # the per-tensor rule, reading lr, wd and t from the table
                multi_tensor._update_plain(optzr, self._items(
                    mp_flags, list(scalars[0]), list(scalars[1]),
                    list(scalars[2])))
                return loss, None
            # the operands as the graph holds them (its own gradients):
            # their addresses go into the update's table before each replay
            items = self._items(mp_flags, lrs, wds, t0)
            plan.launch(optzr)
            return loss, items

        graph = cuda_graph.capture(
            step, pool=self._pool,
            generators=(mx_random.generator(losses.device),))
        return {"graph": graph, "plan": plan, "scalars": scalars,
                "inputs": statics, "items": graph.outputs[1],
                "ptrs": self._addresses()}

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


from .. import _left_out as _lo  # noqa: E402

__getattr__ = _lo.refuse(dict.fromkeys(("telemetry",), _lo._9),
                         "mxnet_tpu_torch.gluon.step_fusion")

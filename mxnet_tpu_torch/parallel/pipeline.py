"""Pipeline parallelism: the GPipe and 1F1B microbatch schedules over the
``pp`` axis.

Counterpart of ``mxnet_tpu/parallel/pipeline.py``.  The reference runs
each schedule as one ``lax.scan`` inside ``shard_map``: at every tick
every stage computes (idle ticks on garbage, masked away) and
``ppermute`` moves the activations one stage along the ring.  Here the
host drives the schedule and runs only the valid (stage, microbatch)
pairs: at tick t stage s runs the forward of microbatch t - s (GPipe,
and 1F1B's forward leg) and, in 1F1B, the backward of microbatch
t - (2S - 1 - s).  The numbers are the reference's; the launch counts
are the port's own: one 1F1B step runs the forward of stages 0..S-2
2·M times (the forward leg and the recompute) and the last stage's M
times (its forward leg only stashes the input: the recompute is its
forward), and every stage's backward M times.

The transport is an argument, as in ``ring.py``'s bodies:

* ``LocalTransport(S)``: all S stages in this process, one after
  another.  A dict mesh (``{'pp': 4}``) takes it; one card runs S stages
  this way.
* ``P2PTransport(mesh, axis)``: one stage a rank, activations and
  cotangents point to point over the mesh's ``pp`` group.  All of a
  tick's sends and receives go out together in one
  ``batch_isend_irecv`` (1F1B's forward and backward sends as well:
  posted separately, NCCL deadlocks).  A ``DeviceMesh`` whose ``pp``
  axis spans several ranks takes it.

GPipe stays differentiable.  Across ranks every tick's hop is an
autograd function (``_Hop``) whose backward sends the cotangent back,
as ``ring.py``'s rotation does; the ticks form one chain on every rank
(rank 0's inputs are tied to it), so the backward runs the hops in
reverse tick order everywhere and the sends always meet their receives.
Each rank computes its own stage's slice of the parameter gradients and
stage 0 the inputs'; one all-reduce at the very end of the backward
(``_Entry``) gives every rank the full gradients, as the reference's
global arrays hold them.

1F1B returns its gradients: ``(loss_sum, stage_grads, tail_grads,
dxs)``.  Inside, each stage's parameters are its own tensors and each
gradient accumulates in its own buffer (``train_1f1b_stages``); only the
public ``pipeline_train_1f1b`` takes and returns stacks.  Each stage
stashes its microbatch inputs and recomputes its forward under autograd
for the backward (the reference's per-stage rematerialization): stage s
holds at most 2(S - s) - 1 stashed inputs, so activation memory is
O(S), independent of M.  Across ranks the loss
and the tail gradients come from the last stage, ``dxs`` from stage 0
and each stage's gradient slice from its rank; one all-reduce at the end
gives every rank all of them.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["pipeline_apply", "pipeline_train_1f1b", "train_1f1b_stages",
           "LocalTransport", "P2PTransport"]


# -- pytrees ------------------------------------------------------------------

def _flatten(tree):
    """(leaves, rebuild) of a tree of dicts (sorted keys, as JAX's
    trees), lists and tuples; anything else is a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        subs = [_flatten(x) for x in tree]
    else:
        return [tree], lambda vals: vals[0]
    leaves = [leaf for ls, _ in subs for leaf in ls]

    def rebuild(vals):
        parts, i = [], 0
        for ls, rb in subs:
            parts.append(rb(vals[i:i + len(ls)]))
            i += len(ls)
        if keys is not None:
            return dict(zip(keys, parts))
        return type(tree)(parts)

    return leaves, rebuild


def _raw(x):
    from ..ndarray import NDArray

    return x._data if isinstance(x, NDArray) else torch.as_tensor(x)


# -- transports ---------------------------------------------------------------

class LocalTransport:
    """Every stage in this process: messages stay in dicts."""

    def __init__(self, n):
        self.n = int(n)
        self.stages = tuple(range(self.n))

    def all_sum(self, tensors):
        return tensors


class P2PTransport:
    """One stage a rank over the ``axis_name`` group of ``mesh``."""

    def __init__(self, mesh, axis_name="pp"):
        self.group = mesh.get_group(axis_name)
        self.n = mesh.size(mesh.mesh_dim_names.index(axis_name))
        self.stage = mesh.get_local_rank(axis_name)
        self.stages = (self.stage,)
        self._ranks = [torch.distributed.get_global_rank(self.group, i)
                       for i in range(self.n)]

    def exchange(self, sends, recvs):
        """This stage's sends ({destination stage: tensor}) and receives
        ({source stage: like-tensor}) in one ``batch_isend_irecv`` →
        {source stage: received tensor}."""
        dist = torch.distributed
        ops, got = [], {}
        for dst, t in sends.items():
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  self._ranks[dst], self.group))
        for src, like in recvs.items():
            buf = torch.empty_like(like)
            got[src] = buf
            ops.append(dist.P2POp(dist.irecv, buf, self._ranks[src],
                                  self.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return got

    def all_sum(self, tensors):
        """Sum each tensor over the group: one flat all-reduce a dtype."""
        out = list(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idxs in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
            torch.distributed.all_reduce(flat, group=self.group)
            off = 0
            for i in idxs:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].view(tensors[i].shape)
                off += n
        return out


def stage_count(mesh, axis_name="pp"):
    """(mesh, its ``axis_name`` size): ``mesh`` or the current one, with
    the reference's errors for none and for a mesh without the axis."""
    from . import current_mesh, mesh_axes

    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise MXNetError("no active mesh; call parallel.set_mesh first")
    axes = mesh_axes(mesh)
    if axis_name not in axes:
        raise MXNetError(f"mesh has no '{axis_name}' axis: {axes}")
    return mesh, int(axes[axis_name])


def _transport(mesh, axis_name):
    """(stage count, transport) for ``mesh``: point to point when its
    ``axis_name`` spans ranks, else every stage here."""
    mesh, n = stage_count(mesh, axis_name)
    if hasattr(mesh, "get_group") and n > 1:
        return n, P2PTransport(mesh, axis_name)
    return n, LocalTransport(n)


def _check_stacked(leaves, n):
    for lf in leaves:
        if tuple(getattr(lf, "shape", ()))[:1] != (n,):
            raise MXNetError(
                f"stage_params leaves must be stacked to leading dim {n} "
                f"(got {tuple(getattr(lf, 'shape', ())) or None})")


# -- GPipe ----------------------------------------------------------------------

class _Entry(torch.autograd.Function):
    """Rank s's view of the pipeline's inputs: the microbatches and slice
    s of every stacked leaf.  The backward sums the ranks' gradients over
    the group (each rank holds its stage's slice, stage 0 the inputs'):
    one all-reduce, the last collective of the backward."""

    @staticmethod
    def forward(ctx, transport, xs, *leaves):
        ctx.transport = transport
        ctx.metas = [(t.shape, t.dtype, t.device) for t in (xs,) + leaves]
        s = transport.stage
        return (xs.view_as(xs),) + tuple(leaf[s] for leaf in leaves)

    @staticmethod
    def backward(ctx, *grads):
        s = ctx.transport.stage
        full = []
        for k, ((shape, dtype, device), g) in enumerate(zip(ctx.metas,
                                                            grads)):
            if k == 0:
                full.append(torch.zeros(shape, dtype=dtype, device=device)
                            if g is None else g.contiguous())
                continue
            f = torch.zeros(shape, dtype=dtype, device=device)
            if g is not None:
                f[s] = g
            full.append(f)
        return (None,) + tuple(ctx.transport.all_sum(full))


class _Anchor(torch.autograd.Function):
    """A zero microbatch that depends on ``deps`` (``_Entry``'s outputs):
    the head of the rank's chain of ticks, so the backward reaches
    ``_Entry`` only after the last hop."""

    @staticmethod
    def forward(ctx, like, *deps):
        ctx.n = len(deps)
        return torch.zeros_like(like)

    @staticmethod
    def backward(ctx, g):
        return (None,) * (ctx.n + 1)


class _Tie(torch.autograd.Function):
    """``x``, with the chain's carry as a second input (stage 0 reads its
    microbatches, not the carry, and its ticks must stay one chain)."""

    @staticmethod
    def forward(ctx, x, carry):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


class _Hop(torch.autograd.Function):
    """One tick's hop on rank s: send ``act`` to stage s + 1 (``send``)
    while receiving the next tick's input from stage s - 1 (``recv``);
    without a receive the carry is ``act`` itself.  The backward sends
    the received input's cotangent to s - 1 and receives ``act``'s from
    s + 1."""

    @staticmethod
    def forward(ctx, transport, send, recv, act):
        s = transport.stage
        ctx.transport, ctx.send, ctx.recv = transport, send, recv
        got = transport.exchange({s + 1: act} if send else {},
                                 {s - 1: act} if recv else {})
        return got[s - 1] if recv else act.view_as(act)

    @staticmethod
    def backward(ctx, g):
        t = ctx.transport
        s = t.stage
        got = t.exchange({s - 1: g} if ctx.recv else {},
                         {s + 1: g} if ctx.send else {})
        ga = got[s + 1] if ctx.send else torch.zeros_like(g)
        if not ctx.recv:
            ga = ga + g
        return None, None, None, ga


class _Collect(torch.autograd.Function):
    """The last stage's outputs on every rank (the reference's ``psum`` of
    the masked outputs); ``carry`` ties the rank's chain to the result."""

    @staticmethod
    def forward(ctx, transport, outs, carry, last):
        ctx.last = last
        out = outs.clone() if last else torch.zeros_like(outs)
        return transport.all_sum([out])[0]

    @staticmethod
    def backward(ctx, g):
        return None, (g if ctx.last else None), None, None


def _gpipe_local(stage_fn, rebuild, n, xs, leaves):
    params = [rebuild([leaf[s] for leaf in leaves]) for s in range(n)]
    outs = []
    for i in range(xs.shape[0]):
        h = xs[i]
        for s in range(n):
            h = stage_fn(params[s], h)
        outs.append(h)
    return torch.stack(outs)


def _gpipe_p2p(stage_fn, rebuild, transport, xs, leaves):
    n, s, m = transport.n, transport.stage, xs.shape[0]
    views = _Entry.apply(transport, xs, *leaves)
    xs_v, params = views[0], rebuild(list(views[1:]))
    carry = _Anchor.apply(xs_v[0], *views)
    outs = []
    ticks = m + n - 1
    for t in range(ticks):
        valid = 0 <= t - s < m
        if valid:
            inp = _Tie.apply(xs_v[t - s], carry) if s == 0 else carry
            act = stage_fn(params, inp)
            if s == n - 1:
                outs.append(act)
        else:
            act = carry
        if t < ticks - 1:
            carry = _Hop.apply(transport, valid and s < n - 1,
                               s > 0 and 0 <= t + 1 - s < m, act)
    stacked = torch.stack(outs) if outs else torch.zeros_like(xs)
    return _Collect.apply(transport, stacked, carry, s == n - 1)


def pipeline_apply(stage_fn, stage_params, microbatches, mesh=None,
                   axis_name="pp"):
    """Run a GPipe pipeline: ``stage_fn(stage_params_of_s, x) -> y`` on
    tensors.

    ``stage_params``: a tree (dicts, lists, tuples) whose leaves are
    stacked along a leading stage dim of size ``mesh[axis_name]``;
    ``microbatches``: (M, B, ...) of M microbatches.  Activations keep
    the microbatch shape through every stage (GPipe's constraint).
    Returns the (M, B, ...) outputs on every rank.  Differentiable end to
    end.  ``mesh`` is a ``DeviceMesh`` (its ``pp`` ranks: point to
    point) or a dict (``{'pp': 4}``: every stage here)."""
    from ..ndarray import NDArray
    from ..ops.registry import apply_op

    n, transport = _transport(mesh, axis_name)
    leaves, rebuild = _flatten(stage_params)
    _check_stacked(leaves, n)
    xs_nd = microbatches if isinstance(microbatches, NDArray) \
        else NDArray(_raw(microbatches))
    nd_leaves = [lf if isinstance(lf, NDArray) else NDArray(_raw(lf))
                 for lf in leaves]

    def g(xs, *raws):
        if isinstance(transport, LocalTransport):
            return _gpipe_local(stage_fn, rebuild, n, xs, list(raws))
        return _gpipe_p2p(stage_fn, rebuild, transport, xs, list(raws))

    return apply_op(g, xs_nd, *nd_leaves, name="pipeline_apply")


# -- 1F1B ---------------------------------------------------------------------

def _one_f_one_b(stage_fn, loss_fn, transport, xs, labels, stage_leaves,
                 rebuild, tails, tail_rebuild):
    """The 1F1B schedule for this process's stages.  ``stage_leaves[s]``
    is stage s's list of leaves (``rebuild`` makes its tree) → (loss_sum,
    a list of each stage's gradient leaves, tail grads, dxs).  Each
    leaf's gradient accumulates in its own buffer."""
    from .. import autograd as ag

    n, m = transport.n, xs.shape[0]
    stages = transport.stages
    last = n - 1
    training = ag.is_training()
    gacc = [[torch.zeros_like(lf) for lf in leaves]
            for leaves in stage_leaves]
    tacc = [torch.zeros_like(t) for t in tails]
    dxs = torch.zeros_like(xs)
    lsum = torch.zeros((), dtype=torch.float32, device=xs.device)
    stash = {s: {} for s in stages}
    like = xs[0]
    recv_f, recv_b = {}, {}

    def detached(ts):
        return [t.detach().requires_grad_() for t in ts]

    def accumulate(accs, grads):
        for acc, g in zip(accs, grads):
            if g is not None:
                acc += g

    for t in range(2 * n - 1 + m):
        send_f, send_b = {}, {}
        for s in stages:
            i = t - s
            if 0 <= i < m:                          # forward leg
                inp = xs[i] if s == 0 else recv_f.pop(s)
                stash[s][i] = inp
                if s < last:    # the last stage's recompute is its forward
                    with ag.pause(train_mode=training), torch.no_grad():
                        send_f[s + 1] = stage_fn(rebuild(stage_leaves[s]),
                                                 inp)
            j = t - (2 * n - 1 - s)
            if 0 <= j < m:                          # backward leg
                pl = detached(stage_leaves[s])
                xin = stash[s].pop(j).detach().requires_grad_()
                with ag.record(train_mode=training), torch.enable_grad():
                    y = stage_fn(rebuild(pl), xin)
                    if s == last:
                        tl = detached(tails)
                        lval = loss_fn(y, labels[j], tail_rebuild(tl))
                        grads = torch.autograd.grad(
                            lval, pl + tl + [xin], allow_unused=True)
                        lsum = lsum + lval.detach().float()
                        accumulate(tacc, grads[len(pl):-1])
                    else:
                        grads = torch.autograd.grad(
                            y, pl + [xin], recv_b.pop(s),
                            allow_unused=True)
                accumulate(gacc[s], grads[:len(pl)])
                dx = grads[-1]
                if dx is None:
                    dx = torch.zeros_like(xin)
                if s == 0:
                    dxs[j] = dx
                else:
                    send_b[s - 1] = dx
        if isinstance(transport, LocalTransport):
            recv_f, recv_b = send_f, send_b
            continue
        s = transport.stage
        expect_f = s > 0 and 0 <= t + 1 - s < m
        expect_b = s < last and 0 <= t + 1 - (2 * n - 1 - s) < m
        # the tick's forward and backward sends in ONE batch
        got = transport.exchange(
            {**send_f, **send_b},
            {**({s - 1: like} if expect_f else {}),
             **({s + 1: like} if expect_b else {})})
        recv_f = {s: got[s - 1]} if expect_f else {}
        recv_b = {s: got[s + 1]} if expect_b else {}
    flat = transport.all_sum([lsum, *[g for gs in gacc for g in gs],
                              *tacc, dxs])
    grads, off = [], 1
    for gs in gacc:
        grads.append(flat[off:off + len(gs)])
        off += len(gs)
    return flat[0], grads, flat[off:off + len(tacc)], flat[-1]


def train_1f1b_stages(stage_fn, loss_fn, stage_params, microbatches, labels,
                      tail_params=None, mesh=None, axis_name="pp"):
    """``pipeline_train_1f1b`` on tensors, with ``stage_params`` a list of
    S trees (one a stage, each its own tensors: no stacked copy) →
    ``(loss_sum, [each stage's gradient tree], tail gradient tree,
    dxs)``."""
    n, transport = _transport(mesh, axis_name)
    if len(stage_params) != n:
        raise MXNetError(f"stage_params must hold {n} stages "
                         f"(got {len(stage_params)})")
    flat = [_flatten(tree) for tree in stage_params]
    rebuild = flat[0][1]
    tail_leaves, tail_rebuild = _flatten(() if tail_params is None
                                         else tail_params)
    loss, grads, tgrads, dxs = _one_f_one_b(
        stage_fn, loss_fn, transport, _raw(microbatches).detach(),
        _raw(labels).detach(),
        [[_raw(lf).detach() for lf in leaves] for leaves, _ in flat],
        rebuild, [_raw(lf).detach() for lf in tail_leaves], tail_rebuild)
    return loss, [rebuild(g) for g in grads], tail_rebuild(tgrads), dxs


def pipeline_train_1f1b(stage_fn, loss_fn, stage_params, microbatches,
                        labels, tail_params=None, mesh=None,
                        axis_name="pp"):
    """One 1F1B pipeline TRAIN step (reference ``pipeline_train_1f1b``).

    Returns ``(loss_sum, stage_grads, tail_grads, dxs)`` as NDArrays:
    ``stage_grads`` stacked like ``stage_params``, ``tail_grads`` like
    ``tail_params`` (the head ``loss_fn`` runs on the last stage), and
    ``dxs`` the cotangent of ``microbatches`` (for an embedding stack
    outside the schedule).  ``loss_fn(last_stage_out, labels_mb,
    tail_params) -> scalar`` runs per microbatch; ``loss_sum`` is their
    sum.  Nothing is recorded: wire the gradients into the tape with an
    ``autograd.Function`` (``models.llama.llama_pipeline_train_step``).
    ``stage_fn`` and ``loss_fn`` take and return tensors."""
    from ..ndarray import NDArray

    n = stage_count(mesh, axis_name)[1]
    leaves, rebuild = _flatten(stage_params)
    _check_stacked(leaves, n)
    raws = [_raw(lf) for lf in leaves]
    loss, grads, tgrads, dxs = train_1f1b_stages(
        stage_fn, loss_fn, [rebuild([r[s] for r in raws]) for s in range(n)],
        microbatches, labels, tail_params, mesh, axis_name)
    stacked = [torch.stack(gs) for gs in
               zip(*[_flatten(g)[0] for g in grads])]
    tail_leaves, tail_rebuild = _flatten(tgrads)
    return (NDArray(loss), rebuild([NDArray(g) for g in stacked]),
            tail_rebuild([NDArray(g) for g in tail_leaves]), NDArray(dxs))

"""Distributed layer: process groups, device meshes, placements and the
synchronous store.

Counterpart of ``mxnet_tpu/parallel/__init__.py``.  The reference runs
one program over a ``jax.sharding.Mesh`` and lets GSPMD derive the
collectives; here each process drives one device, the processes form a
``torch.distributed`` group (NCCL between cards, gloo for ``ctx=cpu()``)
and a named ``DeviceMesh`` over them carries ``DTensor`` placements:

  * ``initialize`` joins the group from the reference's env contract
    (``MXT_COORDINATOR``, ``MXT_NUM_PROCESSES``, ``MXT_PROCESS_ID``, as
    ``python -m mxnet_tpu_torch.launch`` sets them), with a timeout on
    every collective;
  * ``make_mesh({'dp': 2, 'tp': 2})`` names the axes as the reference
    does (``dp``, ``tp``, ``pp``, ``sp``, ``ep``); the current mesh is
    thread-local;
  * ``shard_batch``, ``replicate``, ``shard_param`` and
    ``with_sharding`` place arrays as ``Shard(d)`` over an axis and
    ``Replicate()`` elsewhere, so every rank sees the same global shape,
    as a GSPMD array is seen;
  * a gradient of a replicated parameter comes out of the backward as
    ``Partial(sum)`` over ``dp`` (GSPMD would have summed it inside the
    jit); ``TPUSyncKVStore.allreduce_grads`` turns it into
    ``Replicate()`` with one all-reduce in place, and all-sums the
    host-local gradients of a classic data-parallel job (every rank its
    own batch, plain tensors), one all-reduce per dtype;
  * the kernels (``data_ptr`` launches) see each rank's local pieces
    through ``parallel.local`` only.

One card holds one rank: NCCL does not put two ranks of a communicator
on one device.  Multi-rank behaviour is held on the CPU with gloo
groups; a one-card machine runs the NCCL route at world size 1.

The pipeline schedules (``parallel.pipeline``: GPipe and 1F1B over the
``pp`` axis, point to point between ranks or every stage in one
process) are ported in slice 12.
"""
from __future__ import annotations

import datetime
import os
import threading

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context  # noqa: F401  (the reference re-exports it)
from ..launch import free_port  # noqa: F401
from ..ndarray.ndarray import NDArray
from .local import is_dtensor, local

__all__ = ["initialize", "is_initialized", "make_mesh", "set_mesh",
           "current_mesh", "mesh_scope", "shard_batch", "replicate",
           "shard_param", "with_sharding", "TPUSyncKVStore", "all_sum",
           "ring_attention", "ulysses_attention", "pipeline_apply",
           "pipeline_train_1f1b", "PartitionRules", "as_rules",
           "place_params", "stacked_spec", "LLAMA_RULES", "MIXTRAL_RULES",
           "FAMILY_RULES", "last_placement", "process_sum_hostvec",
           "process_gather_hostvec", "replicate_block_params",
           "mesh_axes", "placements", "world_size", "rank",
           "row_sparse_sum"]

_STATE = threading.local()
_INITIALIZED = False
_HOST_GROUP = None  # gloo group for host vectors beside an NCCL group

#: seconds a collective may wait before the group fails (every group
#: gets one, so a rank that never arrives fails its peers, not hangs them)
DEFAULT_TIMEOUT = 300.0


def is_initialized():
    """True once this process joined a process group through
    ``initialize`` (a group of one included)."""
    return _INITIALIZED and torch.distributed.is_initialized()


def world_size():
    return torch.distributed.get_world_size() if is_initialized() else 1


def rank():
    return torch.distributed.get_rank() if is_initialized() else 0


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None, init_retries=None, init_timeout=None,
               init_backoff=None, *, ctx=None):
    """Join the process group (reference ``parallel.initialize``, the
    analog of ``tools/launch.py`` + the ps-lite handshake).

    Arguments left out come from ``MXT_COORDINATOR`` (``host:port``),
    ``MXT_NUM_PROCESSES`` and ``MXT_PROCESS_ID``; with no coordinator it
    is a no-op (one process).  The backend is NCCL with this rank's card
    (``local_device_ids[0]``, else ``process_id`` modulo the cards this
    process sees), or gloo when ``ctx`` is ``mx.cpu()``.  ``init_timeout``
    (``MXT_INIT_TIMEOUT``, default ``DEFAULT_TIMEOUT`` seconds) bounds the
    rendezvous and every later collective; ``init_retries``
    (``MXT_INIT_RETRIES``, default 0) retries a failed rendezvous after
    ``init_backoff`` (``MXT_INIT_BACKOFF``) seconds, doubling."""
    import time

    global _INITIALIZED, _HOST_GROUP
    coordinator_address = coordinator_address or \
        os.environ.get("MXT_COORDINATOR")
    if num_processes is None and "MXT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MXT_NUM_PROCESSES"])
    if process_id is None and "MXT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MXT_PROCESS_ID"])
    if coordinator_address is None:
        return  # one process
    if is_initialized():
        return
    num_processes = 1 if num_processes is None else int(num_processes)
    process_id = 0 if process_id is None else int(process_id)
    if init_timeout is None:
        init_timeout = float(os.environ.get("MXT_INIT_TIMEOUT",
                                            DEFAULT_TIMEOUT))
    if init_retries is None:
        init_retries = int(os.environ.get("MXT_INIT_RETRIES", "0"))
    if init_backoff is None:
        init_backoff = float(os.environ.get("MXT_INIT_BACKOFF", "1.0"))
    on_cpu = ctx is not None and getattr(ctx, "device_type", None) == "cpu"
    kwargs = {}
    if on_cpu:
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise MXNetError(
                "parallel.initialize: no CUDA device for the NCCL group; "
                "pass ctx=mx.cpu() for a gloo group on the host")
        dev = local_device_ids[0] if local_device_ids else \
            process_id % torch.cuda.device_count()
        torch.cuda.set_device(dev)
        backend = "nccl"
        kwargs["device_id"] = torch.device("cuda", dev)
    timeout = datetime.timedelta(seconds=init_timeout)
    for attempt in range(init_retries + 1):
        try:
            torch.distributed.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id, timeout=timeout,
                **kwargs)
            break
        except Exception:
            if attempt >= init_retries:
                raise
            time.sleep(init_backoff * (2 ** attempt))
    _HOST_GROUP = None if backend == "gloo" else \
        torch.distributed.new_group(backend="gloo", timeout=timeout)
    _INITIALIZED = True


def shutdown():
    """Leave the process group (and drop the current mesh)."""
    global _INITIALIZED, _HOST_GROUP
    set_mesh(None)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    _INITIALIZED, _HOST_GROUP = False, None


def _ensure_group(device_type):
    """A one-rank group when a mesh is asked for outside any group."""
    if is_initialized():
        return
    if torch.distributed.is_initialized():
        global _INITIALIZED
        _INITIALIZED = True
        return
    from ..context import cpu

    initialize(f"127.0.0.1:{free_port()}", 1, 0,
               ctx=cpu() if device_type == "cpu" else None)


def _backend_device_type():
    return "cpu" if torch.distributed.get_backend() == "gloo" else "cuda"


def make_mesh(shape=None, axis_names=None, devices=None):
    """A named ``DeviceMesh`` over the group's ranks.

    ``shape`` is a dict ``{'dp': 2, 'tp': 2}`` or a tuple (named from
    ``('dp', 'tp', 'pp', 'sp', 'ep')``); it defaults to one ``dp`` axis
    over every rank.  The mesh covers the whole group: one rank per
    device.  Its device type follows the group's backend (``cuda`` for
    NCCL, ``cpu`` for gloo); ``devices='cpu'`` asks for a gloo group of
    one when none exists."""
    from torch.distributed.device_mesh import init_device_mesh

    _ensure_group("cpu" if devices == "cpu" else "cuda")
    n_ranks = torch.distributed.get_world_size()
    if shape is None:
        shape = {"dp": n_ranks}
    if isinstance(shape, dict):
        axis_names = tuple(shape.keys())
        dims = tuple(int(v) for v in shape.values())
    else:
        dims = tuple(int(v) for v in shape)
        axis_names = tuple(axis_names or
                           ("dp", "tp", "pp", "sp", "ep")[:len(dims)])
    n = int(np.prod(dims))
    if n != n_ranks:
        raise MXNetError(
            f"mesh {dict(zip(axis_names, dims))} needs {n} devices; the "
            f"process group has {n_ranks} (one device a rank)")
    return init_device_mesh(_backend_device_type(), dims,
                            mesh_dim_names=axis_names)


def mesh_axes(mesh):
    """``{axis name: size}`` of a mesh (a ``DeviceMesh``, a dict, or an
    object with a ``.shape`` mapping, as the rule engine's dry runs
    pass)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def set_mesh(mesh):
    _STATE.mesh = mesh
    return mesh


def current_mesh():
    return getattr(_STATE, "mesh", None)


class mesh_scope:
    """``with parallel.mesh_scope(mesh):`` — the current mesh inside."""

    def __init__(self, mesh):
        self._mesh = mesh
        self._prev = None

    def __enter__(self):
        self._prev = current_mesh()
        set_mesh(self._mesh)
        return self._mesh

    def __exit__(self, *exc):
        set_mesh(self._prev)


def _need_mesh(mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise MXNetError("no active mesh; call parallel.set_mesh first")
    return mesh


def placements(spec, mesh):
    """DTensor placements (one a mesh axis) of a partition spec (one
    entry a tensor dim: an axis name, a tuple of names, or None): the
    dim is ``Shard``-ed over each named axis, every other axis
    ``Replicate``-s.  Axes absent from the mesh replicate."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec or ()):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, (tuple, list)) else (ax,)):
            if a in names:
                out[names.index(a)] = Shard(dim)
    return out


def _to_device_tensor(data, mesh):
    t = data._data if isinstance(data, NDArray) else \
        torch.as_tensor(np.asarray(data))
    if is_dtensor(t):
        t = t.full_tensor()
    return t.to(mesh.device_type)


def _distribute(t, mesh, spec, src_data_rank=None):
    """A DTensor of the global tensor ``t`` under ``spec``.  With
    ``src_data_rank=None`` each rank keeps its own slice of its own
    ``t`` (no communication); ``0`` broadcasts rank 0's values."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.detach(), mesh, placements(spec, mesh),
                             src_data_rank=src_data_rank)


def shard_batch(data, mesh=None, axis=0, axis_name="dp"):
    """The global batch ``data`` (the same on every rank) as one array
    sharded over ``axis_name`` along ``axis``: each rank keeps only its
    rows (split_and_load's per-device slices as one logical array)."""
    mesh = _need_mesh(mesh)
    if axis_name not in mesh_axes(mesh):
        raise MXNetError(f"mesh has no {axis_name!r} axis: "
                         f"{mesh_axes(mesh)}")
    t = _to_device_tensor(data, mesh)
    spec = [None] * t.dim()
    spec[axis] = axis_name
    return NDArray(_distribute(t, mesh, spec))


def replicate(data, mesh=None):
    """The array replicated over the whole mesh (rank 0's values; an
    NDArray is rebound in place)."""
    mesh = _need_mesh(mesh)
    out = _distribute(_to_device_tensor(data, mesh), mesh, (),
                      src_data_rank=0)
    if isinstance(data, NDArray):
        data._data = out
        return data
    return NDArray(out)


def _place_parameter(param, spec, mesh):
    """Rebind ``param``'s tensor to a DTensor leaf under ``spec`` (rank
    0's values, so replicated pieces are bitwise equal on every rank);
    its gradient buffer starts again."""
    arr = param._data if hasattr(param, "_data") else param
    if hasattr(param, "_check_initialized"):
        param._check_initialized()
        arr = param._data
    t = arr._data
    if is_dtensor(t):
        t = t.full_tensor()
    req = arr._grad_req
    placed = _distribute(t.to(mesh.device_type), mesh, spec,
                         src_data_rank=0)
    arr._data = torch.nn.Parameter(placed, requires_grad=req != "null")
    arr._grad = None
    if req != "null":
        arr.attach_grad(req)
    return param


def shard_param(param, spec, mesh=None):
    """Tensor-parallel placement of a Parameter (or NDArray): ``spec``
    names an axis (or None) per dim, e.g. ``('tp', None)`` for a
    row-sharded weight."""
    return _place_parameter(param, spec, _need_mesh(mesh))


def with_sharding(raw, spec, mesh=None):
    """``raw`` (a tensor or DTensor) laid out as ``spec`` (the analog of
    ``with_sharding_constraint``; differentiable)."""
    mesh = _need_mesh(mesh)
    pl = placements(spec, mesh)
    if is_dtensor(raw):
        return raw.redistribute(mesh, pl)
    from torch.distributed.tensor import DTensor, Replicate

    rep = DTensor.from_local(raw, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, pl)


def replicate_block_params(block, mesh=None):
    """Replicate every initialized parameter of a block over the mesh
    (the bulk placement step of data-parallel training)."""
    mesh = _need_mesh(mesh)
    for p in block.collect_params().values():
        if p._data is not None:
            _place_parameter(p, (), mesh)
    return block


def reduce_partial(t):
    """A DTensor whose placements include ``Partial``: the same local
    storage all-reduced in place over those axes and relabelled
    ``Replicate`` (no copy); any other tensor is returned as it is."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = t.device_mesh
    local = t.to_local()
    new = []
    for dim, p in enumerate(t.placements):
        if p.is_partial():
            op = torch.distributed.ReduceOp.SUM if \
                getattr(p, "reduce_op", "sum") == "sum" else \
                torch.distributed.ReduceOp.AVG
            torch.distributed.all_reduce(local, op=op,
                                         group=mesh.get_group(dim))
            new.append(Replicate())
        else:
            new.append(p)
    return DTensor.from_local(local, mesh, new, run_check=False,
                              shape=t.shape, stride=t.stride())


def all_sum(arrays, group=None):
    """Cross-replica sum of gradients (reference ``parallel.all_sum``).

    A DTensor that is ``Partial`` becomes ``Replicate`` (one in-place
    all-reduce); a DTensor that is not is already the reduced value and
    passes.  Plain tensors are host-local (each rank its own batch):
    they are all-summed over the group, one all-reduce per dtype over a
    flattened buffer, as the reference's multi-process branch does.  One
    process: the identity.  Every rank must call it (SPMD).  ``group``:
    the group plain tensors are summed over (default: every rank)."""
    if isinstance(arrays, NDArray):
        arrays = [arrays]
    out = list(arrays)
    raws = [a._data if isinstance(a, NDArray) else a for a in arrays]
    local_idx = []
    for i, r in enumerate(raws):
        if is_dtensor(r):
            red = reduce_partial(r)
            out[i] = NDArray(red) if isinstance(arrays[i], NDArray) else red
        else:
            local_idx.append(i)
    if world_size() == 1 or not local_idx:
        return out
    by_dtype = {}
    for i in local_idx:
        by_dtype.setdefault(raws[i].dtype, []).append(i)
    for dtype, idxs in by_dtype.items():
        flat = torch.cat([raws[i].reshape(-1) for i in idxs])
        torch.distributed.all_reduce(flat, group=group)
        off = 0
        for i in idxs:
            n = raws[i].numel()
            val = flat[off:off + n].view(raws[i].shape)
            off += n
            out[i] = NDArray(val) if isinstance(arrays[i], NDArray) else val
    return out


def process_sum_hostvec(vec):
    """Sum a host 1-D numpy vector over every process (SPMD: each rank
    calls with the same length); the identity in one process.  The hop
    of SyncBatchNorm statistics and other small host reductions."""
    vec = np.asarray(vec)
    if world_size() == 1:
        return vec
    t = torch.from_numpy(np.ascontiguousarray(vec, dtype=np.float64))
    torch.distributed.all_reduce(t, group=_HOST_GROUP)
    return t.numpy().astype(vec.dtype, copy=False).reshape(vec.shape)


def broadcast_object(obj, src=0):
    """Rank ``src``'s picklable ``obj`` on every rank (the identity in one
    process)."""
    if world_size() == 1:
        return obj
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=src, group=_HOST_GROUP)
    return box[0]


def barrier():
    """Wait for every rank (host side; a no-op in one process)."""
    if world_size() > 1:
        torch.distributed.barrier(group=_HOST_GROUP)


def process_gather_hostvec(vec):
    """Allgather a host 1-D vector: ``(world_size, len(vec))``, row r is
    rank r's vector (a sum of rank-slotted zeros, as the reference)."""
    vec = np.asarray(vec, dtype=np.float64).ravel()
    n = world_size()
    if n == 1:
        return vec.reshape(1, -1)
    r = rank()
    flat = np.zeros(n * vec.size, dtype=vec.dtype)
    flat[r * vec.size:(r + 1) * vec.size] = vec
    return process_sum_hostvec(flat).reshape(n, vec.size)


class TPUSyncKVStore:
    """``dist_tpu_sync`` (and ``dist_sync``, ``dist_device_sync``,
    ``horovod``): the synchronous store.  On the card it is an NCCL
    all-reduce; on the host (``ctx=cpu()`` groups) gloo.  The class
    keeps the reference's name so its counterpart is found.

    ``allreduce_grads`` (the Trainer's hook): a gradient that is
    ``Partial`` over the mesh becomes ``Replicate`` (one all-reduce, in
    place); plain host-local gradients are all-summed over the group.
    With compression set, each gradient is quantized with its
    per-parameter residual before the all-reduce (reference
    ``parallel/__init__.py:481-488``).  ``init``/``push``/``pull``/
    ``broadcast`` behave like one logical store for eager code:
    ``broadcast`` and ``init`` take rank 0's value, ``push`` sums the
    ranks' values (row_sparse ones over the union of the ranks' rows,
    ``row_sparse_sum``), and ``row_sparse_pull`` reads the local
    store."""

    def __init__(self):
        from .. import kvstore as kvs

        self.type = "dist_tpu_sync"
        self._local = kvs.KVStore("dist_tpu_sync_local")
        self._mesh = current_mesh()
        self._compression = None
        self._residuals = {}

    def allreduce_grads(self, params):
        with telemetry.span("kvstore.allreduce"):
            return self._allreduce_grads_impl(params)

    def _allreduce_grads_impl(self, params):
        grads = []
        for p in params:
            if p._data is None or p.grad_req == "null":
                continue
            grads.append((p, p.grad()))
        if telemetry.is_enabled():
            telemetry.count("kvstore.allreduce_bytes",
                            sum(telemetry.nbytes_of(g) for _, g in grads))
        if self._compression is not None:
            # each rank quantizes its own (local) gradient before the hop
            for p, g in grads:
                loc = local(g._data)
                q, self._residuals[p.name] = self._compression.roundtrip(
                    NDArray(loc), self._residuals.get(p.name))
                with torch.no_grad():
                    loc.copy_(q._data)
        sum_plain, group = self._plain_group()
        if not sum_plain:
            grads = [(p, g) for p, g in grads if is_dtensor(g._data)]
        summed = all_sum([g for _, g in grads], group=group)
        for (_, g), s in zip(grads, summed):
            if s._data is not g._data:
                g._data = s._data
        return params

    def _plain_group(self):
        """(whether host-local (plain) gradients are summed, the group
        they are summed over): every rank, except under a mesh with a
        ``pp`` axis, whose stages already hold the same (gathered)
        gradients: there only the ``dp`` ranks are summed, and nothing
        without a ``dp`` axis."""
        mesh = self._mesh or current_mesh()
        axes = mesh_axes(mesh) if hasattr(mesh, "get_group") else {}
        if axes.get("pp", 1) <= 1:
            return True, None
        if axes.get("dp", 1) <= 1:
            return False, None
        return True, mesh.get_group("dp")

    @property
    def rank(self):
        return rank()

    @property
    def num_workers(self):
        return world_size()

    @property
    def num_devices(self):
        mesh = self._mesh or current_mesh()
        if mesh is not None:
            return int(np.prod(list(mesh_axes(mesh).values())))
        return world_size()

    # -- the eager store surface ---------------------------------------------
    def init(self, key, value):
        """Rank 0's value, on every rank (the reference's init
        semantics)."""
        from ..kvstore import _pairs

        for k, v in zip(*_pairs(key, value)):
            self._local.init(k, _broadcast0(v))

    def push(self, key, value, priority=0):
        """Sum value(s) over local devices, then over the ranks."""
        from ..kvstore import _merge, _pairs
        from ..ndarray import sparse as sp

        for k, v in zip(*_pairs(key, value)):
            merged = _merge(v)
            if isinstance(merged, sp.RowSparseNDArray):
                merged = row_sparse_sum(merged)
            else:
                merged = all_sum([merged])[0]
            self._local.push(k, merged, priority)

    @property
    def _updater(self):
        """The local store's updater (``set_optimizer``)."""
        return self._local._updater

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        self._local.pull(key, out, priority, ignore_sparse)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        self._local.row_sparse_pull(key, out, priority, row_ids)

    def broadcast(self, key, value, out=None, priority=0):
        self.init(key, value)
        if out is not None:
            self.pull(key, out, priority)

    def set_optimizer(self, optimizer):
        self._local.set_optimizer(optimizer)

    def set_updater(self, updater):
        self._local.set_updater(updater)

    def set_gradient_compression(self, compression_params):
        from ..kvstore import gradient_compression as gc

        self._compression = gc.create(compression_params)
        self._residuals = {}

    def save_optimizer_states(self, fname, dump_optimizer=False):
        self._local.save_optimizer_states(fname, dump_optimizer)

    def load_optimizer_states(self, fname):
        self._local.load_optimizer_states(fname)


def row_sparse_sum(v, group=None):
    """A ``RowSparseNDArray`` summed over the ranks of ``group`` (default:
    every rank): the row ids are all-gathered, each rank scatters its
    rows into the sorted union of them, and one all-reduce sums those.
    Every rank must call it (SPMD).  One process: the identity."""
    from ..ndarray import sparse as sp

    if world_size() == 1:
        return v
    idx, vals = v.indices._data, v.data._data
    n = torch.tensor([idx.numel()], device=idx.device)
    counts = [torch.zeros_like(n)
              for _ in range(torch.distributed.get_world_size(group))]
    torch.distributed.all_gather(counts, n, group=group)
    width = int(max(c.item() for c in counts))
    padded = torch.full((width,), -1, dtype=torch.int64, device=idx.device)
    padded[:idx.numel()] = idx
    every = [torch.empty_like(padded) for _ in counts]
    torch.distributed.all_gather(every, padded, group=group)
    every = torch.cat(every)
    union = torch.unique(every[every >= 0], sorted=True)
    total = torch.zeros((len(union),) + tuple(vals.shape[1:]),
                        dtype=vals.dtype, device=vals.device)
    total.index_add_(0, torch.searchsorted(union, idx), vals)
    torch.distributed.all_reduce(total, group=group)
    return sp.RowSparseNDArray(NDArray(total), union, v.shape)


def _broadcast0(v):
    """An NDArray with rank 0's value (a copy on every rank; a sparse
    value is broadcast in its dense form)."""
    from ..kvstore import _dense, _merge

    v = _dense(_merge(v))
    t = v._data
    if is_dtensor(t):  # placed from rank 0's values already
        return NDArray(t.clone())
    t = t.clone()
    if world_size() > 1:
        torch.distributed.broadcast(t, 0)
    return NDArray(t)


from .ring import ring_attention, ulysses_attention  # noqa: E402
from .pipeline import pipeline_apply, pipeline_train_1f1b  # noqa: E402
from .partition import (PartitionRules, as_rules, place_params,  # noqa: E402
                        stacked_spec, LLAMA_RULES, MIXTRAL_RULES,
                        FAMILY_RULES, last_placement)

from .. import telemetry  # noqa: E402

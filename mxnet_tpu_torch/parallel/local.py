"""Each rank's local pieces of a ``DTensor``: the one place where the
kernels meet the mesh.

Counterpart of the reference's ``_pallas_maybe_sharded``
(``mxnet_tpu/ops/flash_attention.py:561``): a hand-written kernel takes
``data_ptr``s, and a ``DTensor``'s pointer is not its rank's storage.
So every launch under a mesh goes through here:

  * ``local(t)``: the local shard's tensor (it shares storage with the
    DTensor, so an in-place kernel write lands in the DTensor); any
    other tensor as it is;
  * ``sharded_call(fn, args, specs, out_specs)``: lay each DTensor
    argument out as its partition spec (``('dp', 'tp', None, None)``),
    call ``fn`` on the local pieces and wrap its outputs back as
    DTensors with ``out_specs`` — a ``shard_map`` over the tensor's own
    mesh, differentiable through torch's ``redistribute``/``to_local``/
    ``from_local``.

A spec axis absent from the mesh, of size 1, or not dividing its dim
resolves to ``None`` (that dim is replicated, and each rank computes it
whole), except with ``strict=True``, where an indivisible dim raises:
on the card the kernels take no plain route.
"""
from __future__ import annotations

import sys

from ..base import MXNetError


def is_dtensor(t):
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def any_dtensor(tensors):
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(t, mod.DTensor)
                                   for t in tensors)


def local(t):
    """The rank's local tensor of a DTensor (shared storage), else ``t``."""
    return t.to_local() if is_dtensor(t) else t


def copy_global_into(dst, src):
    """Copy the global array ``src`` (a plain tensor, e.g. from the host)
    into ``dst`` in place: a DTensor takes each rank's own piece of it
    (no communication), a plain tensor the whole."""
    import torch

    with torch.no_grad():
        if is_dtensor(dst):
            from torch.distributed.tensor import distribute_tensor

            piece = distribute_tensor(
                src.to(dst.device_mesh.device_type), dst.device_mesh,
                dst.placements, src_data_rank=None).to_local()
            dst.to_local().copy_(piece)
        else:
            dst.copy_(src)


def as_global(t, mesh):
    """A plain tensor as the replicated global array on ``mesh`` (a
    DTensor as it is)."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def replicate_plain(tensors):
    """``tensors`` with each plain tensor among DTensors made the
    replicated global array on their mesh (an operand, a table or a mask
    made alike on every rank); the list as it is without a DTensor.
    Explicit, where torch's implicit replication is a process-wide
    switch."""
    mesh = next((t.device_mesh for t in tensors if is_dtensor(t)), None)
    if mesh is None:
        return list(tensors)
    return [as_global(t, mesh) for t in tensors]


def spec_of(t):
    """The partition spec of a DTensor's placements (per dim: the axis
    name that shards it, a tuple of names, or None)."""
    names = t.device_mesh.mesh_dim_names
    spec = [[] for _ in range(t.ndim)]
    for ax, p in zip(names, t.placements):
        if p.is_shard():
            spec[p.dim % t.ndim].append(ax)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in spec)


def resolve_spec(spec, shape, mesh, strict=False, what="operand"):
    """``spec`` with the axes that cannot shard ``shape`` on ``mesh``
    set to None (absent, size 1, indivisible); ``strict`` raises on an
    indivisible one."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for dim, ax in enumerate(spec):
        n = sizes.get(ax, 1) if ax is not None else 1
        if ax is None or n <= 1:
            out.append(None)
        elif shape[dim] % n:
            if strict:
                raise MXNetError(
                    f"{what}: dim {dim} of shape {tuple(shape)} is not "
                    f"divisible by mesh axis {ax}={n}")
            out.append(None)
        else:
            out.append(ax)
    return tuple(out)


def sharded_call(fn, args, specs, out_specs, strict=False, what="op"):
    """``fn`` on each rank's local pieces of ``args`` (see the module
    docstring).  ``specs[i]`` lays out ``args[i]`` (None: pass it as it
    is); outputs are wrapped with ``out_specs`` (a spec, or a tuple of
    specs for a tuple of outputs), where an axis some input could not
    shard is dropped, and ``"sum"`` marks a sum over the sharded rows
    (``Partial`` over the axes the inputs sharded).  Without a DTensor
    argument ``fn`` is called directly."""
    if not any_dtensor(args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from . import placements

    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    used, dropped, resolved = set(), set(), []
    for a, s in zip(args, specs):
        r = None
        if s is not None and is_dtensor(a):
            r = resolve_spec(s, a.shape, mesh, strict, what)
            dropped.update(ax for ax, got in zip(s, r)
                           if ax is not None and got is None)
            used.update(ax for ax in r if ax is not None)
        resolved.append(r)
    locals_ = []
    for a, r in zip(args, resolved):
        if r is None:
            locals_.append(a)
            continue
        pl = placements(r, mesh)
        # an input whole over an axis that shards the others gets each
        # rank's share of its gradient: a partial sum over that axis
        grad_pl = [Partial() if ax in used and ax not in r else p
                   for ax, p in zip(mesh.mesh_dim_names, pl)]
        locals_.append(a.redistribute(mesh, pl).to_local(
            grad_placements=grad_pl))
    outs = fn(*locals_)
    single = not isinstance(outs, (tuple, list))
    outs = (outs,) if single else tuple(outs)
    oss = (out_specs,) if single else tuple(out_specs)
    wrapped = []
    for o, s in zip(outs, oss):
        if s == "sum":
            pl = [Partial() if ax in used else Replicate()
                  for ax in mesh.mesh_dim_names]
        else:
            pl = placements(tuple(
                None if ax in dropped or sizes.get(ax, 1) <= 1 else ax
                for ax in s), mesh)
        wrapped.append(DTensor.from_local(o, mesh, pl, run_check=False))
    return wrapped[0] if single else tuple(wrapped)

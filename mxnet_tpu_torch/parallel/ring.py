"""Sequence parallelism: ring attention and Ulysses all-to-all.

Counterpart of ``mxnet_tpu/parallel/ring.py``.  Q/K/V are sharded over
the ``sp`` mesh axis along the sequence.

  * **Ring**: each rank keeps its Q chunk and folds one K/V chunk a step
    into an online softmax (running max, running normalizer), while the
    K/V chunks rotate one rank along the ring.  The fold is torch ops,
    as the reference's is einsums (``_block_attn``), not a kernel.
    Masks use global positions (``qpos = idx·Tq + arange``), so causal
    masking is exact with no bottom-right/top-left question.
  * **Ulysses**: an all-to-all trades the sequence shard for a head
    shard, each rank attends over the whole sequence on its heads
    through ``ops.attention.sdpa_raw`` (the flash kernels #1–#3 on the
    card), and a second all-to-all trades back.

The bodies (``_ring_body``, ``_ulysses_body``) take their transport as
an argument: across ranks it is point-to-point sends
(``batch_isend_irecv``) or ``all_to_all_single``, each a
``torch.autograd.Function`` whose backward moves the gradient the other
way (a rotation's backward sends to rank −1; an all-to-all's backward is
the inverse all-to-all).  One process can run the bodies for every
virtual rank over a local transport (``chip_smoke.py`` does, at
``llama3_8b``'s width on one card).
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .local import as_global, is_dtensor, sharded_call

__all__ = ["ring_attention", "ulysses_attention", "ring_attention_raw",
           "ulysses_attention_raw"]

_NEG = -1.0e30   # logit of a masked key
_FLOOR = -1.0e9  # running-max floor: keeps exp(_NEG - m) == 0 exactly


def _block_attn(q, k, v, m, l, acc, qpos, kpos, causal, scale):
    """Fold one K/V block into the online-softmax state.

    q (B, Tq, N, H); k/v (B, Tk, N, H); m/l (B, N, Tq) f32; acc
    (B, N, Tq, H) f32; qpos/kpos global positions."""
    logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
    if causal:
        keep = qpos[:, None] >= kpos[None, :]
        logits = torch.where(keep[None, None], logits,
                             torch.full_like(logits, _NEG))
    m_new = torch.maximum(m, logits.amax(dim=-1).clamp_min(_FLOOR))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bnts,bsnh->bnth", p,
                                                   v.float())
    return m_new, l_new, acc_new


def _ring_body(q, k, v, idx, n, causal, scale, shift):
    """One rank's ring: its Q chunk stays, the K/V chunks arrive one a
    step.  q/k/v (B, T/n, N, H) local chunks; ``idx`` is the rank's place
    on the ring; ``shift(k, v, step)`` returns the chunks held by rank
    ``idx - 1`` before the step.  Returns (B, T/n, N, H) in q's dtype."""
    b, tq, nh, hd = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    qpos = idx * tq + torch.arange(tq, device=q.device)
    m = torch.full((b, nh, tq), _FLOOR, device=q.device)
    l = torch.zeros((b, nh, tq), device=q.device)
    acc = torch.zeros((b, nh, tq, hd), device=q.device)
    for r in range(n):
        # after r rotations along the +1 ring we hold chunk (idx - r) mod n
        tk = k.shape[1]
        kpos = ((idx - r) % n) * tk + torch.arange(tk, device=q.device)
        m, l, acc = _block_attn(q, k, v, m, l, acc, qpos, kpos, causal,
                                scale)
        if r < n - 1:
            k, v = shift(k, v, r)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l[..., None]).to(q.dtype)           # (B, N, Tq, H)
    return out.permute(0, 2, 1, 3)


def _ulysses_body(q, k, v, causal, scale, to_heads, to_seq):
    """One rank's Ulysses: (B, T/n, N, H) chunks → ``to_heads`` →
    (B, T, N/n, H) → ``sdpa_raw`` → ``to_seq`` → (B, T/n, N, H)."""
    from ..ops.attention import sdpa_raw

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    return to_seq(sdpa_raw(qh, kh, vh, scale=scale, causal=causal))


class _Rotate(torch.autograd.Function):
    """K and V one rank along the ring (to rank +1, from rank −1);
    the backward sends the gradients the other way."""

    @staticmethod
    def forward(ctx, k, v, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _send_recv((k, v), nxt, prv, group)

    @staticmethod
    def backward(ctx, gk, gv):
        gk = torch.zeros_like(gk) if gk is None else gk
        gv = torch.zeros_like(gv) if gv is None else gv
        dk, dv = _send_recv((gk, gv), ctx.prv, ctx.nxt, ctx.group)
        return dk, dv, None, None, None


def _send_recv(tensors, dst, src, group):
    """Send ``tensors`` to global rank ``dst`` while receiving as many
    from ``src``."""
    ops, outs = [], []
    for t in tensors:
        t = t.contiguous()
        buf = torch.empty_like(t)
        ops.append(torch.distributed.P2POp(torch.distributed.isend, t, dst,
                                           group))
        ops.append(torch.distributed.P2POp(torch.distributed.irecv, buf,
                                           src, group))
        outs.append(buf)
    for w in torch.distributed.batch_isend_irecv(ops):
        w.wait()
    return tuple(outs)


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all over ``group``: split dim ``split`` into n
    chunks, send chunk j to rank j, concatenate what arrives along
    ``concat`` (rank order).  The backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.concat, ctx.split), None, None, \
            None


def _all_to_all(x, group, split, concat):
    n = torch.distributed.get_world_size(group)
    parts = torch.stack(torch.chunk(x, n, dim=split)).contiguous()
    out = torch.empty_like(parts)
    torch.distributed.all_to_all_single(out, parts, group=group)
    return torch.cat(out.unbind(0), dim=concat)


def _validate_sp(is_ulysses, q_btnh, n, axis_name):
    """The reference's divisibility checks (q in (B, T, N, H))."""
    if q_btnh.shape[1] % n:
        raise MXNetError(
            f"sequence length {q_btnh.shape[1]} not divisible by "
            f"{axis_name}={n}")
    if is_ulysses and q_btnh.shape[2] % n:
        raise MXNetError(
            f"ulysses_attention needs heads ({q_btnh.shape[2]}) divisible "
            f"by {axis_name}={n}")


def _body_fn(is_ulysses, mesh, axis_name, causal, scale):
    """The per-rank function of a body over the real transport."""
    group = mesh.get_group(axis_name)
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    idx = mesh.get_local_rank(axis_name)
    if is_ulysses:
        return lambda q, k, v: _ulysses_body(
            q, k, v, causal, scale,
            lambda x: _AllToAll.apply(x, group, 2, 1),
            lambda x: _AllToAll.apply(x, group, 1, 2))
    nxt = torch.distributed.get_global_rank(group, (idx + 1) % n)
    prv = torch.distributed.get_global_rank(group, (idx - 1) % n)
    return lambda q, k, v: _ring_body(
        q, k, v, idx, n, causal, scale,
        lambda kc, vc, _r: _Rotate.apply(kc, vc, group, nxt, prv))


def _sp_mesh(q, mesh, axis_name):
    from . import current_mesh, mesh_axes

    mesh = mesh if mesh is not None else (
        q.device_mesh if is_dtensor(q) else current_mesh())
    if mesh is None or axis_name not in mesh_axes(mesh):
        return mesh, None
    return mesh, mesh_axes(mesh)[axis_name]


def _sp_btnh(is_ulysses, q, k, v, causal, scale, mesh, axis_name,
             batch_axis=None, head_axis=None):
    """(B, T, N, H) tensors over the ``axis_name`` ring of ``mesh``."""
    mesh, n = _sp_mesh(q, mesh, axis_name)
    _validate_sp(is_ulysses, q, n, axis_name)
    spec = (batch_axis, axis_name, head_axis, None)
    q, k, v = (as_global(t, mesh) for t in (q, k, v))
    fn = _body_fn(is_ulysses, mesh, axis_name, causal, scale)
    return sharded_call(fn, (q, k, v), (spec, spec, spec), spec,
                        what="ulysses_attention" if is_ulysses
                        else "ring_attention")


def _sp_apply(is_ulysses, query, key, value, causal, scale, mesh,
              axis_name):
    from ..ops.registry import apply_op

    mesh0, n = _sp_mesh(query._data, mesh, axis_name)
    if mesh0 is None:
        raise MXNetError("no active mesh; call parallel.set_mesh first")
    if n is None:
        from . import mesh_axes

        raise MXNetError(f"mesh has no '{axis_name}' axis: "
                         f"{mesh_axes(mesh0)}")
    return apply_op(
        lambda q, k, v: _sp_btnh(is_ulysses, q, k, v, causal, scale, mesh0,
                                 axis_name),
        query, key, value,
        name="ulysses_attention" if is_ulysses else "ring_attention")


def ring_attention(query, key, value, causal=False, scale=None, mesh=None,
                   axis_name="sp"):
    """Ring attention over the ``axis_name`` mesh axis.

    query/key/value: (B, T, N, H) NDArrays, T sharded over the ring (a
    plain array is taken as the global array).  Differentiable and exact:
    it matches dense attention."""
    return _sp_apply(False, query, key, value, causal, scale, mesh,
                     axis_name)


def ulysses_attention(query, key, value, causal=False, scale=None, mesh=None,
                      axis_name="sp"):
    """Ulysses (all-to-all, head-sharded) attention; the head count must
    divide by the ``axis_name`` axis."""
    return _sp_apply(True, query, key, value, causal, scale, mesh,
                     axis_name)


def _raw_sp(is_ulysses, q, k, v, causal, scale, mesh, axis_name,
            batch_axis="dp", head_axis="tp"):
    """Raw entry for model code: q/k/v (B, H, T, D).  Without a mesh that
    has the ``sp`` axis it is the single-device flash call; otherwise
    batch and heads are also sharded over ``dp``/``tp`` where they
    divide, as the reference's ``_raw_sp``."""
    mesh, n = _sp_mesh(q, mesh, axis_name)
    if n is None:
        from ..ops.flash_attention import flash_attention_raw

        return flash_attention_raw(q, k, v, causal, scale)
    out = _sp_btnh(is_ulysses, q.transpose(1, 2), k.transpose(1, 2),
                   v.transpose(1, 2), causal, scale, mesh, axis_name,
                   batch_axis, head_axis)
    return out.transpose(1, 2)


def ring_attention_raw(q, k, v, causal=False, scale=None, mesh=None,
                       axis_name="sp"):
    return _raw_sp(False, q, k, v, causal, scale, mesh, axis_name)


def ulysses_attention_raw(q, k, v, causal=False, scale=None, mesh=None,
                          axis_name="sp"):
    return _raw_sp(True, q, k, v, causal, scale, mesh, axis_name)

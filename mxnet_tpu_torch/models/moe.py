"""Mixture-of-Experts layer and expert parallelism.

Counterpart of ``mxnet_tpu/models/moe.py``: the reference's
fixed-capacity formulation, in plain torch ops as the reference's are
jnp outside any Pallas kernel.

- The expert weights are stacked into single ``(E, ...)`` parameters, so
  the whole bank is three batched products (``_expert_ffn``), not E
  small ones.
- Routing has a fixed capacity: the dispatch and combine tensors have the
  static shape ``(N, E, C)``, and tokens past an expert's capacity are
  dropped from the expert path (they pass through the residual stream).
  Nothing reads a count back to the host (no ``nonzero``, no boolean
  indexing), so a forward or a whole training step can be captured in a
  CUDA graph.
- Two routers, as the reference's: ``topk`` (tokens pick k experts, the
  gates renormalised over the chosen k; slots are handed out in token
  order, one choice rank ``s`` at a time, with each expert's count
  carried across ``s``) and ``expert_choice`` (experts pick their top-C
  tokens; balanced by construction, no auxiliary loss).
- The router runs in float32 whatever the activation dtype.  The
  dispatch and combine tensors are in x's dtype, so in bf16 the gates
  are rounded after the renormalisation, as in the reference.

Expert parallelism (``shard_moe``, or ``shard_llama`` through
``MIXTRAL_RULES``): over a mesh the banks are ``DTensor``s split over
``ep`` (and over ``tp`` inside each expert).  The reference lets GSPMD
derive the collectives from its einsums; here the routing runs on every
rank over all tokens of the call (the capacity and the slot order are the
reference's, computed over the global token axis), and each rank runs
its own experts on its slice of the bank (``disp[:, e0:e1, :]`` against
its ``(E/ep, I/tp, H)`` shard, through ``parallel.local.sharded_call``);
its combine is a partial sum over ``ep`` (and ``tp``), summed over the
group.
"""
from __future__ import annotations

import math
import threading

import torch

from .. import cuda_graph
from ..base import MXNetError
from ..gluon.block import HybridBlock
from ..ops.registry import apply_op
from ..parallel.local import any_dtensor, is_dtensor, sharded_call, spec_of

__all__ = ["MoEMLP", "collect_aux", "moe_param_specs", "shard_moe"]

# thread-local, as the autograd state: concurrent per-thread training must
# not share a sink
_TLS = threading.local()


def _sink():
    return getattr(_TLS, "aux_sink", None)


class collect_aux:
    """Collect the per-layer load-balancing losses of an eager forward::

        with moe.collect_aux() as aux:
            logits = net(x)                       # not hybridized
            loss = ce(logits, y) + 0.01 * sum(aux)

    Each entry is a recorded scalar NDArray (a second output of the MoE
    op), so ``backward()`` trains the router through it.  Inside a
    ``hybridize()`` or ``FusedTrainStep`` capture a forward raises: a
    value made in a captured graph cannot leave it."""

    def __enter__(self):
        self._prev = _sink()
        _TLS.aux_sink = []
        return _TLS.aux_sink

    def __exit__(self, *exc):
        _TLS.aux_sink = self._prev
        return False


def capacity(n, k, capacity_factor, num_experts):
    """Slots an expert has for a call of ``n`` tokens:
    ``min(max(1, ceil(n·k·cf/E)), n)`` (an expert holds at most n)."""
    return min(max(1, int(math.ceil(n * k * capacity_factor
                                    / num_experts))), n)


def _one_hot(idx, n, dtype):
    """``idx`` (...) → (..., n) one-hot in ``dtype``, with no host read
    (torch's ``one_hot`` checks the range on the host off the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(xt, rw, num_experts, k, c, router):
    """Routing of the tokens ``xt`` (N, H) by the router ``rw`` (E, H) →
    ``(disp, comb, aux)``: the (N, E, C) dispatch and combine tensors in
    xt's dtype and the f32 load-balancing loss (0 for expert_choice)."""
    e, n, dt = num_experts, xt.shape[0], xt.dtype
    probs = torch.softmax(xt.float() @ rw.float().t(), dim=-1)   # (N, E)
    if router == "expert_choice":
        gates, idx = torch.topk(probs.t(), c, dim=-1)             # (E, C)
        disp = _one_hot(idx, n, dt).permute(2, 0, 1)              # (N, E, C)
        return disp, disp * gates.to(dt)[None], probs.new_zeros(())
    gates, idx = torch.topk(probs, k, dim=-1)                     # (N, k)
    gates = gates / gates.sum(-1, keepdim=True)
    disp = comb = 0
    counts = torch.zeros(e, dtype=torch.long, device=xt.device)
    for s in range(k):  # k is tiny: unrolled
        sel = idx[:, s]
        onehot = _one_hot(sel, e, torch.long)
        pos = (onehot * (onehot.cumsum(0) - 1 + counts[None])).sum(-1)
        keep = (pos < c).to(dt)
        # token n's one slot (sel, min(pos, C-1)) as an (N, E, C) one-hot:
        # the reference's scatter-add, with no index check read back to the
        # host (torch's accumulating index_put reads the index range);
        # no two kept tokens share a slot, and a dropped one adds 0, so
        # the sums are exact
        place = _one_hot(sel, e, dt)[:, :, None] * \
            _one_hot(pos.clamp(0, c - 1), c, dt)[:, None, :]
        disp = disp + place * keep[:, None, None]
        comb = comb + place * (keep * gates[:, s].to(dt))[:, None, None]
        counts = counts + onehot.sum(0)
    # Switch-style load-balance loss: E · Σ_e frac_e · mean(probs)_e
    frac = _one_hot(idx[:, 0], e, torch.float32).mean(0)
    return disp, comb, e * (frac * probs.mean(0)).sum()


def _expert_ffn(ein, gw, uw, dw):
    """SwiGLU over the stacked bank: ein (E, C, H) → (E, C, H), three
    batched products; the weights are cast to the activations' dtype."""
    dt = ein.dtype
    g = torch.einsum("ech,eih->eci", ein, gw.to(dt))
    u = torch.einsum("ech,eih->eci", ein, uw.to(dt))
    return torch.einsum("eci,ehi->ech", g * torch.sigmoid(g) * u, dw.to(dt))


def experts(xt, disp, comb, gw, uw, dw):
    """The expert path of the tokens ``xt`` (N, H) through the experts of
    ``disp``/``comb`` (N, E', C) and the banks (E', I', H)/(E', H, I'):
    dispatch, the bank, combine → (N, H).  Over a slice of the experts
    (or of I) it is that slice's share of the sum."""
    ein = torch.einsum("nec,nh->ech", disp, xt)
    return torch.einsum("nec,ech->nh", comb, _expert_ffn(ein, gw, uw, dw))


class MoEMLP(HybridBlock):
    """Sparse SwiGLU feed-forward: each token goes through k of E experts,
    their outputs combined with the (renormalised) router gates.  A
    drop-in for a dense SwiGLU MLP of the same widths
    (``models.llama.LlamaMLP``)."""

    def __init__(self, hidden_size, intermediate_size, num_experts,
                 num_experts_per_tok=2, capacity_factor=1.25,
                 router="topk", **kwargs):
        super().__init__(**kwargs)
        if router not in ("topk", "expert_choice"):
            raise MXNetError(f"unknown MoE router {router!r}")
        if num_experts_per_tok > num_experts:
            raise MXNetError("num_experts_per_tok must be <= num_experts")
        self._h = hidden_size
        self._e = num_experts
        self._k = num_experts_per_tok
        self._cf = capacity_factor
        self._router = router
        with self.name_scope():
            self.router_weight = self.params.get(
                "router_weight", shape=(num_experts, hidden_size))
            self.gate_weight = self.params.get(
                "gate_weight",
                shape=(num_experts, intermediate_size, hidden_size))
            self.up_weight = self.params.get(
                "up_weight",
                shape=(num_experts, intermediate_size, hidden_size))
            self.down_weight = self.params.get(
                "down_weight",
                shape=(num_experts, hidden_size, intermediate_size))

    def _capacity(self, n):
        return capacity(n, self._k, self._cf, self._e)

    def _forward(self, x, rw, gw, uw, dw):
        """Raw tensors → (y (B, T, H), aux)."""
        b, t, h = x.shape
        c = self._capacity(b * t)
        if any_dtensor((x, rw, gw, uw, dw)):
            return self._forward_sharded(x, rw, gw, uw, dw, c)
        xt = x.reshape(b * t, h)
        disp, comb, aux = route(xt, rw, self._e, self._k, c, self._router)
        return experts(xt, disp, comb, gw, uw, dw).reshape(b, t, h), aux

    def _forward_sharded(self, x, rw, gw, uw, dw, c):
        """The ep route: routing over every token of the call on each rank,
        then each rank's experts on its bank slices, summed over the
        group; y comes back in x's layout."""
        e, k, router, h = self._e, self._k, self._router, self._h

        def route_all(xr, rwr):
            return route(xr.reshape(-1, h), rwr, e, k, c, router)

        tokens = (None, None, None)
        disp, comb, aux = sharded_call(
            route_all, [x, rw], [tokens, (None, None)],
            (tokens, tokens, ()), what="moe routing")
        gs = spec_of(gw) if is_dtensor(gw) else (None, None, None)
        ds = spec_of(dw) if is_dtensor(dw) else (None, None, None)
        per_expert = (None, gs[0], None)

        def body(xr, d, cmb, g, u, dn):
            return experts(xr.reshape(-1, h), d, cmb, g, u, dn) \
                .reshape(xr.shape)

        y = sharded_call(body, [x, disp, comb, gw, uw, dw],
                         [tokens, per_expert, per_expert, gs, gs, ds],
                         "sum", what="moe experts")
        if is_dtensor(x):
            y = y.redistribute(x.device_mesh, x.placements)
        return y, aux

    def hybrid_forward(self, F, x, router_weight, gate_weight, up_weight,
                       down_weight):
        y, aux = apply_op(self._forward, x, router_weight, gate_weight,
                          up_weight, down_weight, name="moe_mlp")
        sink = _sink()
        if sink is not None:
            if cuda_graph.capturing():
                raise MXNetError(
                    "collect_aux() cannot cross a hybridize() trace; train "
                    "un-hybridized with the topk router, or use "
                    "router='expert_choice' (no aux loss needed)")
            sink.append(aux)
        return y


def moe_param_specs(block, ep_axis="ep", tp_axis=None):
    """{param: partition spec} of an MoE block, the table ``shard_moe``
    applies: the banks over ``ep_axis`` (and ``tp_axis`` inside each
    expert), the router replicated.  Pass None for an axis the mesh
    lacks."""
    ep, tp = ep_axis, tp_axis
    return {
        block.router_weight: (None, None),
        block.gate_weight: (ep, tp, None),
        block.up_weight: (ep, tp, None),
        block.down_weight: (ep, None, tp),
    }


def shard_moe(block, mesh=None, ep_axis="ep", tp_axis=None):
    """Expert parallelism: split the stacked bank over ``ep_axis``
    (optionally tensor-parallel inside each expert over ``tp_axis``).
    Either axis may be absent from the mesh; with neither the block is
    left as it is."""
    from .. import parallel

    mesh = mesh if mesh is not None else parallel.current_mesh()
    if mesh is None:
        return block
    axes = parallel.mesh_axes(mesh)
    ep = ep_axis if (ep_axis and ep_axis in axes) else None
    tp = tp_axis if (tp_axis and tp_axis in axes) else None
    if ep is None and tp is None:
        return block
    for p, spec in moe_param_specs(block, ep_axis=ep,
                                   tp_axis=tp).items():
        parallel.shard_param(p, spec, mesh)
    return block

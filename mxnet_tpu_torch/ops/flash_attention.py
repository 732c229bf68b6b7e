"""Flash attention: hand-written CUDA kernels for Hopper, forward and
backward.

Counterpart of ``mxnet_tpu/ops/flash_attention.py``.  The TPU package
runs its Pallas kernels (``_fa_kernel`` forward; ``_fa_bwd_dq_kernel`` and
``_fa_bwd_dkv_kernel`` backward) when Tq = Tk and T is a multiple of 128,
and chunked jnp scans otherwise.  Here every CUDA tensor goes to the
kernels, ``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``
(any Tq, Tk; instances at D = 16/32/64/128), and only a CPU tensor takes
the plain PyTorch versions ``_fa_forward_plain`` and
``_fa_backward_plain``.  There is no fallback from one to the other and
no switch between them.  The forward's two are the CUDA and CPU
implementations of one ``torch.library`` custom op
(``mxnet_tpu_torch::flash_attention_fwd``, with a fake implementation for
tracing), so the dispatcher chooses by device and an exported program
holds the op as a node; the backward kernels stay ``ctypes`` launches
(training is not exported).

Any head dim up to 128 runs: the wrappers zero-pad D up to the next
instance (``_padded_head_dim``) on every device and slice O, dQ, dK and
dV back.  That is exact, because the scale is passed explicitly (from
the unpadded D): zero columns add nothing to S = Q·Kᵀ, to δ =
rowsum(dO·O) or to any gradient, and the padded columns of O, dQ, dK
and dV are zero.  D > 128 has no instance on the card (ROADMAP Queue 2,
"D = 256 instance") and raises there; the plain versions take any D.

Each of the three kernels has two designs, chosen here by dtype
(``_design``): bf16 and f16 run on the tensor cores (``mma.sync``; P and
dS are rounded to the input dtype before the products that take them,
which ``round_p=True`` mirrors in the plain versions), f32 on the FMA pipes
in exact f32.

``flash_attention_raw`` is differentiable: a ``torch.autograd.Function``
whose forward saves (q, k, v, O, lse) and whose backward recomputes the
probabilities from lse in the two backward kernels.  Under a dp/tp mesh
it runs them on each rank's local batch and heads.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .. import _kernels, cuda_graph
from .. import autograd as ag
from ..parallel.local import any_dtensor, as_global, is_dtensor, \
    sharded_call

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (16, 32, 64, 128)


def _causal_keep(tq, tk, k0, k1, device):
    """(tq, k1 - k0) bool: key j is visible to query i iff
    j <= i + (tk - tq) — the reference's bottom-right ``tril(k=tk-tq)``."""
    qpos = torch.arange(tq, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    return qpos + (tk - tq) >= kpos


def _sdpa_ref(q, k, v, causal, scale):
    """Dense attention: f32 scores, softmax, P cast to v's dtype before
    the PV product (``attn_mode="sdpa"``).  Fully masked rows give NaN,
    as the reference's dense softmax does."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        s = s.masked_fill(~_causal_keep(tq, tk, 0, tk, s.device),
                          float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _round_to(x, dtype, round_p):
    """``x`` rounded to ``dtype`` and back to f32 when ``round_p``."""
    return x.to(dtype).float() if round_p else x


def _fa_forward_plain(q, k, v, causal, scale, block=512, round_p=False):
    """Plain PyTorch version of the kernel: the reference's
    ``_fa_forward_chunked`` online softmax over k blocks, extended with
    the per-row lse.  Returns (O in q's dtype, lse (B, H, Tq) f32); a
    row that sees no key gets O = 0 and lse = -inf.  ``round_p`` rounds
    P to the input dtype before the PV product, as the tensor-core kernel
    does (the row sums stay f32)."""
    tq, tk = q.shape[-2], k.shape[-2]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros(q.shape[:-1], device=q.device)
    acc = torch.zeros(qf.shape, device=q.device)
    for k0 in range(0, tk, block):
        k1 = min(k0 + block, tk)
        s = torch.matmul(qf, kf[..., k0:k1, :].transpose(-1, -2)) * scale
        if causal:
            s = s.masked_fill(~_causal_keep(tq, tk, k0, k1, q.device),
                              float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe = torch.where(torch.isfinite(m_new), m_new,
                           torch.zeros_like(m_new))
        p = torch.exp(s - safe[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(
            _round_to(p, v.dtype, round_p), vf[..., k0:k1, :])
        m = m_new
    out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    finite = torch.isfinite(m) & (l > 0)
    lse = torch.where(
        finite,
        torch.where(torch.isfinite(m), m, torch.zeros_like(m)) +
        torch.log(l.clamp_min(1e-30)),
        torch.full_like(m, float("-inf")))
    return out, lse


def _fa_backward_plain(q, k, v, o, do, lse, causal, scale, block=512,
                       round_p=False):
    """Plain PyTorch version of the backward kernels: the reference's
    recompute backward (``_fa_backward`` pass 2) over k blocks, with the
    probabilities rebuilt from the forward's saved lse instead of a
    second online-softmax pass, as the kernels do.  f32 arithmetic;
    returns (dq, dk, dv) in q's, k's and v's dtypes.  Rows with
    lse = -inf (they see no key) get dq = 0 and add nothing to dk, dv.
    ``round_p`` rounds P and dS to the input dtype before the dV, dQ and
    dK products, as the tensor-core dQ and dK/dV kernels do."""
    tq, tk = q.shape[-2], k.shape[-2]
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    delta = _delta(o, do)
    seen = torch.isfinite(lse)
    lse_safe = torch.where(seen, lse, torch.zeros_like(lse))
    dq = torch.zeros_like(qf)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for k0 in range(0, tk, block):
        k1 = min(k0 + block, tk)
        kb, vb = kf[..., k0:k1, :], vf[..., k0:k1, :]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        keep = seen[..., None].expand(s.shape)
        if causal:
            keep = keep & _causal_keep(tq, tk, k0, k1, q.device)
        p = torch.where(keep, torch.exp(s - lse_safe[..., None]),
                        torch.zeros_like(s))
        dv[..., k0:k1, :] = torch.matmul(
            _round_to(p, q.dtype, round_p).transpose(-1, -2), gf)
        dp = torch.matmul(gf, vb.transpose(-1, -2))
        ds = _round_to(p * (dp - delta[..., None]) * scale, q.dtype,
                       round_p)
        dq += torch.matmul(ds, kb)
        dk[..., k0:k1, :] = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _padded_head_dim(d):
    """The kernel instance a head dim ``d`` runs at: the smallest of
    ``_HEAD_DIMS`` that is at least ``d``, or ``d`` itself above 128
    (which the kernels refuse; the plain versions take it)."""
    return next((h for h in _HEAD_DIMS if h >= d), d)


def _pad_head(*tensors):
    """``tensors`` with their last dim zero-padded to
    ``_padded_head_dim`` (unchanged when it is an instance already)."""
    d = tensors[0].shape[-1]
    dp = _padded_head_dim(d)
    if dp == d:
        return tensors
    return tuple(torch.nn.functional.pad(t, (0, dp - d)) for t in tensors)


def _check_kernel_operands(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise MXNetError("flash_attention: q, k and v must lie on one CUDA "
                         f"device (got {q.device}, {k.device}, {v.device})")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise MXNetError("flash_attention: q, k and v must share one dtype "
                         f"of float32/float16/bfloat16 (got {q.dtype}, "
                         f"{k.dtype}, {v.dtype})")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape != v.shape or k.shape[:2] != q.shape[:2] or \
            k.shape[3] != q.shape[3]:
        raise MXNetError("flash_attention: expected q (B, H, Tq, D) and k, "
                         f"v (B, H, Tk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[3] not in _HEAD_DIMS:
        raise MXNetError(
            f"flash_attention: head dim {q.shape[3]} has no kernel instance "
            f"(the wrappers pad D up to {_HEAD_DIMS}; D > 128 is ROADMAP.md "
            "Queue 2, \"D = 256 instance\")")
    if not (q.is_contiguous() and k.is_contiguous() and
            v.is_contiguous()):
        raise MXNetError("flash_attention: q, k and v must be contiguous")


def _design(dtype):
    """The kernel design a dtype launches: ``"mma"`` (bf16, f16: the
    tensor cores) or ``"fma"`` (f32: the FMA pipes, exact f32)."""
    return "fma" if dtype == torch.float32 else "mma"


def _check_aligned(*tensors):
    """The tensor-core kernels copy tiles 16 bytes at a time."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise MXNetError("flash_attention: the bf16/f16 kernels need "
                         "16-byte aligned operands (a storage offset that "
                         "is not a multiple of 8 elements)")


def _count(fn, design):
    """One launch of ``fn``'s kernel of ``design``: ``fn.launches`` counts
    every launch, ``fn.launches_mma`` the tensor-core design's (the f32
    FMA design's are the difference)."""
    cuda_graph.count(fn)
    if design == "mma":
        cuda_graph.count(fn, "launches_mma")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Attention forward over (B, H, T, D) tensors → (O, lse).

    One call of the custom op ``torch.ops.mxnet_tpu_torch.
    flash_attention_fwd`` on every route, eager or traced by
    ``torch.export`` (an exported program holds it as a node): a CUDA
    tensor launches the kernel of its dtype's design (``_design``;
    ``flash_attention_fwd.launches`` counts the launches), a CPU tensor
    takes ``_fa_forward_plain``.  D is zero-padded to its instance first
    and O sliced back."""
    scale = _scale(q, scale)
    d0 = q.shape[-1]
    q, k, v = _pad_head(q, k, v)
    out, lse = _fa_fwd_op(q, k, v, bool(causal), scale)
    return out[..., :d0], lse


@torch.library.custom_op("mxnet_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cpu")
def _fa_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, scale: float) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The op's CPU implementation: the plain version."""
    return _fa_forward_plain(q, k, v, causal, scale)


@_fa_fwd_op.register_kernel("cuda")
def _fa_fwd_cuda(q, k, v, causal, scale):
    """The op's CUDA implementation: the kernel of the dtype's design,
    through its C entry point on the current stream."""
    _check_kernel_operands(q, k, v)
    design = _design(q.dtype)
    if design == "mma":
        _check_aligned(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _kernels.load("flash_attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"mxt_flash_attention_fwd_{design}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, tq, tk, d, _DTYPE_CODES[q.dtype],
            int(causal), scale, stream)
    _kernels.check(lib, err, f"flash_attention_fwd ({design}) launch")
    _count(flash_attention_fwd, design)
    return out, lse


@_fa_fwd_op.register_fake
def _fa_fwd_fake(q, k, v, causal, scale):
    """The op's outputs under a trace: O like q, lse (B, H, Tq) f32."""
    return torch.empty_like(q), q.new_empty(q.shape[:3],
                                            dtype=torch.float32)


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_mma = 0


def flash_attention_bwd(q, k, v, o, do, lse, causal=False, scale=None):
    """Attention backward → (dq, dk, dv), from the forward's inputs, its
    output O and per-row lse, and the output gradient dO.

    A CUDA tensor computes δ = rowsum(dO·O) in f32 and launches the dQ
    kernel (``flash_attention_bwd_dq``) and the dK/dV kernel
    (``flash_attention_bwd_dkv``); a CPU tensor takes
    ``_fa_backward_plain``.  D is zero-padded to its instance first and
    dq, dk and dv sliced back."""
    _kernels.refuse_trace("flash_attention_bwd", q, k, v, o, do, lse)
    scale = _scale(q, scale)
    d0 = q.shape[-1]
    q, k, v, o, do = _pad_head(q, k, v, o, do)
    if all(t.device.type == "cpu" for t in (q, k, v, o, do, lse)):
        dq, dk, dv = _fa_backward_plain(q, k, v, o, do, lse, causal, scale)
        return dq[..., :d0], dk[..., :d0], dv[..., :d0]
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device:
        raise MXNetError("flash_attention backward: O must match q "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}; got "
                         f"{tuple(o.shape)} {o.dtype} on {o.device}")
    delta = _delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq[..., :d0], dk[..., :d0], dv[..., :d0]


def _delta(o, do):
    """δ = rowsum(dO·O) in f32, (B, H, Tq): the term both backward kernels
    subtract from dP (the reference computes it outside its kernels)."""
    return (do.float() * o.float()).sum(-1)


def _launch_bwd(symbol, outs, q, k, v, do, lse, delta, causal, scale):
    """Check the operands of a backward kernel and launch ``symbol`` on
    the current stream, writing ``outs``."""
    _check_kernel_operands(q, k, v)
    rows = q.shape[:3]
    if do.shape != q.shape or do.dtype != q.dtype or \
            lse.shape != rows or delta.shape != rows or \
            lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise MXNetError(
            "flash_attention backward: expected dO like q "
            f"{tuple(q.shape)} {q.dtype}, lse and delta float32 {tuple(rows)}"
            f"; got {tuple(do.shape)} {do.dtype}, {tuple(lse.shape)} "
            f"{lse.dtype}, {tuple(delta.shape)} {delta.dtype}")
    if any(t.device != q.device for t in (do, lse, delta)):
        raise MXNetError("flash_attention backward: dO, lse and delta must "
                         f"lie on q's device {q.device}")
    if not (do.is_contiguous() and lse.is_contiguous() and
            delta.is_contiguous()):
        raise MXNetError("flash_attention backward: dO, lse and delta must "
                         "be contiguous")
    if symbol.endswith("_mma"):
        _check_aligned(q, k, v, do)
    b, h, tq, d = q.shape
    lib = _kernels.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, symbol)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            b * h, tq, k.shape[2], d, _DTYPE_CODES[q.dtype],
            int(bool(causal)), scale, stream)
    _kernels.check(lib, err, f"{symbol} launch")


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale):
    """The dQ kernel of the dtype's design on CUDA tensors (δ =
    rowsum(dO·O) given) → dq in q's dtype; ``.launches`` counts its
    launches."""
    design = _design(q.dtype)
    dq = torch.empty_like(q)
    _launch_bwd(f"mxt_flash_attention_bwd_dq_{design}", (dq,), q, k, v, do,
                lse, delta, causal, scale)
    _count(flash_attention_bwd_dq, design)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    """The dK/dV kernel of the dtype's design on CUDA tensors → (dk, dv)
    in k's and v's dtype; ``.launches`` counts its launches."""
    design = _design(q.dtype)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd(f"mxt_flash_attention_bwd_dkv_{design}", (dk, dv), q, k, v,
                do, lse, delta, causal, scale)
    _count(flash_attention_bwd_dkv, design)
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_mma = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_mma = 0


def _scale(q, scale):
    return float(scale) if scale is not None else \
        1.0 / math.sqrt(q.shape[-1])


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, with the two backward kernels as its
    gradient (the reference's ``jax.custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        ag.first_order_only("flash attention (the dQ and dK/dV kernels)")
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_raw(q, k, v, causal=False, scale=None):
    """q (B, H, Tq, D), k/v (B, H, Tk, D) → O (B, H, Tq, D);
    differentiable in q, k and v.

    Under a mesh (DTensor operands) each rank launches the kernels on its
    local batch and heads: batch over ``dp``, heads over ``tp``, the
    sequence whole (the reference's ``_pallas_maybe_sharded``, through
    ``parallel.local.sharded_call``).  On the card a batch or head count
    those axes do not divide raises; on the CPU that axis is computed
    whole on every rank."""
    scale = _scale(q, scale)
    if any_dtensor((q, k, v)):
        mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
        q, k, v = (as_global(t, mesh) for t in (q, k, v))
        spec = ("dp", "tp", None, None)
        return sharded_call(
            lambda a, b, c: _FlashAttention.apply(a, b, c, causal, scale),
            (q, k, v), (spec, spec, spec), spec,
            strict=q.device.type == "cuda", what="flash_attention")
    return _FlashAttention.apply(q, k, v, causal, scale)


def flash_attention(query, key, value, causal=False, scale=None, **kwargs):
    """NDArray-level op over (B, H, T, D) operands: ``flash_attention_raw``
    through ``apply_op`` (the reference's ``flash_attention``)."""
    from .registry import apply_op

    return apply_op(
        lambda q, k, v: flash_attention_raw(q, k, v, causal, scale),
        query, key, value, name="flash_attention")

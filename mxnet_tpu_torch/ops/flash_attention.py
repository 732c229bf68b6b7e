"""Flash attention forward: a hand-written CUDA kernel for Hopper.

Counterpart of ``mxnet_tpu/ops/flash_attention.py``.  The TPU package
runs the Pallas kernel ``_fa_kernel`` when Tq = Tk and T is a multiple of
128 and a chunked jnp scan otherwise; here every CUDA tensor goes to the
kernel ``csrc/flash_attention_fwd.cu`` (any Tq, Tk; D in 16/32/64/128),
and only a CPU tensor takes the plain PyTorch version
``_fa_forward_plain``.  There is no fallback from one to the other and
no switch between them.

No gradient yet: the backward kernels (``_fa_bwd_dq_kernel``,
``_fa_bwd_dkv_kernel``) port with the Llama training slice, and asking
for a gradient through the forward raises.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .. import _kernels

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


def _fa_forward_plain(q, k, v, causal, scale, block=512):
    """Plain PyTorch version of the kernel: the reference's
    ``_fa_forward_chunked`` online softmax over k blocks, extended with
    the per-row lse.  Returns (O in q's dtype, lse (B, H, Tq) f32); a
    row that sees no key gets O = 0 and lse = -inf."""
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
        acc = acc * corr[..., None] + torch.matmul(p, vf[..., k0:k1, :])
        m = m_new
    out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    finite = torch.isfinite(m) & (l > 0)
    lse = torch.where(
        finite,
        torch.where(torch.isfinite(m), m, torch.zeros_like(m)) +
        torch.log(l.clamp_min(1e-30)),
        torch.full_like(m, float("-inf")))
    return out, lse


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
        raise MXNetError(f"flash_attention: head dim {q.shape[3]} not in "
                         f"{_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and
            v.is_contiguous()):
        raise MXNetError("flash_attention: q, k and v must be contiguous")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Attention forward over (B, H, T, D) tensors → (O, lse).

    A CUDA tensor launches the kernel (``flash_attention_fwd.launches``
    counts the launches); a CPU tensor takes ``_fa_forward_plain``."""
    scale = float(scale) if scale is not None else \
        1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        raise MXNetError(
            "flash_attention has no backward yet: the dq/dkv kernels come "
            "with the Llama training slice (ROADMAP.md, slice order item "
            "2); run "
            "inference outside autograd.record()")
    if q.device.type == "cpu" and k.device.type == "cpu" and \
            v.device.type == "cpu":
        return _fa_forward_plain(q, k, v, causal, scale)
    _check_kernel_operands(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _kernels.load("flash_attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, tq, tk, d, _DTYPE_CODES[q.dtype],
            int(bool(causal)), scale, stream)
    _kernels.check(lib, err, "flash_attention_fwd launch")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_raw(q, k, v, causal=False, scale=None):
    """q (B, H, Tq, D), k/v (B, H, Tk, D) → O (B, H, Tq, D)."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]

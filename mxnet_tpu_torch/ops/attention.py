"""Attention ops: ``dot_product_attention`` (and its raw-tensor form
``sdpa_raw``), ``div_sqrt_dim`` and the interleaved self-attention pair
``interleaved_matmul_selfatt_qk`` / ``_valatt``.

Counterpart of ``mxnet_tpu/ops/attention.py`` (reference
``src/operator/contrib/transformer.cc``).  Layout is (B, T, N, H):
batch, sequence, heads, head dim.

Routes of ``sdpa_raw``, by the reference's own rule (its
``sdpa_raw``): the route depends on the shapes, the mask and ``causal``
only, never on the device.

- unmasked, as many key/value heads as query heads, Tq = Tk or not
  causal, and H <= 256: the flash kernels through
  ``flash_attention_raw`` (``ops/flash_attention.py``): q, k and v are
  transposed to (B, N, T, H) and made contiguous first.  On a CUDA
  tensor that launches the hand-written kernels, on a CPU tensor their
  plain versions.  The reference's kernel asks Tq = Tk in every case,
  and a TPU and 128-aligned lengths besides; without ``causal`` the
  kernel and jax.nn compute the same function at any Tq, Tk, so those
  conditions only choose an implementation, and the port drops them.
- anything else: the plain PyTorch route ``_sdpa_plain``, as the
  reference's ``jax.nn.dot_product_attention``: a mask, grouped-query
  heads, D > 256, and causal attention with Tq != Tk, where the flash
  kernels' causal mask (bottom-right, the reference kernel's) and
  jax.nn's (top-left) differ.  It is written as
  ``jax.nn.dot_product_attention``'s XLA path: f32 scores, a masked
  score replaced by the large finite negative -0.7·max(f32) (so a row
  whose keys are all masked attends evenly and returns the mean of V,
  never NaN; the flash kernel would give 0 there, which is why a mask
  never reaches it), softmax in f32, P cast to V's dtype before P·V;
  ``causal`` there is jax.nn's top-left ``tril``.  A mask is boolean
  (True = attend; a 0/1 float mask is read as != 0) and broadcasts to
  (B, N, Tq, Tk).
"""
from __future__ import annotations

import math

import torch

from .flash_attention import flash_attention_raw
from .registry import apply_op, register
from ..base import MXNetError  # noqa: F401
from .registry import make_exporter  # noqa: F401

__all__ = ["sdpa_raw", "dot_product_attention", "div_sqrt_dim",
           "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt"]

# jax.nn's fill for masked scores: finite, so a fully masked row stays
# finite (an even softmax over its keys)
_MASKED = -0.7 * torch.finfo(torch.float32).max


def _sdpa_plain(q, k, v, m, scale, causal):
    """softmax(QKᵀ·scale, masked)·V over (B, T, N, H) tensors, as
    ``jax.nn.dot_product_attention``'s XLA path computes it."""
    n, kv_heads = q.shape[2], k.shape[2]
    if kv_heads != n:  # query head i reads key/value head i // (n / kv)
        k = k.repeat_interleave(n // kv_heads, dim=2)
        v = v.repeat_interleave(n // kv_heads, dim=2)
    logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
    keep = None
    if m is not None:
        keep = m if m.dtype == torch.bool else m != 0
    if causal:
        tq, tk = logits.shape[-2:]
        tril = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril()
        keep = tril if keep is None else keep & tril
    if keep is not None:
        logits = logits.masked_fill(~keep, _MASKED)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnts,bsnh->btnh", probs, v)


def _flash_route(q, k, m, causal):
    """Whether ``sdpa_raw`` takes the flash kernels (module docstring):
    the reference's conditions that decide a result."""
    return m is None and k.shape[2] == q.shape[2] and \
        (q.shape[1] == k.shape[1] or not causal) and q.shape[-1] <= 256


def sdpa_raw(q, k, v, m=None, scale=None, causal=False):
    """Attention over raw (B, T, N, H) tensors: the flash kernels where
    the reference takes its kernel, else the plain route (module
    docstring).  Returns (B, Tq, N, H) in q's dtype."""
    s = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _flash_route(q, k, m, causal):
        out = flash_attention_raw(q.transpose(1, 2).contiguous(),
                                  k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(), causal, s)
        return out.transpose(1, 2)
    return _sdpa_plain(q, k, v, m, s, causal)


def dot_product_attention(query, key, value, mask=None, scale=None,
                          dropout=0.0, causal=False, **kwargs):
    """Fused scaled-dot-product attention (reference
    ``dot_product_attention``).

    query/key/value: (B, T, N, H); mask: optional boolean (True =
    attend), broadcastable to (B, N, Tq, Tk).  ``dropout`` is accepted
    and not applied, as in the reference."""
    def f(*args):
        q, k, v = args[:3]
        m = args[3] if len(args) > 3 else None
        return sdpa_raw(q, k, v, m, scale=scale, causal=causal)

    args = (query, key, value) + ((mask,) if mask is not None else ())
    return apply_op(f, *args, name="dot_product_attention")


def div_sqrt_dim(data, **kwargs):
    """Reference contrib ``_contrib_div_sqrt_dim``: x / sqrt(last dim)."""
    return apply_op(lambda a: a / math.sqrt(a.shape[-1]), data,
                    name="div_sqrt_dim")


def _einsum(spec, a, b, out_dtype):
    """Two-operand einsum: operands of one low-precision dtype stay in it
    (the product accumulates in f32 and is rounded to that dtype, and so
    are the products of its backward); any other pair runs in f32."""
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float16):
        a, b = a.float(), b.float()
    return torch.einsum(spec, a, b).to(out_dtype)


def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1, **kwargs):
    """Reference contrib op: the projected, interleaved QKV (T, B, 3·E)
    → attention scores (B·heads, T, T), with q scaled by 1/sqrt(E/heads)
    first."""
    def f(qkv):
        t, b, e3 = qkv.shape
        h = e3 // 3 // heads
        qkv = qkv.reshape(t, b, heads, 3, h)
        q = qkv[:, :, :, 0] / math.sqrt(h)
        scores = _einsum("tbnh,sbnh->bnts", q, qkv[:, :, :, 1], qkv.dtype)
        return scores.reshape(b * heads, t, t)

    return apply_op(f, queries_keys_values, name="interleaved_selfatt_qk")


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1, **kwargs):
    """Reference contrib op: attention (B·heads, T, T) times the
    interleaved V → (T, B, E).  A caller's f32 probabilities with bf16
    values run in f32 (the probabilities are not rounded)."""
    def f(qkv, att):
        t, b, e3 = qkv.shape
        e = e3 // 3
        v = qkv.reshape(t, b, heads, 3, e // heads)[:, :, :, 2]
        out = _einsum("bnts,sbnh->tbnh", att.reshape(b, heads, t, t), v,
                      qkv.dtype)
        return out.reshape(t, b, e)

    return apply_op(f, queries_keys_values, attention,
                    name="interleaved_selfatt_valatt")

for _name in ("div_sqrt_dim", "interleaved_matmul_selfatt_qk",
              "interleaved_matmul_selfatt_valatt"):
    register(_name, globals()[_name], ("_contrib_" + _name,))
register("dot_product_attention", dot_product_attention)

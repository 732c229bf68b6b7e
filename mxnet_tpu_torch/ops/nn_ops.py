"""Neural-network ops: ``log_softmax`` and ``softmax_cross_entropy``.

Counterpart of ``mxnet_tpu/ops/nn_ops.py``, as far as the Llama training
slice needs; the rest ports with the op library (ROADMAP Queue 1
item 1).  ``softmax_cross_entropy`` keeps the reference's contract: f32
math inside whatever the logits' dtype, the **sum** over rows as the
result, and a backward written directly in the logits' dtype (bf16
logits give a bf16 gradient, never an f32 copy of the logits).
"""
from __future__ import annotations

import torch

from .registry import apply_op

__all__ = ["log_softmax", "softmax_cross_entropy"]


def log_softmax(data, axis=-1, temperature=None, **kwargs):
    """Reference ``log_softmax`` along ``axis`` with optional
    ``temperature``."""
    t = temperature

    def f(a):
        x = a / t if t and t != 1.0 else a
        return torch.log_softmax(x, dim=axis)

    return apply_op(f, data, name="log_softmax")


class _SoftmaxCESum(torch.autograd.Function):
    """sum over rows of -log_softmax(x)[label] (the reference's
    ``_softmax_ce_sum``): f32 log-sum-exp per row; the backward rebuilds
    the softmax from the saved lse and writes dx in x's dtype."""

    @staticmethod
    def forward(ctx, x, label):
        lse = torch.logsumexp(x.float(), dim=-1)
        picked = torch.gather(x, -1, label[..., None])[..., 0].float()
        ctx.save_for_backward(x, lse, label)
        return (lse - picked).sum()

    @staticmethod
    def backward(ctx, g):
        x, lse, label = ctx.saved_tensors
        p = x.to(torch.float32, copy=True)  # one f32 buffer, in place
        p.sub_(lse[..., None]).exp_()
        p.scatter_add_(-1, label[..., None],
                       torch.full_like(lse[..., None], -1.0))
        return p.mul_(g).to(x.dtype), None


def softmax_cross_entropy(data, label, **kwargs):
    """Reference ``softmax_cross_entropy``: fused logits + label cross
    entropy, summed over all rows."""
    return apply_op(lambda x, lab: _SoftmaxCESum.apply(x, lab.long()),
                    data, label, name="softmax_cross_entropy")

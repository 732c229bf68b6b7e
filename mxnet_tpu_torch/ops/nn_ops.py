"""Neural-network ops: activations (``activation``, ``leaky_relu``),
``fully_connected``, ``convolution``, ``pooling``, ``batch_norm``,
``layer_norm``, ``dropout``, ``flatten``, ``softmax``, ``log_softmax``
and ``softmax_cross_entropy``.

Counterpart of ``mxnet_tpu/ops/nn_ops.py``, as far as the Llama, ResNet
and BERT slices need; the rest ports with the op library (ROADMAP Queue
1 item 1).  Three dtype contracts are kept:

- ``softmax_cross_entropy``: f32 math inside whatever the logits' dtype,
  the **sum** over rows as the result, and a backward written directly in
  the logits' dtype (bf16 logits give a bf16 gradient, never an f32 copy
  of the logits);
- ``batch_norm`` in training (the reference's ``_bn_train``): statistics
  in f32, y and dx in the input's dtype, dgamma and dbeta in the
  parameters';
- ``layer_norm`` (the reference's ``_ln_train``): the same, over the
  normalized axis.

``dropout`` draws its mask from the package's generator of the tensor's
device (``random.generator``), never from torch's global one, so a CUDA
graph that registered that generator draws fresh masks on every replay.

Convolutions go to ``torch.nn.functional.conv{1,2,3}d`` and products to
``torch.matmul``, as the JAX package leaves them to XLA outside any
Pallas kernel (bf16 operands accumulate in f32 in both).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tnf

from ..base import MXNetError
from .registry import apply_op

__all__ = ["activation", "relu", "leaky_relu", "fully_connected",
           "convolution", "pooling", "batch_norm", "layer_norm", "dropout",
           "flatten", "softmax", "log_softmax", "softmax_cross_entropy"]

_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
}


def activation(data, act_type="relu", **kwargs):
    """Reference ``Activation``: the ``act_type`` nonlinearity,
    elementwise."""
    if act_type not in _ACTS:
        raise MXNetError(f"unknown act_type {act_type!r}")
    return apply_op(_ACTS[act_type], data, name=f"activation_{act_type}")


def relu(data):
    return apply_op(torch.relu, data, name="relu")


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, **kwargs):
    """Reference ``LeakyReLU`` op: leaky/prelu/elu/selu/gelu (``gelu``
    is the erf form, torch's ``approximate="none"``)."""
    if act_type == "leaky":
        return apply_op(lambda a: torch.where(a > 0, a, slope * a), data,
                        name="leaky_relu")
    if act_type == "prelu":
        return apply_op(lambda a, g: torch.where(a > 0, a, g * a), data,
                        gamma, name="prelu")
    if act_type == "elu":
        return apply_op(
            lambda a: torch.where(a > 0, a, slope * (torch.exp(a) - 1)), data,
            name="elu")
    if act_type == "selu":
        return apply_op(
            lambda a: _SELU_SCALE * torch.where(
                a > 0, a, _SELU_ALPHA * (torch.exp(a) - 1)), data, name="selu")
    if act_type == "gelu":
        return apply_op(lambda a: tnf.gelu(a, approximate="none"), data,
                        name="gelu")
    raise MXNetError(f"unknown LeakyReLU act_type {act_type!r}")


def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True, **kwargs):
    """Reference ``FullyConnected``: y = x·Wᵀ + b, weight stored (out, in);
    ``flatten`` first folds every axis after the first into one."""
    def f(x, w, *b):
        if flatten:
            x = x.reshape(x.shape[0], -1)
        y = torch.matmul(x, w.t())
        return y + b[0] if b else y

    args = (data, weight) if (no_bias or bias is None) else \
        (data, weight, bias)
    return apply_op(f, *args, name="fully_connected")


def _tup(v, n, name):
    if v is None:
        return (0,) * n if name == "pad" else (1,) * n
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    if len(v) != n:
        raise MXNetError(f"{name} must have {n} elements, got {v}")
    return v


_CONV = {1: tnf.conv1d, 2: tnf.conv2d, 3: tnf.conv3d}


def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None, **kwargs):
    """Reference ``Convolution`` (1D/2D/3D, NCW/NCHW/NCDHW, grouped);
    weight (num_filter, C/num_group, *kernel)."""
    nsp = len(kernel) if kernel is not None else data.ndim - 2
    if nsp not in _CONV or (layout is not None and
                            not str(layout).startswith("NC")):
        raise MXNetError(f"convolution: {nsp} spatial dims in layout "
                         f"{layout!r}; NCW/NCHW/NCDHW are ported")
    conv = _CONV[nsp]
    strides = _tup(stride, nsp, "stride")
    dil = _tup(dilate, nsp, "dilate")
    padding = _tup(pad, nsp, "pad")

    def f(x, w, *b):
        return conv(x, w, b[0] if b else None, strides, padding, dil,
                    num_group)

    args = (data, weight) if (no_bias or bias is None) else \
        (data, weight, bias)
    return apply_op(f, *args, name="convolution")


_AVG_POOL = {1: tnf.avg_pool1d, 2: tnf.avg_pool2d, 3: tnf.avg_pool3d}
_MAX_POOL = {1: tnf.max_pool1d, 2: tnf.max_pool2d, 3: tnf.max_pool3d}


def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, **kwargs):
    """Reference ``Pooling`` (max/avg; NCW/NCHW/NCDHW).

    The padding is explicit, as the reference's ``reduce_window`` has it:
    −inf for max, 0 for avg, and for ``pooling_convention="full"``
    extra padding at the upper edge so that the last window fits (ceil
    instead of floor).  ``count_include_pad=False`` divides each window's
    sum by the number of input elements it covers."""
    nsp = data.ndim - 2
    if pool_type not in ("max", "avg"):
        raise MXNetError(f"pooling: pool_type {pool_type!r} is not ported "
                         "yet (ROADMAP.md, Queue 1 item 1)")
    if global_pool:
        ax = tuple(range(2, 2 + nsp))

        def g(a):
            if pool_type == "max":
                return a.amax(dim=ax, keepdim=True)
            return a.mean(dim=ax, keepdim=True)

        return apply_op(g, data, name="global_pool")
    if nsp not in _AVG_POOL:
        raise MXNetError(f"pooling: {nsp} spatial dims; 1 to 3 are ported")
    k = _tup(kernel, nsp, "kernel")
    s = _tup(stride, nsp, "stride")
    p = _tup(pad, nsp, "pad")
    extra = [0] * nsp
    if pooling_convention == "full":
        for i in range(nsp):
            rem = (data.shape[2 + i] + 2 * p[i] - k[i]) % s[i]
            extra[i] = 0 if rem == 0 else s[i] - rem
    # torch's pad order: last dim first, (low, high) each
    widths = [w for i in reversed(range(nsp)) for w in (p[i], p[i] + extra[i])]

    def f(a):
        if pool_type == "max":
            padded = tnf.pad(a, widths, value=float("-inf"))
            return _MAX_POOL[nsp](padded, k, s)
        mean = _AVG_POOL[nsp](tnf.pad(a, widths), k, s)
        if count_include_pad:
            return mean
        share = _AVG_POOL[nsp](tnf.pad(torch.ones_like(a), widths), k, s)
        return mean / share

    return apply_op(f, data, name="pooling")


def flatten(data, **kwargs):
    """Reference ``Flatten``: keep axis 0, fold the rest into one."""
    n = data.shape[0] if data.ndim > 0 else 1
    return apply_op(lambda a: a.reshape(n, -1), data, name="flatten")


class _BNTrain(torch.autograd.Function):
    """Training batch norm (the reference's ``_bn_train``): statistics in
    f32, y in x's dtype; the backward is written out with f32 only inside
    the per-channel reductions, dx in x's dtype and dgamma, dbeta in the
    parameters' dtypes.  Also returns the batch mean and (population)
    variance, which carry no gradient."""

    @staticmethod
    def forward(ctx, x, g, b, eps, red, shape):
        xf = x.float()
        mean = xf.mean(dim=red)
        var = xf.var(dim=red, unbiased=False)
        inv = torch.rsqrt(var + eps)
        y = ((xf - mean.reshape(shape)) * inv.reshape(shape) *
             g.float().reshape(shape) + b.float().reshape(shape)).to(x.dtype)
        ctx.save_for_backward(x, g, mean, inv)
        ctx.red, ctx.shape, ctx.b_dtype = red, shape, b.dtype
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, g, mean, inv = ctx.saved_tensors
        red, shape = ctx.red, ctx.shape
        m = math.prod(x.shape[i] for i in red)
        xhat = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        dyf = dy.float()
        dbeta = dyf.sum(dim=red)
        dgamma = (dyf * xhat).sum(dim=red)
        gi = (g.float() * inv).reshape(shape)
        dx = gi * (dyf - (dbeta / m).reshape(shape) -
                   xhat * (dgamma / m).reshape(shape))
        return (dx.to(x.dtype), dgamma.to(g.dtype), dbeta.to(ctx.b_dtype),
                None, None, None)


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1, **kwargs):
    """Reference ``BatchNorm``: returns (out, new_moving_mean,
    new_moving_var); the Gluon layer commits the moving statistics.

    Training (``autograd.is_training()`` and not ``use_global_stats``)
    normalizes by the batch statistics (``_BNTrain``) and moves the
    moving ones as ``momentum·old + (1 − momentum)·batch``, with the
    population variance (not torch's unbiased running update).  Otherwise
    it normalizes by the moving statistics in f32 and casts back to the
    input's dtype."""
    from .. import autograd as ag

    training = ag.is_training() and not use_global_stats

    def f(x, g, b, mmean, mvar):
        ax = axis % x.ndim
        red = tuple(i for i in range(x.ndim) if i != ax)
        shape = tuple(x.shape[i] if i == ax else 1 for i in range(x.ndim))
        g_ = torch.ones_like(g) if fix_gamma else g
        if training:
            y, mean, var = _BNTrain.apply(x, g_, b, float(eps), red, shape)
            with torch.no_grad():
                new_mean = momentum * mmean + (1 - momentum) * mean
                new_var = momentum * mvar + (1 - momentum) * var
            return y, new_mean, new_var
        xf = x.float()
        inv = torch.rsqrt(mvar.float() + eps)
        y = (xf - mmean.float().reshape(shape)) * inv.reshape(shape)
        y = y * g_.float().reshape(shape) + b.float().reshape(shape)
        return y.to(x.dtype), mmean, mvar

    return apply_op(f, data, gamma, beta, moving_mean, moving_var,
                    name="batch_norm")


class _LNTrain(torch.autograd.Function):
    """Layer norm over axis ``ax`` (the reference's ``_ln_train``):
    statistics in f32, y in x's dtype; the backward is written out with
    f32 only inside the reductions, dx in x's dtype and dgamma, dbeta in
    the parameters' dtypes."""

    @staticmethod
    def forward(ctx, x, g, b, eps, ax, shape):
        xf = x.float()
        mean = xf.mean(dim=ax, keepdim=True)
        var = xf.var(dim=ax, unbiased=False, keepdim=True)
        inv = torch.rsqrt(var + eps)
        y = ((xf - mean) * inv * g.float().reshape(shape) +
             b.float().reshape(shape)).to(x.dtype)
        ctx.save_for_backward(x, g, mean, inv)
        ctx.ax, ctx.shape, ctx.b_dtype = ax, shape, b.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, mean, inv = ctx.saved_tensors
        ax, shape = ctx.ax, ctx.shape
        xhat = (x.float() - mean) * inv
        dyf = dy.float()
        other = tuple(i for i in range(x.ndim) if i != ax)
        dbeta = dyf.sum(dim=other)
        dgamma = (dyf * xhat).sum(dim=other)
        dyg = dyf * g.float().reshape(shape)
        dx = inv * (dyg - dyg.mean(dim=ax, keepdim=True) -
                    xhat * (dyg * xhat).mean(dim=ax, keepdim=True))
        return (dx.to(x.dtype), dgamma.to(g.dtype), dbeta.to(ctx.b_dtype),
                None, None, None)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, **kwargs):
    """Reference ``LayerNorm``: statistics in f32, tensors in the input's
    dtype forward and backward (``_LNTrain``)."""
    def f(x, g, b):
        ax = axis % x.ndim
        shape = tuple(x.shape[i] if i == ax else 1 for i in range(x.ndim))
        return _LNTrain.apply(x, g, b, float(eps), ax, shape)

    return apply_op(f, data, gamma, beta, name="layer_norm")


def dropout(data, p=0.5, mode="training", axes=(), **kwargs):
    """Reference ``Dropout``: in training (or ``mode="always"``) each
    element is kept with probability 1 - p and scaled by 1/(1 - p), the
    rest are 0; ``axes`` share one draw along those axes.  Otherwise
    the identity.  The mask is drawn from ``random.generator`` of the
    tensor's device."""
    from .. import autograd as ag
    from .. import random as mx_random

    if not (ag.is_training() or mode == "always") or p <= 0:
        return apply_op(lambda a: a, data, name="dropout_identity")

    def f(a):
        shape = tuple(1 if i in axes else s for i, s in enumerate(a.shape))
        u = torch.rand(shape, generator=mx_random.generator(a.device),
                       device=a.device)
        return torch.where(u < 1.0 - p, a / (1.0 - p),
                           torch.zeros((), dtype=a.dtype, device=a.device))

    return apply_op(f, data, name="dropout")


def softmax(data, axis=-1, temperature=None, **kwargs):
    """Reference ``softmax`` along ``axis`` with optional
    ``temperature``."""
    t = temperature

    def f(a):
        x = a / t if t and t != 1.0 else a
        return torch.softmax(x, dim=axis)

    return apply_op(f, data, name="softmax")


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

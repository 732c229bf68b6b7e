"""Neural-network ops: activations (``activation``, ``leaky_relu``,
``hard_sigmoid``), ``fully_connected``, ``convolution``,
``deconvolution``, ``upsampling``, ``pooling``, the norms (``batch_norm``,
``layer_norm``, ``group_norm``, ``instance_norm``, ``l2_normalization``),
``dropout``, ``embedding``, ``flatten``, ``softmax``, ``log_softmax``,
``softmax_cross_entropy``, ``ctc_loss`` and the low-precision products
``mxu_matmul_nt``/``mxu_batch_matmul``.

Counterpart of ``mxnet_tpu/ops/nn_ops.py``, with ``ctc_loss`` (since
slice 14).  Four dtype contracts are kept:

- ``softmax_cross_entropy``: f32 math inside whatever the logits' dtype,
  the **sum** over rows as the result, and a backward written directly in
  the logits' dtype (bf16 logits give a bf16 gradient, never an f32 copy
  of the logits);
- ``batch_norm`` in training (the reference's ``_bn_train``): statistics
  in f32, y and dx in the input's dtype, dgamma and dbeta in the
  parameters';
- ``layer_norm`` (the reference's ``_ln_train``): the same, over the
  normalized axis; ``group_norm`` and ``instance_norm`` standardize the
  same way (``_Standardize``) and apply their affine in f32;
- ``mxu_matmul_nt``/``mxu_batch_matmul`` (the reference's
  ``_mxu_matmul`` contract): bf16/f16 operands, f32 accumulation, the
  product and both gradients in the operands' dtype.

``dropout`` draws its mask from the package's generator of the tensor's
device (``random.generator``), never from torch's global one, so a CUDA
graph that registered that generator draws fresh masks on every replay.

Convolutions go to ``torch.nn.functional.conv{1,2,3}d`` and products to
``torch.matmul``, as the JAX package leaves them to XLA outside any
Pallas kernel (bf16 operands accumulate in f32 in both).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tnf

from ..base import MXNetError
from .. import autograd as ag
from .registry import apply_op, register
from .registry import accum_dtype, make_exporter  # noqa: F401

__all__ = ["activation", "leaky_relu", "hard_sigmoid", "fully_connected",
           "convolution", "deconvolution", "upsampling", "pooling",
           "batch_norm", "layer_norm", "group_norm", "instance_norm",
           "l2_normalization", "dropout", "embedding", "flatten", "softmax",
           "log_softmax", "softmax_cross_entropy", "ctc_loss",
           "mxu_matmul_nt", "mxu_batch_matmul",
           "Activation", "LeakyReLU", "FullyConnected", "Convolution",
           "Deconvolution", "UpSampling", "Pooling", "BatchNorm",
           "LayerNorm", "GroupNorm", "InstanceNorm", "L2Normalization",
           "Dropout", "Embedding", "Flatten", "CTCLoss"]

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


def hard_sigmoid(data, alpha=0.2, beta=0.5, **kwargs):
    """Reference ``hard_sigmoid``: ``clip(alpha·x + beta, 0, 1)``."""
    return apply_op(lambda a: torch.clamp(alpha * a + beta, 0, 1), data,
                    name="hard_sigmoid")


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
    """Reference ``Pooling`` (max/avg/sum/lp; NCW/NCHW/NCDHW).

    The padding is explicit, as the reference's ``reduce_window`` has it:
    −inf for max, 0 for avg, and for ``pooling_convention="full"``
    extra padding at the upper edge so that the last window fits (ceil
    instead of floor).  ``count_include_pad=False`` divides each window's
    sum by the number of input elements it covers.  ``"sum"`` is the
    window's sum; ``"lp"`` takes the average's path, as the reference's
    does."""
    nsp = data.ndim - 2
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"pooling: unknown pool_type {pool_type!r}")
    if global_pool:
        ax = tuple(range(2, 2 + nsp))

        def g(a):
            if pool_type == "max":
                return a.amax(dim=ax, keepdim=True)
            if pool_type == "sum":
                return a.sum(dim=ax, keepdim=True)
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
        if pool_type == "sum":
            return mean * math.prod(k)
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
        ag.first_order_only("BatchNorm")
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


class _SyncBNTrain(torch.autograd.Function):
    """Training batch norm over the batch of every rank of ``group``
    (the reference's ``_SyncBNCrossProcess``): the forward all-reduces
    the per-channel (Σx, Σx², count), the backward (Σdy, Σdy·x̂), so the
    statistics and dx are the global batch's.  The population variance
    (clamped at 0 against f32 cancellation) as ``_BNTrain``; dgamma and
    dbeta stay this rank's sums (parameter gradients, which the store
    all-reduces)."""

    @staticmethod
    def forward(ctx, x, g, b, eps, red, shape, group):
        xf = x.float()
        c = xf.shape[[i for i in range(x.dim()) if i not in red][0]]
        count = float(math.prod(x.shape[i] for i in red))
        sums = torch.cat([xf.sum(dim=red), (xf * xf).sum(dim=red),
                          torch.full((1,), count, device=x.device)])
        _all_reduce(sums, group)
        n = float(sums[2 * c])
        mean = sums[:c] / n
        var = (sums[c:2 * c] / n - mean * mean).clamp_min(0.0)
        inv = torch.rsqrt(var + eps)
        y = ((xf - mean.reshape(shape)) * inv.reshape(shape) *
             g.float().reshape(shape) + b.float().reshape(shape)).to(x.dtype)
        ctx.save_for_backward(x, g, mean, inv)
        ctx.red, ctx.shape, ctx.b_dtype = red, shape, b.dtype
        ctx.group, ctx.count = group, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        ag.first_order_only("SyncBatchNorm")
        x, g, mean, inv = ctx.saved_tensors
        red, shape = ctx.red, ctx.shape
        xhat = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        dyf = dy.float()
        dbeta = dyf.sum(dim=red)
        dgamma = (dyf * xhat).sum(dim=red)
        tot = torch.cat([dbeta, dgamma])
        _all_reduce(tot, ctx.group)
        c = dbeta.shape[0]
        gi = (g.float() * inv).reshape(shape)
        dx = gi * (dyf - (tot[:c] / ctx.count).reshape(shape) -
                   xhat * (tot[c:] / ctx.count).reshape(shape))
        return (dx.to(x.dtype), dgamma.to(g.dtype), dbeta.to(ctx.b_dtype),
                None, None, None, None)


def _all_reduce(t, group):
    """Sum ``t`` in place over ``group`` (the identity without a process
    group)."""
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        torch.distributed.all_reduce(t, group=group)


def sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
                    momentum=0.9, fix_gamma=False, axis=1, group=None):
    """Training batch norm whose statistics cover every rank's batch
    (``nn.SyncBatchNorm``'s op): (out, new_moving_mean, new_moving_var)
    as ``batch_norm``.  Plain tensors are each rank's own batch, summed
    over ``group`` (default: the whole process group); over a mesh each
    rank takes its ``dp`` rows and the sums run over the ``dp`` axis."""
    from ..parallel.local import is_dtensor, sharded_call

    def f(x, g, b, mmean, mvar):
        ax = axis % x.ndim
        red = tuple(i for i in range(x.ndim) if i != ax)
        shape = tuple(x.shape[i] if i == ax else 1 for i in range(x.ndim))
        g_ = torch.ones_like(g) if fix_gamma else g
        grp = group
        spec = ("dp",) + (None,) * (x.ndim - 1)
        if is_dtensor(x) and "dp" in x.device_mesh.mesh_dim_names:
            grp = x.device_mesh.get_group("dp")
        y, mean, var = sharded_call(
            lambda xl, gl, bl: _SyncBNTrain.apply(xl, gl, bl, float(eps),
                                                  red, shape, grp),
            (x, g_, b), (spec, (None,), (None,)),
            (spec, (None,), (None,)), what="SyncBatchNorm")
        with torch.no_grad():
            new_mean = momentum * mmean + (1 - momentum) * mean
            new_var = momentum * mvar + (1 - momentum) * var
        return y, new_mean, new_var

    return apply_op(f, data, gamma, beta, moving_mean, moving_var,
                    name="sync_batch_norm")


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
        ag.first_order_only("LayerNorm")
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
        ag.first_order_only("softmax_cross_entropy")
        x, lse, label = ctx.saved_tensors
        p = x.to(torch.float32, copy=True)  # one f32 buffer, in place
        p.sub_(lse[..., None]).exp_()
        p.scatter_add_(-1, label[..., None],
                       torch.full_like(lse[..., None], -1.0))
        return p.mul_(g).to(x.dtype), None


def softmax_cross_entropy(data, label, **kwargs):
    """Reference ``softmax_cross_entropy``: fused logits + label cross
    entropy, summed over all rows.  Under a mesh each rank sums its
    ``dp`` rows over the whole vocabulary (``Partial`` over ``dp``)."""
    from ..parallel.local import sharded_call

    def f(x, lab):
        return sharded_call(
            lambda a, b: _SoftmaxCESum.apply(a, b.long()), (x, lab),
            (("dp", None), ("dp",)), "sum", what="softmax_cross_entropy")

    return apply_op(f, data, label, name="softmax_cross_entropy")


_DECONV = {1: tnf.conv_transpose1d, 2: tnf.conv_transpose2d,
           3: tnf.conv_transpose3d}


def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=True, layout=None, target_shape=None,
                  **kwargs):
    """Reference ``Deconvolution`` (the transposed convolution, the
    convolution's data gradient): weight (C_in, num_filter/num_group,
    *kernel); ``adj`` adds to the upper edge of the output."""
    nsp = len(kernel)
    if nsp not in _DECONV:
        raise MXNetError(f"deconvolution: {nsp} spatial dims; 1 to 3 are "
                         "ported")
    strides = _tup(stride, nsp, "stride")
    dil = _tup(dilate, nsp, "dilate")
    pads = _tup(pad, nsp, "pad")
    adjs = _tup(adj, nsp, "adj") if adj is not None else (0,) * nsp

    def f(x, w, *b):
        return _DECONV[nsp](x, w, b[0] if b else None, strides, pads, adjs,
                            num_group, dil)

    args = (data, weight) if (no_bias or bias is None) else \
        (data, weight, bias)
    return apply_op(f, *args, name="deconvolution")


def upsampling(*data, scale=2, sample_type="nearest", num_args=1,
               num_filter=0, **kwargs):
    """Reference ``UpSampling``: NCHW nearest (each pixel repeated) or
    bilinear (half-pixel centres, edges clamped) by an integer ``scale``;
    a bilinear weight operand is accepted and not used, as in the
    reference."""
    scale = int(scale)

    def f(x):
        if sample_type == "nearest":
            return x.repeat_interleave(scale, dim=2).repeat_interleave(
                scale, dim=3)
        return tnf.interpolate(x, scale_factor=scale, mode="bilinear",
                               align_corners=False)

    return apply_op(f, data[0], name="upsampling")


class _Standardize(torch.autograd.Function):
    """(x − mean) / sqrt(var + eps) over the ``red`` axes (the
    reference's ``_standardize``): statistics in f32, y and dx in x's
    dtype."""

    @staticmethod
    def forward(ctx, x, eps, red):
        xf = x.float()
        mean = xf.mean(dim=red, keepdim=True)
        inv = torch.rsqrt(xf.var(dim=red, unbiased=False, keepdim=True) + eps)
        ctx.save_for_backward(x, mean, inv)
        ctx.red = red
        return ((xf - mean) * inv).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        ag.first_order_only("InstanceNorm/GroupNorm")
        x, mean, inv = ctx.saved_tensors
        red = ctx.red
        xhat = (x.float() - mean) * inv
        dyf = dy.float()
        dx = inv * (dyf - dyf.mean(dim=red, keepdim=True) -
                    xhat * (dyf * xhat).mean(dim=red, keepdim=True))
        return dx.to(x.dtype), None, None


def _affine(y, g, b, x):
    """y·gamma + beta per channel (axis 1), in f32, back in x's dtype."""
    shape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
    return (y.float() * g.float().reshape(shape) +
            b.float().reshape(shape)).to(x.dtype)


def group_norm(data, gamma, beta, num_groups=1, eps=1e-5, **kwargs):
    """Reference ``GroupNorm``: standardized over each group of channels
    (and the spatial axes), then gamma and beta per channel."""
    def f(x, g, b):
        n, c = x.shape[0], x.shape[1]
        xr = x.reshape((n, num_groups, c // num_groups) + x.shape[2:])
        y = _Standardize.apply(xr, float(eps),
                               tuple(range(2, xr.ndim))).reshape(x.shape)
        return _affine(y, g, b, x)

    return apply_op(f, data, gamma, beta, name="group_norm")


def instance_norm(data, gamma, beta, eps=1e-5, **kwargs):
    """Reference ``InstanceNorm``: each sample's channel standardized over
    the spatial axes, then gamma and beta per channel."""
    def f(x, g, b):
        y = _Standardize.apply(x, float(eps), tuple(range(2, x.ndim)))
        return _affine(y, g, b, x)

    return apply_op(f, data, gamma, beta, name="instance_norm")


def l2_normalization(data, eps=1e-10, mode="instance", **kwargs):
    """Reference ``L2Normalization``: x / sqrt(Σx² + eps) over every axis
    but the batch (``instance``), the channel axis (``channel``) or the
    spatial axes (``spatial``)."""
    def f(x):
        if mode == "instance":
            red = tuple(range(1, x.ndim))
        elif mode == "channel":
            red = (1,)
        else:
            red = tuple(range(2, x.ndim))
        return x / torch.sqrt(torch.square(x).sum(dim=red, keepdim=True) +
                              eps)

    return apply_op(f, data, name="l2_normalization")


def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False, matmul_lookup=False, **kwargs):
    """Reference ``Embedding``: rows of ``weight`` gathered by integer ids
    (clipped into range); ``matmul_lookup`` computes the same rows as
    ``one_hot(ids) @ weight`` through ``mxu_matmul_nt``.  Over a mesh, a
    replicated table is read on each rank's local ids (``sharded_call``:
    its gradient is each rank's share, a partial sum over the axes that
    shard the ids), where ``DTensor``'s own propagation of the lookup's
    backward (``index_put`` with sharded ids) fails on torch 2.11."""
    from ..parallel.local import is_dtensor, sharded_call, spec_of

    def lookup(idx, w):
        ii = idx.long().clamp(0, w.shape[0] - 1)
        if matmul_lookup:
            oh = (ii.unsqueeze(-1) == torch.arange(
                w.shape[0], device=w.device)).to(w.dtype)
            return _MxuMatmulNT.apply(oh, w)
        return w[ii]

    def f(idx, w):
        if is_dtensor(w) and all(p.is_replicate() for p in w.placements):
            spec = spec_of(idx)
            return sharded_call(lookup, (idx, w), (spec, (None,) * w.ndim),
                                spec + (None,), what="embedding")
        return lookup(idx, w)

    return apply_op(f, data, weight, name="embedding")


def _unbroadcast(d, shape):
    """Sum a gradient over the axes its operand was broadcast along."""
    if tuple(d.shape) == tuple(shape):
        return d
    extra = d.ndim - len(shape)
    if extra > 0:
        d = d.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, (ds, s) in enumerate(zip(d.shape, shape))
                 if ds != s)
    return d.sum(dim=axes, keepdim=True) if axes else d


class _MxuMatmulNT(torch.autograd.Function):
    """x (..., K) @ w (K, N): f32 accumulation, the product and both
    gradients in the operands' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = torch.matmul(g, w.t())
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                          g.reshape(-1, g.shape[-1]))
        return dx, dw.to(w.dtype)


class _MxuBatchMatmul(torch.autograd.Function):
    """(..., M, K) @ (..., K, N) with the same contract, batch axes
    broadcast."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = torch.matmul(g, b.transpose(-1, -2))
        db = torch.matmul(a.transpose(-1, -2), g)
        return (_unbroadcast(da, a.shape),
                _unbroadcast(db, b.shape).to(b.dtype))


def mxu_matmul_nt(x, w):
    """y = x·w on raw tensors, w stored (K, N): f32 accumulation with the
    product and the gradients in the operands' dtype (the reference's
    ``mxu_matmul_nt``)."""
    return _MxuMatmulNT.apply(x, w)


def mxu_batch_matmul(a, b):
    """Batched (..., M, K) @ (..., K, N) on raw tensors under the same
    contract (the reference's ``mxu_batch_matmul``)."""
    return _MxuBatchMatmul.apply(a, b)


def _capturing():
    """True while the current CUDA stream is being captured into a
    graph (host reads are refused there)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=None, use_label_lengths=None,
             blank_label="first", **kwargs):
    """Connectionist temporal classification loss (reference
    ``src/operator/nn/ctc_loss.cc``, ``CTCLoss``).

    ``data``: (T, N, C) unnormalized activations (log-softmax over C
    inside); ``label``: (N, L) class indices.  ``blank_label='first'``:
    class 0 is blank, labels 1..C-1, rows padded with 0 when
    ``label_lengths`` is absent; ``'last'``: class C-1 is blank, labels
    0..C-2, padding -1.  Returns each sequence's negative log
    likelihood, shape (N,), in float32 (float64 for float64 data).

    The reference's lattice as torch ops: a loop over time on the
    (N, 2L+1) alpha lattice in log space, −1e30 standing for −inf (so an
    infeasible label gives a loss near 1e30, not ``inf``), gradients by
    autograd through the loop.  ``torch.nn.functional.ctc_loss`` is not
    the route.  The label and length checks read those small arrays on
    the host, except while a CUDA graph captures (as the reference skips
    them under tracing)."""
    if blank_label not in ("first", "last"):
        raise MXNetError(f"bad blank_label {blank_label!r}")
    blank_first = blank_label == "first"
    # a symbol-style call passes the one length array positionally with
    # only ``use_label_lengths`` set: it is the label lengths
    if use_label_lengths and label_lengths is None and \
            data_lengths is not None and not use_data_lengths:
        label_lengths, data_lengths = data_lengths, None
    if use_data_lengths is None:
        use_data_lengths = data_lengths is not None
    if use_label_lengths is None:
        use_label_lengths = label_lengths is not None
    if use_data_lengths and data_lengths is None:
        raise MXNetError("use_data_lengths=True but no data_lengths given")
    if use_label_lengths and label_lengths is None:
        raise MXNetError("use_label_lengths=True but no label_lengths "
                         "given")
    args = [data, label]
    if use_data_lengths:
        args.append(data_lengths)
    if use_label_lengths:
        args.append(label_lengths)
    if not _capturing():
        _ctc_check(data.shape, label.asnumpy(), blank_first, blank_label,
                   label_lengths.asnumpy() if use_label_lengths else None,
                   data_lengths.asnumpy() if use_data_lengths else None)

    def f(*raws):
        logits, lab = raws[0], raws[1].long()
        in_len = raws[2] if use_data_lengths else None
        lab_len = raws[-1] if use_label_lengths else None
        t_len, n, c = logits.shape
        big_l = lab.shape[1]
        s = 2 * big_l + 1
        dev = logits.device
        blank = 0 if blank_first else c - 1
        pad_val = 0 if blank_first else -1
        in_len = torch.full((n,), t_len, dtype=torch.long, device=dev) \
            if in_len is None else in_len.long()
        if lab_len is None:
            # the reference's LabelTensorToPackedVector: the length is the
            # position of the first padding value
            lab_len = torch.cumprod((lab != pad_val).long(), 1).sum(1)
        else:
            lab_len = lab_len.long()
        ftype = torch.float64 if logits.dtype == torch.float64 \
            else torch.float32
        logp = torch.log_softmax(logits.to(ftype), dim=-1)
        neg = torch.full((), -1e30, dtype=ftype, device=dev)
        # the extended label sequence [blank, l1, blank, ..., lL, blank]
        valid = torch.arange(big_l, device=dev)[None, :] < lab_len[:, None]
        lab_v = torch.where(valid, lab.clamp(0, c - 1),
                            torch.full_like(lab, blank))
        ext = torch.full((n, s), blank, dtype=torch.long, device=dev)
        ext[:, 1::2] = lab_v
        ext_m2 = torch.cat([torch.full((n, 2), -1, dtype=torch.long,
                                       device=dev), ext[:, :-2]], 1)
        can_skip = (ext != blank) & (ext != ext_m2)
        emit = torch.gather(logp, 2, ext[None].expand(t_len, n, s))
        pad1 = neg.expand(n, 1)
        pad2 = neg.expand(n, 2)
        s_idx = torch.arange(s, device=dev)
        alpha = torch.where(s_idx[None, :] < 2, emit[0], neg)
        for t in range(1, t_len):
            a1 = torch.cat([pad1, alpha[:, :-1]], 1)
            a2 = torch.where(can_skip,
                             torch.cat([pad2, alpha[:, :-2]], 1), neg)
            new = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + emit[t]
            # past a sequence's own length the lattice is frozen
            alpha = torch.where(t < in_len[:, None], new, alpha)
        s_end = 2 * lab_len
        last = torch.gather(alpha, 1, s_end[:, None])[:, 0]
        last2 = torch.gather(alpha, 1, (s_end - 1).clamp(min=0)[:, None])
        last2 = torch.where(lab_len > 0, last2[:, 0], neg)
        return -torch.logaddexp(last, last2)

    return apply_op(f, *args, name="ctc_loss")


def _ctc_check(data_shape, label, blank_first, blank_label, label_lengths,
               data_lengths):
    """The reference's host checks (ctc_loss.cc's CHECKs): live labels
    in the alphabet, data lengths within T."""
    t_len, _, c = data_shape
    lo, hi = (1, c - 1) if blank_first else (0, c - 2)
    pad = 0 if blank_first else -1
    if label_lengths is not None:
        live = np.arange(label.shape[1])[None, :] < \
            np.asarray(label_lengths).astype(np.int64)[:, None]
    else:
        live = label != pad
    bad = label[live]
    if bad.size and (bad.min() < lo or bad.max() > hi):
        raise MXNetError(
            f"ctc_loss: label values must lie in [{lo}, {hi}] for "
            f"blank_label={blank_label!r} (got range "
            f"[{bad.min()}, {bad.max()}])")
    if data_lengths is not None and np.asarray(data_lengths).max() > t_len:
        raise MXNetError(
            f"ctc_loss: data_lengths exceed the time dimension T={t_len} "
            f"(max {np.asarray(data_lengths).max()})")


# the reference's operator-style names
Activation = activation
LeakyReLU = leaky_relu
FullyConnected = fully_connected
Convolution = convolution
Deconvolution = deconvolution
UpSampling = upsampling
Pooling = pooling
BatchNorm = batch_norm
LayerNorm = layer_norm
GroupNorm = group_norm
InstanceNorm = instance_norm
L2Normalization = l2_normalization
Dropout = dropout
Embedding = embedding
Flatten = flatten
CTCLoss = ctc_loss

for _name, _alias in (
        ("activation", "Activation"), ("batch_norm", "BatchNorm"),
        ("ctc_loss", "CTCLoss"), ("convolution", "Convolution"),
        ("deconvolution", "Deconvolution"), ("dropout", "Dropout"),
        ("embedding", "Embedding"), ("flatten", "Flatten"),
        ("fully_connected", "FullyConnected"), ("group_norm", "GroupNorm"),
        ("instance_norm", "InstanceNorm"),
        ("l2_normalization", "L2Normalization"), ("layer_norm", "LayerNorm"),
        ("leaky_relu", "LeakyReLU"), ("pooling", "Pooling"),
        ("upsampling", "UpSampling")):
    register(_name, globals()[_name], (_alias,))
for _name in ("hard_sigmoid", "log_softmax", "softmax",
              "softmax_cross_entropy"):
    register(_name, globals()[_name])

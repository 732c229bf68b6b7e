"""Output (loss) ops of the symbolic API and the scalar ops.

Counterpart of ``mxnet_tpu/ops/output_ops.py``: ``SoftmaxOutput``, the
three regression outputs and ``MakeLoss``, whose backward ignores the
incoming gradient and writes the loss's own (``out - label`` and the
like), ``BlockGrad``/``stop_gradient``, and the ``_*_scalar`` ops of the
reference's registry.  Each custom backward is a
``torch.autograd.Function``.
"""
from __future__ import annotations

import math

import torch

from .registry import apply_op, exporter
from .. import autograd as ag
from .registry import make_exporter  # noqa: F401

__all__ = []
_export = exporter(__all__)


def _one_hot(label, c, axis, dtype):
    oh = (label.long().unsqueeze(-1) ==
          torch.arange(c, device=label.device)).to(dtype)
    return torch.movedim(oh, -1, axis) if axis != -1 else oh


def _norm_den(label, normalization, use_ignore, valid):
    """The gradient's denominator by the reference's ``normalization``."""
    if normalization == "batch":
        return float(label.shape[0])
    if normalization == "valid":
        if use_ignore:
            return valid.sum().clamp_min(1).float()
        return float(math.prod(label.shape))
    return 1.0


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, label, opts):
        out = torch.softmax(d.float(), dim=opts["axis"]).to(d.dtype)
        ctx.save_for_backward(out, label)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, g):
        ag.first_order_only("SoftmaxOutput")
        out, label = ctx.saved_tensors
        o = ctx.opts
        axis = o["axis"]
        c = out.shape[axis]
        oh = _one_hot(label, c, axis, torch.float32)
        if o["smooth_alpha"]:
            a = o["smooth_alpha"]
            oh = oh * (1.0 - a) + (a / (c - 1)) * (1 - oh)
        grad = out.float() - oh
        valid = None
        if o["use_ignore"]:
            valid = label != o["ignore_label"]
            grad = grad * valid.unsqueeze(axis).to(grad.dtype)
        grad = grad * (o["grad_scale"] / _norm_den(
            label, o["normalization"], o["use_ignore"], valid))
        return grad.to(out.dtype), None, None


def softmax_output(data, label=None, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0, **kwargs):
    """Reference ``SoftmaxOutput``: the softmax forward (over axis 1 with
    ``multi_output``, else the last); the backward is
    ``(softmax − one_hot(label))·grad_scale / normalization``.  Without a
    label it is the softmax alone."""
    axis = 1 if multi_output else -1
    if label is None:
        return apply_op(lambda d: torch.softmax(d.float(), dim=axis).to(
            d.dtype), data, name="SoftmaxOutput")
    opts = dict(axis=axis, grad_scale=grad_scale, ignore_label=ignore_label,
                use_ignore=use_ignore, normalization=normalization,
                smooth_alpha=smooth_alpha)
    return apply_op(lambda d, lab: _SoftmaxOutput.apply(d, lab, opts), data,
                    label, name="SoftmaxOutput")


_export(softmax_output, aliases=("SoftmaxOutput",))


class _RegressionOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, label, transform, grad_fn, grad_scale):
        out = transform(d)
        ctx.save_for_backward(out, label)
        ctx.grad_fn, ctx.grad_scale = grad_fn, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        ag.first_order_only("a regression output")
        out, label = ctx.saved_tensors
        num_output = max(math.prod(out.shape[1:]), 1)
        grad = ctx.grad_fn(out, label.reshape(out.shape)) * \
            (ctx.grad_scale / num_output)
        return grad.to(out.dtype), None, None, None, None


def _regression_output(transform, grad_fn, opname):
    def op(data, label=None, grad_scale=1.0, **kwargs):
        if label is None:
            return apply_op(transform, data, name=opname)
        return apply_op(lambda d, lab: _RegressionOutput.apply(
            d, lab, transform, grad_fn, grad_scale), data, label,
            name=opname)

    op.__name__ = opname
    op.__doc__ = (f"Reference ``{opname}``: the transform forward; the "
                  "backward is ``grad_fn(out, label)·grad_scale / "
                  "num_output``.")
    return op


linear_regression_output = _regression_output(
    lambda d: d, lambda o, lab: o - lab, "LinearRegressionOutput")
logistic_regression_output = _regression_output(
    torch.sigmoid, lambda o, lab: o - lab, "LogisticRegressionOutput")
mae_regression_output = _regression_output(
    lambda d: d, lambda o, lab: torch.sign(o - lab), "MAERegressionOutput")

# registered as the reference registers them: under their operator names
# (with themselves as the alias); the snake-case names are module names
for _op in (linear_regression_output, logistic_regression_output,
            mae_regression_output):
    _export(_op, _op.__name__, (_op.__name__,))
__all__ += ["linear_regression_output", "logistic_regression_output",
            "mae_regression_output"]


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, grad_scale, normalization):
        ctx.shape, ctx.grad_scale, ctx.norm = d.shape, grad_scale, \
            normalization
        return d.clone()

    @staticmethod
    def backward(ctx, g):
        shape = ctx.shape
        den = float(shape[0]) if ctx.norm == "batch" else (
            float(math.prod(shape)) if ctx.norm == "valid" else 1.0)
        return torch.full(shape, ctx.grad_scale / den, dtype=g.dtype,
                          device=g.device), None, None


def make_loss(data, grad_scale=1.0, valid_thresh=0.0,
              normalization="null", **kwargs):
    """Reference ``MakeLoss``: the identity forward, a constant
    ``grad_scale`` (over the batch or element count) backward."""
    return apply_op(lambda d: _MakeLoss.apply(d, grad_scale, normalization),
                    data, name="MakeLoss")


_export(make_loss, aliases=("MakeLoss", "make_loss_"))


def stop_gradient(data, **kwargs):
    """Reference ``BlockGrad``/``stop_gradient``: the value without a
    gradient."""
    return apply_op(lambda a: a.detach(), data, name="BlockGrad")


_export(stop_gradient, "BlockGrad", ("stop_gradient",))


# comparison and predicate scalar ops: 0/1 outputs, no gradient
_NO_GRAD_SCALAR = frozenset([
    "_equal_scalar", "_not_equal_scalar", "_greater_scalar",
    "_greater_equal_scalar", "_lesser_scalar", "_lesser_equal_scalar",
    "_logical_and_scalar", "_logical_or_scalar", "_logical_xor_scalar",
])


def _full(x, s):
    return torch.full((), s, dtype=x.dtype, device=x.device)


_SCALAR_OPS = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(_full(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.maximum(x, _full(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _full(x, s)),
    "_hypot_scalar": lambda x, s: torch.hypot(x, _full(x, s)),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
    "_logical_and_scalar": lambda x, s: torch.logical_and(
        x, _full(x, s)).to(x.dtype),
    "_logical_or_scalar": lambda x, s: torch.logical_or(
        x, _full(x, s)).to(x.dtype),
    "_logical_xor_scalar": lambda x, s: torch.logical_xor(
        x, _full(x, s)).to(x.dtype),
}


def _scalar_op(opname, fn):
    def op(data, scalar=1.0, **kwargs):
        s = float(scalar)
        return apply_op(lambda x: fn(x, s), data, name=opname,
                        no_grad=opname in _NO_GRAD_SCALAR)

    op.__name__ = opname
    op.__doc__ = f"Reference ``{opname}``: array-op-scalar."
    return op


for _name, _fn in _SCALAR_OPS.items():
    _export(_scalar_op(_name, _fn), _name,
            no_grad=_name in _NO_GRAD_SCALAR)


def _zeros(shape=(), dtype="float32", **kwargs):
    """Reference ``_zeros``: the creation op of the registry, on the
    current context."""
    return _created(torch.zeros, shape, dtype)


def _ones(shape=(), dtype="float32", **kwargs):
    """Reference ``_ones``: the creation op of the registry, on the
    current context."""
    return _created(torch.ones, shape, dtype)


def _created(fn, shape, dtype):
    from ..base import resolve_dtype
    from ..context import current_context
    from ..ndarray.ndarray import NDArray

    return NDArray(fn(tuple(shape), dtype=resolve_dtype(dtype),
                      device=current_context().device))


_export(_zeros, "_zeros")
_export(_ones, "_ones")

"""INT8 quantization operators.

Counterpart of ``mxnet_tpu/ops/quantization.py`` (reference
``src/operator/quantization/``): ``quantize``, ``quantize_v2``,
``dequantize``, ``requantize``, ``quantized_fully_connected``,
``quantized_conv``, ``quantized_pooling`` and ``quantized_flatten``, with
their ``_contrib_*`` aliases.  Ranges travel beside the data as
(min, max) 0-d tensors on the data's device, the reference's 3-tensor
convention; a range an op computes is never read to the host, so a
quantized net captures into a CUDA graph.  A calibrated range
(``min_calib_range``/``max_calib_range``) is a Python number, as in the
reference, and becomes a 0-d tensor by a fill, not a copy.

The int8 products accumulate in int32, exactly, as the reference's
``lax.dot_general(preferred_element_type=int32)`` does: ``_int8_matmul``
is ``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM on the card) on
K-contiguous operands, with M, K and N zero-padded to the shapes it
takes (padding adds zero products, which is exact).  No float route: the f32 sum of int8 products
is not exact past 2^24 (127² · 4,608 ≈ 7.4e7 at ResNet's 3×3×512).  The
int8 convolution unfolds its input in f16 (every int8 value is exact
there; torch has no int8 ``unfold``), casts the columns back to int8 and
runs the same product; a 1×1 kernel skips the unfold.  These are library
calls, as the reference left them to XLA outside any Pallas kernel.

XLA's float → int32 conversion saturates where torch's wraps
(``round(amax · (2^31 − 1) / amax)`` is 2^31 in f32): every such cast
goes through ``_to_int32``, which saturates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tnf

from ..base import MXNetError
from .registry import apply_op, exporter
from .registry import make_exporter  # noqa: F401

__all__ = []
_export = exporter(__all__)

_QMAX = {"int8": 127.0, "uint8": 255.0, "int32": 2.0 ** 31 - 1}


def _scale(mn, mx, out_type):
    """float range → quant scale (symmetric int8/int32 with
    max(|min|, |max|); affine uint8 over max − min)."""
    if out_type == "uint8":
        return _QMAX["uint8"] / torch.clamp(mx - mn, min=1e-12)
    amax = torch.clamp(torch.maximum(mn.abs(), mx.abs()), min=1e-12)
    return _QMAX[out_type] / amax


def _const(v, like):
    """A Python number as a 0-d f32 tensor on ``like``'s device."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _to_int32(f):
    """float → int32 saturating at the ends, as XLA converts."""
    return f.double().clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def _quantize_body(x, mn, mx, out_type):
    """uint8 affine / int8 symmetric; returns (q, min, max)."""
    s = _scale(mn, mx, out_type)
    if out_type == "uint8":
        q = torch.clamp(torch.round((x - mn) * s), 0, 255).to(torch.uint8)
        return q, mn, mx
    q = torch.clamp(torch.round(x * s), -127, 127).to(torch.int8)
    amax = torch.maximum(mn.abs(), mx.abs())
    return q, -amax, amax


def quantize(data, min_range, max_range, out_type="uint8", **kwargs):
    """Reference ``_contrib_quantize``: float → quantized with the given
    range.  Returns (q, min, max)."""
    return apply_op(
        lambda x, mn, mx: _quantize_body(x, mn.float(), mx.float(),
                                         out_type),
        data, min_range, max_range, name="quantize")


_export(quantize, aliases=("_contrib_quantize",))


def quantize_v2(data, out_type="int8", min_calib_range=None,
                max_calib_range=None, **kwargs):
    """Reference ``_contrib_quantize_v2``: the range from calibration
    (Python numbers) or from the data itself (its min and max, on the
    device).  Returns (q, min, max)."""

    def f(x):
        if min_calib_range is not None and max_calib_range is not None:
            mn = _const(min_calib_range, x)
            mx = _const(max_calib_range, x)
        else:
            mn = x.min().float()
            mx = x.max().float()
        return _quantize_body(x, mn, mx, out_type)

    return apply_op(f, data, name="quantize_v2")


_export(quantize_v2, aliases=("_contrib_quantize_v2",))


def dequantize(data, min_range, max_range, out_type="float32", **kwargs):
    """Reference ``_contrib_dequantize``: quantized → float32."""

    def f(q, mn, mx):
        mn, mx = mn.float(), mx.float()
        if q.dtype == torch.uint8:
            return q.float() / _scale(mn, mx, "uint8") + mn
        qtype = "int8" if q.dtype == torch.int8 else "int32"
        return q.float() / _scale(mn, mx, qtype)

    return apply_op(f, data, min_range, max_range, name="dequantize")


_export(dequantize, aliases=("_contrib_dequantize",))


def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None, out_type="int8", **kwargs):
    """Reference ``_contrib_requantize``: int32 accumulator → int8 with a
    (possibly calibrated) narrower range."""

    def f(q, mn, mx):
        real = q.float() / _scale(mn.float(), mx.float(), "int32")
        if min_calib_range is not None:
            omn = _const(min_calib_range, q)
            omx = _const(max_calib_range, q)
        else:
            omn, omx = real.min(), real.max()
        s = _scale(omn, omx, "int8")
        q8 = torch.clamp(torch.round(real * s), -127, 127).to(torch.int8)
        amax = torch.maximum(omn.abs(), omx.abs())
        return q8, -amax, amax

    return apply_op(f, data, min_range, max_range, name="requantize")


_export(requantize, aliases=("_contrib_requantize",))


def _round_up(n, m):
    return -(-n // m) * m


def _int8_matmul(a, w):
    """(M, K) int8 @ (N, K) int8 transposed → (M, N) int32, exact.  The
    weight stays (N, K) row-major, so both operands are K-contiguous (the
    "TN" layout of cuBLASLt's int8 kernels).  On an H100 the weight
    copied as a (K, N) row-major matrix was refused at some shapes and
    ran 6.7× slower at 6272×4608×512 (``chip_smoke.py`` phase 21a
    times both).  ``torch._int_mm`` takes M > 16 and K, N multiples of
    8: the operands are zero-padded up to that (M to a multiple of 8 as
    well) and the result sliced."""
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = tnf.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = tnf.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _unpack(rest, no_bias):
    if no_bias:
        return None, rest[:4]
    return rest[0], rest[1:5]


def quantized_fully_connected(*args, num_hidden=0, no_bias=False,
                              flatten=True, **kwargs):
    """Reference ``_contrib_quantized_fully_connected``: int8 × int8 →
    int32.  Inputs (positional, the reference's order): ``data, weight,
    [bias,] min_data, max_data, min_weight, max_weight``.  Returns
    (int32 out, min_out, max_out)."""

    def f(x, w, *rest):
        b, ranges = _unpack(rest, no_bias)
        mnd, mxd, mnw, mxw = (r.float() for r in ranges)
        xi = x.reshape(x.shape[0], -1) if flatten else x
        lead = xi.shape[:-1]
        xi = xi.reshape(-1, xi.shape[-1])
        sw = _scale(mnw, mxw, "int8")
        w8 = w.to(torch.int8)
        if x.dtype == torch.uint8:
            # affine uint8: x ≈ q/s + mn.  Shifted by 128 the product runs
            # int8 × int8; the zero-point terms (the shift and mn) fold
            # into a per-output-column constant (exact)
            sd = _scale(mnd, mxd, "uint8")
            q8 = (xi.to(torch.int32) - 128).to(torch.int8)
            acc = _int8_matmul(q8, w8)
            colsum = w8.sum(dim=1, dtype=torch.int32).float()
            real = acc.float() / (sd * sw) \
                + colsum * (128.0 / (sd * sw) + mnd / sw)
            if b is not None:
                real = real + b.float() / (sd * sw)
            # re-expressed as int32 with a symmetric range, the int8
            # path's contract
            amax = torch.clamp(real.abs().max(), min=1e-12)
            out = _to_int32(torch.round(real * (_QMAX["int32"] / amax)))
            return out.reshape(*lead, -1), -amax, amax
        sd = _scale(mnd, mxd, "int8")
        out = _int8_matmul(xi.to(torch.int8), w8)
        if b is not None:
            # the bias arrives int8 in the accumulator's scale
            out = out + b.to(torch.int32)
        amax = _QMAX["int32"] / (sd * sw)
        return out.reshape(*lead, -1), -amax, amax

    return apply_op(f, *args, name="quantized_fully_connected")


_export(quantized_fully_connected,
        aliases=("_contrib_quantized_fully_connected",))


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(
        int(e) for e in v)


def _int8_conv2d(x, w, stride, pad, dilate):
    """NCHW int8 convolution accumulating int32: the input's columns
    (unfolded in f16, where int8 is exact, and cast back) times the
    flattened weight, through ``_int8_matmul``."""
    n, c, h, wd = x.shape
    o, _, kh, kw = w.shape
    ho = (h + 2 * pad[0] - dilate[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (wd + 2 * pad[1] - dilate[1] * (kw - 1) - 1) // stride[1] + 1
    if (kh, kw) == (1, 1) and pad == (0, 0):
        cols = x[:, :, ::stride[0], ::stride[1]].permute(0, 2, 3, 1) \
            .reshape(n * ho * wo, c)
    else:
        half = tnf.unfold(x.to(torch.float16), (kh, kw), dilation=dilate,
                          padding=pad, stride=stride)
        cols = half.transpose(1, 2).to(torch.int8).reshape(
            n * ho * wo, c * kh * kw)
    out = _int8_matmul(cols, w.reshape(o, -1))
    return out.reshape(n, ho, wo, o).permute(0, 3, 1, 2)


def quantized_conv(*args, kernel=None, stride=(1, 1), pad=(0, 0),
                   dilate=(1, 1), num_filter=0, no_bias=False,
                   layout="NCHW", **kwargs):
    """Reference ``_contrib_quantized_conv``: int8 NCHW convolution
    accumulating int32.  Inputs positional as in
    ``quantized_fully_connected``."""
    stride, pad, dilate = _pair(stride), _pair(pad), _pair(dilate)

    def f(x, w, *rest):
        if x.dtype == torch.uint8:
            raise MXNetError(
                "quantized_conv requires int8 data: the uint8 zero-point "
                "correction is not exact under zero padding (the reference "
                "MKLDNN u8s8 path has the same caveat); quantize data with "
                "out_type='int8'")
        if x.dim() != 4:
            raise MXNetError("quantized_conv supports 2D NCHW only")
        b, ranges = _unpack(rest, no_bias)
        mnd, mxd, mnw, mxw = (r.float() for r in ranges)
        out = _int8_conv2d(x.to(torch.int8), w.to(torch.int8), stride, pad,
                           dilate)
        if b is not None:
            out = out + b.to(torch.int32)[None, :, None, None]
        amax = _QMAX["int32"] / (_scale(mnd, mxd, "int8") *
                                 _scale(mnw, mxw, "int8"))
        return out, -amax, amax

    return apply_op(f, *args, name="quantized_conv")


_export(quantized_conv, aliases=("_contrib_quantized_conv",))


def quantized_pooling(data, min_data, max_data, kernel=None,
                      pool_type="max", stride=None, pad=None,
                      global_pool=False, **kwargs):
    """Reference ``_contrib_quantized_pooling``: pool a float32 view and
    round back to the data's type (the range is kept; an average cannot
    overflow)."""
    from .nn_ops import pooling

    dtype = data._data.dtype
    out = pooling(apply_op(lambda q: q.float(), data, name="q2f"),
                  kernel=kernel, pool_type=pool_type, stride=stride,
                  pad=pad, global_pool=global_pool)
    q = apply_op(lambda v: torch.round(v).to(dtype), out,
                 name="quantized_pool_cast", no_grad=True)
    return q, min_data, max_data


_export(quantized_pooling, aliases=("_contrib_quantized_pooling",),
        no_grad=True)


def quantized_flatten(data, min_data, max_data, **kwargs):
    """Reference ``_contrib_quantized_flatten``."""
    out = apply_op(lambda q: q.reshape(q.shape[0], -1), data,
                   name="quantized_flatten")
    return out, min_data, max_data


_export(quantized_flatten, aliases=("_contrib_quantized_flatten",))

"""Fused 1×1 convolution + inference BatchNorm + ReLU: a hand-written CUDA
kernel for Hopper.

Counterpart of ``tools/pallas_conv_probe.py``: its Pallas kernel
``fused_matmul_affine_relu`` computes relu(scale·(x @ w) + bias) with f32
accumulation and the affine and ReLU applied to the accumulator before
one store, and its ``_paths.pallas_fn`` folds an inference BatchNorm into
that per-channel affine to run ``Convolution → BatchNorm(use_global_stats)
→ relu`` for a 1×1 conv as one kernel.

Here every CUDA tensor goes to ``csrc/fused_matmul_affine_relu.cu`` (any
M, N, K), and only a CPU tensor takes the plain PyTorch version
``_fused_matmul_affine_relu_plain``; there is no fallback from one to the
other and no switch between them.

Operand dtypes: bf16 x and w give the exact products of the bf16 values,
summed in f32 — what the Pallas kernel computes — on the tensor cores
(``mma.sync``, the kernel's ``_mma`` design).  f32 x and w stay f32 on the
FMA pipes (``_fma``): the Pallas kernel would round them to bf16 before its
product, but the JAX package's f32 ResNet never does that (its conv is f32
XLA), and the port's f32 ResNet must equal it.  Other dtypes raise.

``conv1x1_bn_relu`` is the fold on NCHW tensors, the fused path of
``gluon.nn.HybridSequential`` for a 1×1 ``Conv2D → BatchNorm →
Activation("relu")`` run in inference (``gluon/nn/basic_layers.py``).
"""
from __future__ import annotations

import torch

from .. import _kernels
from ..base import MXNetError

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}


def _fused_matmul_affine_relu_plain(x, w, scale, bias):
    """Plain PyTorch version of the kernel: the same function on f32
    copies, one rounding to x's dtype at the end."""
    return torch.relu(x.float() @ w.float() * scale + bias).to(x.dtype)


def _check_kernel_operands(x, w, scale, bias):
    if not (x.is_cuda and all(t.device == x.device
                              for t in (w, scale, bias))):
        raise MXNetError(
            "fused_matmul_affine_relu: x, w, scale and bias must lie on one "
            f"CUDA device (got {x.device}, {w.device}, {scale.device}, "
            f"{bias.device})")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise MXNetError(
            "fused_matmul_affine_relu: x and w must share one dtype of "
            f"float32/bfloat16 (got {x.dtype}, {w.dtype})")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise MXNetError(
            "fused_matmul_affine_relu: expected x (M, K) and w (K, N); got "
            f"{tuple(x.shape)}, {tuple(w.shape)}")
    n = w.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise MXNetError(
                f"fused_matmul_affine_relu: {name} must be float32 ({n},); "
                f"got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (x, w, scale, bias)):
        raise MXNetError("fused_matmul_affine_relu: x, w, scale and bias "
                         "must be contiguous")


def fused_matmul_affine_relu(x, w, scale, bias):
    """relu(scale·(x @ w) + bias): x (M, K) and w (K, N) in bf16 or f32,
    scale and bias (N,) f32 → (M, N) in x's dtype.

    A CUDA tensor launches the kernel of its dtype's design: bf16 the
    tensor cores' (``_mma``), f32 the FMA pipes' (``_fma``);
    ``fused_matmul_affine_relu.launches`` counts every launch and
    ``.launches_mma`` the tensor-core design's.  CPU tensors take the
    plain version."""
    if all(t.device.type == "cpu" for t in (x, w, scale, bias)):
        return _fused_matmul_affine_relu_plain(x, w, scale, bias)
    _check_kernel_operands(x, w, scale, bias)
    design = "mma" if x.dtype == torch.bfloat16 else "fma"
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _kernels.load("fused_matmul_affine_relu")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"mxt_fused_matmul_affine_relu_{design}")(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), m, n, k, _DTYPE_CODES[x.dtype], stream)
    _kernels.check(lib, err, f"fused_matmul_affine_relu ({design}) launch")
    fused_matmul_affine_relu.launches += 1
    if design == "mma":
        fused_matmul_affine_relu.launches_mma += 1
    return out


fused_matmul_affine_relu.launches = 0
fused_matmul_affine_relu.launches_mma = 0


def fold_bn(weight, conv_bias, gamma, beta, moving_mean, moving_var, eps,
            fix_gamma):
    """(w (K, N), scale (N,), bias (N,)) of a 1×1 conv with weight
    (N, K, 1, 1) and optional bias, followed by an inference BatchNorm:
    scale = gamma / sqrt(var + eps) and bias = beta + (conv_bias − mean) ·
    scale, both in f32 (gamma taken as 1 when ``fix_gamma``)."""
    inv = torch.rsqrt(moving_var.float() + eps)
    scale = inv if fix_gamma else gamma.float() * inv
    shift = -moving_mean.float() if conv_bias is None else \
        conv_bias.float() - moving_mean.float()
    bias = beta.float() + shift * scale
    w = weight.reshape(weight.shape[0], -1).t().contiguous()
    return w, scale.contiguous(), bias.contiguous()


def conv1x1_bn_relu(x, weight, conv_bias, gamma, beta, moving_mean,
                    moving_var, eps, stride, fix_gamma):
    """relu(BatchNorm_inference(conv1x1(x))) on NCHW ``x`` as one
    ``fused_matmul_affine_relu``.

    The stride is applied as ``x[:, :, ::sh, ::sw]`` (exact for a 1×1 conv
    without padding); x is laid out as the (B·H′·W′, C) matrix the kernel
    takes (a copy), and the (M, N) result comes back as a (B, N, H′, W′)
    view with channels-last strides.  ``conv1x1_bn_relu.calls`` counts the
    calls, on every device."""
    conv1x1_bn_relu.calls += 1
    sh, sw = stride
    xs = x[:, :, ::sh, ::sw] if (sh, sw) != (1, 1) else x
    b, c, h, wd = xs.shape
    xm = xs.permute(0, 2, 3, 1).reshape(b * h * wd, c).contiguous()
    w, scale, bias = fold_bn(weight, conv_bias, gamma, beta, moving_mean,
                             moving_var, eps, fix_gamma)
    y = fused_matmul_affine_relu(xm, w, scale, bias)
    return y.view(b, h, wd, -1).permute(0, 3, 1, 2)


conv1x1_bn_relu.calls = 0

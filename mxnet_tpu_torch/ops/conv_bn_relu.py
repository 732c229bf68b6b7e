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
other and no switch between them.  The two are the CUDA and CPU
implementations of one ``torch.library`` custom op
(``mxnet_tpu_torch::fused_matmul_affine_relu``, with a fake
implementation for tracing), so the dispatcher chooses by device and an
exported program holds the op as a node.

Operand dtypes: bf16 x and w give the exact products of the bf16 values,
summed in f32 — what the Pallas kernel computes — on the tensor cores
(Hopper's ``wgmma`` on tiles the TMA unit loads, the kernel's ``_mma``
design); f16 x and w take the same design (an f16 instance of it), so
that a net cast to float16 runs its fused runs through the kernel as bf16
does.  Operands a TMA tensor map cannot describe (K or N not a multiple
of 8, x or w not 16-byte aligned, K = 0) are made describable here
(``_tma_operands``: K and N zero-padded to multiples of 8, a misaligned
operand copied) and the output sliced back.  f32 x and w stay
f32 on the FMA pipes (``_fma``): the Pallas kernel would round them to
bf16 before its product, but the JAX package's f32 ResNet never does
that (its conv is f32 XLA), and the port's f32 ResNet must equal it.
Other dtypes raise.

``conv1x1_bn_relu`` is the fold on NCHW tensors, the fused path of
``gluon.nn.HybridSequential`` for a 1×1 ``Conv2D → BatchNorm →
Activation("relu")`` run in inference (``gluon/nn/basic_layers.py``).
"""
from __future__ import annotations

import torch

from .. import _kernels, cuda_graph
from ..base import MXNetError
from ..telemetry import costs as _costs

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _tma_operands(x, w, scale, bias):
    """(x, w, scale, bias) as the ``wgmma`` design's tensor maps take
    them: K and N rounded up to multiples of 8 (K to at least 8) with
    zeros, so that the products are unchanged and each added output
    column is relu(0·0 + 0) = 0, to be sliced off; an operand that is not
    16-byte aligned copied to a new (aligned) allocation.  Operands that
    need neither come back as they are: every shape of the port's nets."""
    k, n = w.shape
    k8, n8 = max(-(-k // 8) * 8, 8), -(-n // 8) * 8
    pad = torch.nn.functional.pad
    if k8 != k:
        x = pad(x, (0, k8 - k))
    elif x.data_ptr() % 16:
        x = x.clone()
    if (k8, n8) != (k, n):
        w = pad(w, (0, n8 - n, 0, k8 - k))
    elif w.data_ptr() % 16:
        w = w.clone()
    if n8 != n:
        scale, bias = pad(scale, (0, n8 - n)), pad(bias, (0, n8 - n))
    return x, w, scale, bias


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
            f"float32/float16/bfloat16 (got {x.dtype}, {w.dtype})")
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
    """relu(scale·(x @ w) + bias): x (M, K) and w (K, N) in bf16, f16 or
    f32, scale and bias (N,) f32 → (M, N) in x's dtype.

    One call of the custom op ``torch.ops.mxnet_tpu_torch.
    fused_matmul_affine_relu`` on every route, eager or traced by
    ``torch.export`` (``HybridBlock.export`` keeps it as a node of the
    program): the dispatcher sends CUDA tensors to the kernel and CPU
    tensors to the plain version.  On CUDA tensors it launches the kernel
    of their dtype's design: bf16 and f16 the tensor cores' (``_mma``, on
    operands ``_tma_operands`` pads where a tensor map cannot describe
    them), f32 the FMA pipes' (``_fma``);
    ``fused_matmul_affine_relu.launches`` counts every launch and
    ``.launches_mma`` the tensor-core design's."""
    if _costs._counting:  # a cost count runs (telemetry.costs)
        with _costs.kernel(_fmar_cost, x, w):
            return _fmar_op(x, w, scale, bias)
    return _fmar_op(x, w, scale, bias)


def _fmar_cost(x, w):
    """(flops, bytes) of the kernel, as its bound counts them in
    ``chip_smoke.py``: 2·M·N·K; x, w, scale and bias read and the output
    written once."""
    (m, k), n = x.shape, w.shape[1]
    return 2.0 * m * k * n, \
        x.element_size() * (m * k + k * n + m * n) + 8 * n


@torch.library.custom_op("mxnet_tpu_torch::fused_matmul_affine_relu",
                         mutates_args=(), device_types="cpu")
def _fmar_op(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return _fused_matmul_affine_relu_plain(x, w, scale, bias)


@_fmar_op.register_kernel("cuda")
def _fmar_cuda(x, w, scale, bias):
    """The op's CUDA implementation: the kernel, through its C entry
    point on the current stream."""
    _check_kernel_operands(x, w, scale, bias)
    design = "fma" if x.dtype == torch.float32 else "mma"
    n = w.shape[1]
    if design == "mma":
        x, w, scale, bias = _tma_operands(x, w, scale, bias)
    (m, k), n8 = x.shape, w.shape[1]
    out = torch.empty((m, n8), dtype=x.dtype, device=x.device)
    lib = _kernels.load("fused_matmul_affine_relu")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"mxt_fused_matmul_affine_relu_{design}")(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), m, n8, k, _DTYPE_CODES[x.dtype], stream)
    _kernels.check(lib, err, f"fused_matmul_affine_relu ({design}) launch")
    cuda_graph.count(fused_matmul_affine_relu)
    if design == "mma":
        cuda_graph.count(fused_matmul_affine_relu, "launches_mma")
    return out if n8 == n else out[:, :n].contiguous()


@_fmar_op.register_fake
def _fmar_fake(x, w, scale, bias):
    """The op's output under a trace: (M, N) in x's dtype."""
    return x.new_empty((x.shape[0], w.shape[1]))


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
    cuda_graph.count(conv1x1_bn_relu, "calls")
    sh, sw = stride
    xs = x[:, :, ::sh, ::sw] if (sh, sw) != (1, 1) else x
    b, c, h, wd = xs.shape
    xm = xs.permute(0, 2, 3, 1).reshape(b * h * wd, c).contiguous()
    w, scale, bias = fold_bn(weight, conv_bias, gamma, beta, moving_mean,
                             moving_var, eps, fix_gamma)
    y = fused_matmul_affine_relu(xm, w, scale, bias)
    return y.view(b, h, wd, -1).permute(0, 3, 1, 2)


conv1x1_bn_relu.calls = 0

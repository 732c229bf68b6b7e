"""The hand-written CUDA kernels of the PyTorch/CUDA port against their
plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and ``nvcc`` (marker ``cuda``) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import conv_bn_relu as cbr
from mxnet_tpu_torch.ops import flash_attention as tfa


def _qkv(seed, b, h, tq, tk, d):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(b, h, tq, d)).astype(np.float32),
            rng.normal(size=(b, h, tk, d)).astype(np.float32),
            rng.normal(size=(b, h, tk, d)).astype(np.float32))


@pytest.fixture
def cuda_nvcc():
    """Decided at run time: the card and nvcc are both needed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    from mxnet_tpu_torch import _kernels

    try:
        _kernels.nvcc()
    except MXNetError:
        pytest.skip("needs nvcc to build the kernels in csrc/")
    return torch.device("cuda", 0)


# Shapes for both directions: every D, ragged T (no tile multiple),
# Tq < Tk (bottom-right alignment), and Tq > Tk (causal rows that see no
# key), causal and not.
SHAPES = [
    (True, 256, 256, 128), (False, 200, 200, 64), (True, 4, 6, 32),
    (True, 70, 5, 16), (True, 333, 333, 32), (False, 129, 65, 16),
    (True, 100, 300, 64), (True, 300, 100, 128)]


def _assert_rows_close(g, r, row_tol, norm_tol):
    """Row by row (one query's O or dq, one key's dk or dv): the row's
    largest error within ``row_tol`` of the row's largest reference value,
    or of the dtype's smallest normal number where that is larger (f16
    rounds smaller values to a fixed step); and ||g - r|| / ||r|| <=
    norm_tol."""
    diff = (g.float() - r).abs()
    floor = torch.finfo(g.dtype).tiny
    allowed = row_tol * r.abs().amax(-1).clamp_min(floor)
    assert bool((diff.amax(-1) <= allowed).all()), \
        f"row error {(diff.amax(-1) / allowed).max().item()} x allowed"
    norm = (torch.linalg.vector_norm(g.float() - r) /
            torch.linalg.vector_norm(r)).item()
    assert norm <= norm_tol, f"relative norm {norm} > {norm_tol}"


# The plain version runs on f32 copies of the same inputs (its own
# arithmetic is f32 whatever the input dtype).  f32: another summation
# order (1e-4; 1e-4 of a row, 1e-5 in norm); bf16/f16: the tensor-core
# kernel rounds P and its output to 8/11 mantissa bits (2e-2 at |O| < 8;
# each by at most u = 2^-8 / 2^-11 of a value, so 2u of a row and 2u in
# norm, as chip_smoke.py holds it); lse is f32 in both (1e-3).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,row_tol,norm_tol", [
    (torch.float32, 1e-4, 1e-4, 1e-5),
    (torch.bfloat16, 2e-2, 2 * 2.0 ** -8, 2 * 2.0 ** -8),
    (torch.float16, 2e-2, 2 * 2.0 ** -11, 2 * 2.0 ** -11)])
@pytest.mark.parametrize("causal,tq,tk,d", SHAPES)
def test_kernel_matches_plain_on_card(cuda_nvcc, dtype, tol, row_tol,
                                      norm_tol, causal, tq, tk, d):
    q, k, v = (torch.from_numpy(a).to(cuda_nvcc, dtype)
               for a in _qkv(6, 2, 3, tq, tk, d))
    mma = int(tfa._design(dtype) == "mma")
    before = tfa.flash_attention_fwd.launches
    before_mma = tfa.flash_attention_fwd.launches_mma
    o, lse = tfa.flash_attention_fwd(q, k, v, causal, 0.3)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    assert tfa.flash_attention_fwd.launches_mma == before_mma + mma
    o_ref, lse_ref = tfa._fa_forward_plain(q.float(), k.float(), v.float(),
                                           causal, 0.3)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert (o.float() - o_ref).abs().max().item() <= tol
    _assert_rows_close(o, o_ref, row_tol, norm_tol)
    fin = torch.isfinite(lse_ref)
    assert torch.equal(fin, torch.isfinite(lse))
    assert (lse - lse_ref)[fin].abs().max().item() <= 1e-3
    if causal and tq > tk:  # rows that see no key: O exactly 0
        assert bool((o[:, :, :tq - tk] == 0).all())


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_nvcc):
    q = torch.zeros(1, 1, 8, 48, device=cuda_nvcc)
    with pytest.raises(MXNetError, match="head dim"):
        tfa.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 1, 16, 8, device=cuda_nvcc).transpose(2, 3)
    with pytest.raises(MXNetError, match="contiguous"):
        tfa.flash_attention_fwd(q, q, q)
    # a storage offset of one element: the bf16/f16 kernels copy 16 bytes
    q = torch.zeros(1 + 4 * 32, device=cuda_nvcc,
                    dtype=torch.bfloat16)[1:].view(1, 1, 4, 32)
    with pytest.raises(MXNetError, match="aligned"):
        tfa.flash_attention_fwd(q, q, q)


def _backward_case(device, dtype, b, h, tq, tk, d, causal, seed=7):
    """Kernel forward, then both backward kernels, at one shape."""
    q, k, v = (torch.from_numpy(a).to(device, dtype)
               for a in _qkv(seed, b, h, tq, tk, d))
    do = torch.from_numpy(np.random.RandomState(seed + 1).normal(
        size=(b, h, tq, d)).astype(np.float32)).to(device, dtype)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal, 0.3)
    return (q, k, v, o, do, lse), tfa.flash_attention_bwd(
        q, k, v, o, do, lse, causal, 0.3)


# The plain version runs on f32 copies of the same inputs and the kernel's
# own O and lse.  Each gradient is held row by row and by its relative
# norm: f32, another summation order (1e-4 of a row, 1e-5 in norm);
# bf16/f16, the kernels' f32 results are rounded to 8/11 mantissa bits, at
# most 3.9e-3/4.9e-4 of each value (1e-2 and 5e-3; 2e-3 and 1e-3).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,row_tol,norm_tol", [
    (torch.float32, 1e-4, 1e-5), (torch.bfloat16, 1e-2, 5e-3),
    (torch.float16, 2e-3, 1e-3)])
@pytest.mark.parametrize("causal,tq,tk,d", SHAPES)
def test_backward_kernels_match_plain_on_card(cuda_nvcc, dtype, row_tol,
                                              norm_tol, causal, tq, tk, d):
    mma = int(tfa._design(dtype) == "mma")
    dq_n = tfa.flash_attention_bwd_dq.launches
    dkv_n = tfa.flash_attention_bwd_dkv.launches
    dkv_mma_n = tfa.flash_attention_bwd_dkv.launches_mma
    (q, k, v, o, do, lse), got = _backward_case(cuda_nvcc, dtype, 2, 3, tq,
                                                tk, d, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_dq.launches == dq_n + 1
    assert tfa.flash_attention_bwd_dkv.launches == dkv_n + 1
    assert tfa.flash_attention_bwd_dkv.launches_mma == dkv_mma_n + mma
    ref = tfa._fa_backward_plain(q.float(), k.float(), v.float(), o.float(),
                                 do.float(), lse, causal, 0.3)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert bool(torch.isfinite(g).all())
        _assert_rows_close(g, r, row_tol, norm_tol)
    if causal and tq > tk:  # rows 0 .. tq - tk - 1 see no key: dq is 0
        assert bool((got[0][:, :, :tq - tk] == 0).all())


@pytest.mark.cuda
def test_backward_kernels_are_deterministic(cuda_nvcc):
    """Each output tile has one owner block and no atomics: two runs give
    the same bits (bf16: the tensor-core dK/dV kernel)."""
    _, first = _backward_case(cuda_nvcc, torch.bfloat16, 1, 4, 300, 300,
                              128, True)
    _, second = _backward_case(cuda_nvcc, torch.bfloat16, 1, 4, 300, 300,
                               128, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_backward_rejects_what_it_does_not_take(cuda_nvcc):
    q = torch.zeros(1, 1, 8, 48, device=cuda_nvcc)
    lse = torch.zeros(1, 1, 8, device=cuda_nvcc)
    with pytest.raises(MXNetError, match="head dim"):
        tfa.flash_attention_bwd(q, q, q, q, q, lse)
    q = torch.zeros(1, 1, 8, 32, device=cuda_nvcc)
    with pytest.raises(MXNetError, match="contiguous"):
        tfa.flash_attention_bwd(q, q, q, q, q.transpose(2, 3).contiguous()
                                .transpose(2, 3), lse)
    with pytest.raises(MXNetError, match="lse"):
        tfa.flash_attention_bwd(q, q, q, q, q, lse.double())


@pytest.mark.cuda
def test_llama_tiny_on_card_matches_cpu(cuda_nvcc):
    """The same weights on the card (flash kernel, once per layer) and on
    the CPU (plain version): f32 logits within 1e-4."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.models import llama_tiny

    torch.backends.cuda.matmul.allow_tf32 = False
    mx.random.seed(0)
    cpu_net = llama_tiny()
    cpu_net.initialize(ctx=mx.cpu())
    arrays = {k: p.data().asnumpy() for k, p in
              cpu_net._collect_params_with_prefix().items()}
    gpu_net = llama_tiny()
    load_numpy_params(gpu_net, arrays, ctx=mx.gpu(0))
    ids = np.random.RandomState(0).randint(0, 256, (2, 100)).astype("i")
    before = tfa.flash_attention_fwd.launches
    got = gpu_net(mx.nd.array(ids, ctx=mx.gpu(0), dtype="int32"))
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 2
    ref = cpu_net(mx.nd.array(ids, ctx=mx.cpu(), dtype="int32"))
    assert np.abs(got.asnumpy() - ref.asnumpy()).max() <= 1e-4
    out = gpu_net.generate(mx.nd.array(ids[:, :20], ctx=mx.gpu(0),
                                       dtype="int32"), max_new_tokens=6)
    ref_out = cpu_net.generate(mx.nd.array(ids[:, :20], ctx=mx.cpu(),
                                           dtype="int32"), max_new_tokens=6)
    np.testing.assert_array_equal(out.asnumpy(), ref_out.asnumpy())


def _mm_operands(device, dtype, m, k, n, seed=11):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, n)) / np.sqrt(k)).astype(
        np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-0.5, 0.5, n).astype(np.float32))
    return (x.to(device, dtype), w.to(device, dtype), scale.to(device),
            bias.to(device))


# ResNet-50 v1's eight (K, N) at B=2 (M = 2·H'·W'), and ragged shapes.
# The plain version runs on f32 copies of the same inputs: f32, another
# summation order (1e-5 of the largest value); bf16, the kernel's f32
# result rounded to 8 mantissa bits (2^-8 of each value) and another
# summation order (1e-4 of the largest value).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel,tol", [(torch.float32, 0.0, 1e-5),
                                           (torch.bfloat16, 2.0 ** -8, 1e-4)])
@pytest.mark.parametrize("m,k,n", [
    (6272, 64, 64), (6272, 256, 64), (1568, 256, 128), (1568, 512, 128),
    (392, 512, 256), (392, 1024, 256), (98, 1024, 512), (98, 2048, 512),
    (49, 100, 30), (1, 7, 3), (130, 17, 65)])
def test_fused_kernel_matches_plain_on_card(cuda_nvcc, dtype, rel, tol, m,
                                            k, n):
    x, w, scale, bias = _mm_operands(cuda_nvcc, dtype, m, k, n)
    before = cbr.fused_matmul_affine_relu.launches
    got = cbr.fused_matmul_affine_relu(x, w, scale, bias)
    torch.cuda.synchronize()
    assert cbr.fused_matmul_affine_relu.launches == before + 1
    ref = cbr._fused_matmul_affine_relu_plain(x.float(), w.float(), scale,
                                              bias)
    assert got.dtype == dtype and got.shape == (m, n)
    diff = (got.float() - ref).abs()
    assert bool((diff <= rel * ref.abs() + tol * ref.abs().max()).all()), \
        diff.max().item()
    assert bool((got[ref == 0] == 0).all())  # the ReLU clamps the same


@pytest.mark.cuda
def test_fused_kernel_is_deterministic(cuda_nvcc):
    ops = _mm_operands(cuda_nvcc, torch.bfloat16, 1000, 512, 256)
    assert torch.equal(cbr.fused_matmul_affine_relu(*ops),
                       cbr.fused_matmul_affine_relu(*ops))


@pytest.mark.cuda
def test_fused_kernel_rejects_what_it_does_not_take(cuda_nvcc):
    x, w, scale, bias = _mm_operands(cuda_nvcc, torch.bfloat16, 64, 32, 16)
    cases = [
        ((x.half(), w.half(), scale, bias), "dtype"),
        ((x, w.float(), scale, bias), "dtype"),
        ((x, w[:16], scale, bias), "w"),
        ((x.t().contiguous().t(), w, scale, bias), "contiguous"),
        ((x, w, scale.bfloat16(), bias), "scale"),
        ((x, w, scale, bias[:8]), "bias"),
        ((x, w.cpu(), scale, bias), "device"),
    ]
    for args, match in cases:
        with pytest.raises(MXNetError, match=match):
            cbr.fused_matmul_affine_relu(*args)


@pytest.mark.cuda
def test_resnet_on_card_matches_cpu(cuda_nvcc):
    """The narrow ResNetV1 with the same weights on the card (one fused
    launch per bottleneck) and on the CPU (the plain version): f32
    logits within 1e-4 of the largest (no TF32)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def make():
        return resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                               [8, 32, 64, 128, 256], classes=10)

    mx.random.seed(0)
    cpu_net = make()
    cpu_net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    x = np.random.RandomState(0).normal(size=(2, 3, 32, 32)).astype("f")
    cpu_net(mx.nd.array(x, ctx=mx.cpu()))
    arrays = {k: p.data().asnumpy() for k, p in
              cpu_net._collect_params_with_prefix().items()}
    gpu_net = make()
    load_numpy_params(gpu_net, arrays, ctx=mx.gpu(0))
    before = cbr.fused_matmul_affine_relu.launches
    got = gpu_net(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    assert cbr.fused_matmul_affine_relu.launches == before + 4
    ref = cpu_net(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()

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


def _assert_rows_close(g, r, row_tol, norm_tol, zero_row=None):
    """Row by row (one query's O or dq, one key's dk or dv): the row's
    largest error within ``row_tol`` of the row's largest reference value,
    or of the dtype's smallest normal number where that is larger (f16
    rounds smaller values to a fixed step); and ||g - r|| / ||r|| <=
    norm_tol.  ``zero_row``: a row that is 0 in exact arithmetic and
    rounding noise in both g and r (``_dq_zero_row``), held within
    ``row_tol`` of the tensor's largest reference value instead."""
    diff = (g.float() - r).abs()
    floor = torch.finfo(g.dtype).tiny
    allowed = row_tol * r.abs().amax(-1).clamp_min(floor)
    if zero_row is not None:
        allowed[..., zero_row] = row_tol * r.abs().max()
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
    # D = 48 runs padded to 64 (test_padded_head_dims_match_plain_on_card);
    # above 128 there is no instance
    q = torch.zeros(1, 1, 8, 200, device=cuda_nvcc)
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


def _dq_zero_row(causal, tq, tk):
    """The query that sees key 0 alone (causal, Tq >= Tk): there P = 1 and
    O = V_0, so dP - δ cancels and its dq is 0 in exact arithmetic.  The
    kernel and the plain version each compute dP and δ = rowsum(dO·O) as
    f32 sums in their own orders, so their dq rows are rounding noise of
    about 1e-7 (they agreed bit for bit only while the FMA kernel summed in
    cuBLAS's order)."""
    return tq - tk if causal and tq >= tk else None


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
    kernels = (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv)
    before = [(fn.launches, fn.launches_mma) for fn in kernels]
    (q, k, v, o, do, lse), got = _backward_case(cuda_nvcc, dtype, 2, 3, tq,
                                                tk, d, causal)
    torch.cuda.synchronize()
    assert [(fn.launches, fn.launches_mma) for fn in kernels] == \
        [(n + 1, n_mma + mma) for n, n_mma in before]
    ref = tfa._fa_backward_plain(q.float(), k.float(), v.float(), o.float(),
                                 do.float(), lse, causal, 0.3)
    zero_rows = (_dq_zero_row(causal, tq, tk), None, None)
    for g, r, zero_row in zip(got, ref, zero_rows):
        assert g.dtype == dtype and g.shape == r.shape
        assert bool(torch.isfinite(g).all())
        _assert_rows_close(g, r, row_tol, norm_tol, zero_row)
    if causal and tq > tk:  # rows 0 .. tq - tk - 1 see no key: dq is 0
        assert bool((got[0][:, :, :tq - tk] == 0).all())


@pytest.mark.cuda
def test_backward_kernels_are_deterministic(cuda_nvcc):
    """Each output tile has one owner block and no atomics: two runs give
    the same bits (bf16: the tensor-core dQ and dK/dV kernels)."""
    before = tfa.flash_attention_bwd_dq.launches_mma
    _, first = _backward_case(cuda_nvcc, torch.bfloat16, 1, 4, 300, 300,
                              128, True)
    _, second = _backward_case(cuda_nvcc, torch.bfloat16, 1, 4, 300, 300,
                               128, True)
    assert tfa.flash_attention_bwd_dq.launches_mma == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# Head dims between the kernel instances (16/32/64/128): the wrappers
# zero-pad D to the next instance and slice the results back, exact
# because the scale is passed explicitly.  The same tolerances as the
# instance dims, forward and backward, against the plain versions on the
# unpadded f32 copies, at the models' scale 1/sqrt(D) (the wrappers'
# default, from the unpadded D).  Not at the fixed 0.3 of SHAPES: at D =
# 96 that makes some softmax rows nearly one-hot, where dq cancels to
# f32 rounding noise as in the zero row, and the plain version itself
# misses the row tolerance by 400x against an f64 dense reference.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,row_tol,norm_tol,g_row_tol,g_norm_tol", [
    (torch.float32, 1e-4, 1e-4, 1e-5, 1e-4, 1e-5),
    (torch.bfloat16, 2e-2, 2 * 2.0 ** -8, 2 * 2.0 ** -8, 1e-2, 5e-3)])
@pytest.mark.parametrize("d", [24, 48, 80, 96])
def test_padded_head_dims_match_plain_on_card(cuda_nvcc, dtype, tol,
                                              row_tol, norm_tol, g_row_tol,
                                              g_norm_tol, d):
    causal, tq, tk = True, 150, 150
    scale = 1.0 / np.sqrt(d)
    fns = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
           tfa.flash_attention_bwd_dkv)
    before = [fn.launches for fn in fns]
    q, k, v = (torch.from_numpy(a).to(cuda_nvcc, dtype)
               for a in _qkv(7, 2, 3, tq, tk, d))
    do = torch.from_numpy(np.random.RandomState(8).normal(
        size=(2, 3, tq, d)).astype(np.float32)).to(cuda_nvcc, dtype)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    got = tfa.flash_attention_bwd(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fns] == [n + 1 for n in before]
    o_ref, lse_ref = tfa._fa_forward_plain(q.float(), k.float(), v.float(),
                                           causal, scale)
    assert o.shape == q.shape and o.dtype == dtype
    assert (o.float() - o_ref).abs().max().item() <= tol
    _assert_rows_close(o, o_ref, row_tol, norm_tol)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    ref = tfa._fa_backward_plain(q.float(), k.float(), v.float(), o.float(),
                                 do.float(), lse, causal, scale)
    zero_rows = (_dq_zero_row(causal, tq, tk), None, None)
    for g, r, zero_row in zip(got, ref, zero_rows):
        assert g.dtype == dtype and g.shape == r.shape == q.shape
        _assert_rows_close(g, r, g_row_tol, g_norm_tol, zero_row)


@pytest.mark.cuda
def test_backward_rejects_what_it_does_not_take(cuda_nvcc):
    q = torch.zeros(1, 1, 8, 200, device=cuda_nvcc)
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
                                           (torch.bfloat16, 2.0 ** -8, 1e-4),
                                           (torch.float16, 2.0 ** -11, 1e-4)])
@pytest.mark.parametrize("m,k,n", [
    (6272, 64, 64), (6272, 256, 64), (1568, 256, 128), (1568, 512, 128),
    (392, 512, 256), (392, 1024, 256), (98, 1024, 512), (98, 2048, 512),
    (49, 100, 30), (1, 7, 3), (130, 17, 65), (300, 40, 200)])
def test_fused_kernel_matches_plain_on_card(cuda_nvcc, dtype, rel, tol, m,
                                            k, n):
    x, w, scale, bias = _mm_operands(cuda_nvcc, dtype, m, k, n)
    fn = cbr.fused_matmul_affine_relu
    before = (fn.launches, fn.launches_mma)
    got = fn(x, w, scale, bias)
    torch.cuda.synchronize()
    # bf16 and f16 on the tensor cores at every shape, ragged ones included
    assert (fn.launches, fn.launches_mma) == \
        (before[0] + 1, before[1] + int(dtype != torch.float32))
    ref = cbr._fused_matmul_affine_relu_plain(x.float(), w.float(), scale,
                                              bias)
    assert got.dtype == dtype and got.shape == (m, n)
    diff = (got.float() - ref).abs()
    assert bool((diff <= rel * ref.abs() + tol * ref.abs().max()).all()), \
        diff.max().item()
    assert bool((got[ref == 0] == 0).all())  # the ReLU clamps the same


@pytest.mark.cuda
def test_fused_kernel_takes_misaligned_operands(cuda_nvcc):
    """x at a storage offset of one element (not 16-byte aligned): the
    tensor-core kernel loads it element by element, with the same
    result as from an aligned copy."""
    x, w, scale, bias = _mm_operands(cuda_nvcc, torch.bfloat16, 200, 64, 64)
    buf = torch.empty(1 + x.numel(), device=cuda_nvcc, dtype=x.dtype)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    assert torch.equal(cbr.fused_matmul_affine_relu(shifted, w, scale, bias),
                       cbr.fused_matmul_affine_relu(x, w, scale, bias))


@pytest.mark.cuda
def test_fused_kernel_is_deterministic(cuda_nvcc):
    ops = _mm_operands(cuda_nvcc, torch.bfloat16, 1000, 512, 256)
    assert torch.equal(cbr.fused_matmul_affine_relu(*ops),
                       cbr.fused_matmul_affine_relu(*ops))


@pytest.mark.cuda
def test_fused_kernel_rejects_what_it_does_not_take(cuda_nvcc):
    x, w, scale, bias = _mm_operands(cuda_nvcc, torch.bfloat16, 64, 32, 16)
    cases = [
        ((x.double(), w.double(), scale, bias), "dtype"),
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


@pytest.mark.cuda
def test_resnet_f16_on_card_runs_the_fused_kernel(cuda_nvcc):
    """After ``cast("float16")`` the narrow ResNetV1's inference forward
    on the card takes the f16 instance of the tensor-core kernel (one
    launch per bottleneck) and stays within f16 rounding of the same net
    in f32."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    mx.random.seed(1)
    net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                          [8, 32, 64, 128, 256], classes=10)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    x = np.random.RandomState(3).normal(size=(2, 3, 32, 32))
    ref = net(mx.nd.array(x.astype("f"), ctx=mx.gpu(0))).asnumpy()
    net.cast("float16")
    fn = cbr.fused_matmul_affine_relu
    before = (fn.launches, fn.launches_mma)
    got = net(mx.nd.array(x.astype(np.float16), ctx=mx.gpu(0),
                          dtype="float16"))
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_mma) == (before[0] + 4, before[1] + 4)
    assert got.dtype == torch.float16
    got = got.asnumpy().astype(np.float32)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_paged_engine_step_on_card_matches_cpu(cuda_nvcc, int8):
    """``llama_tiny`` with the same weights on the card and on the CPU:
    the paged engine's prefill, KV handoff into the block pool and four
    decode steps give the same tokens, and the pool the same K/V within
    f32 rounding; also with int8 weights, dequantized matmul by
    matmul."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.models import llama_tiny
    from mxnet_tpu_torch.serving import LlamaServingEngine
    from mxnet_tpu_torch.serving import PagedKVCacheManager

    mx.random.seed(2)
    cpu_net = llama_tiny()
    cpu_net.initialize(ctx=mx.cpu())
    arrays = {k: p.data().asnumpy() for k, p in
              cpu_net._collect_params_with_prefix().items()}
    gpu_net = llama_tiny()
    load_numpy_params(gpu_net, arrays, ctx=mx.gpu(0))
    prompts = np.random.RandomState(1).randint(1, 250, (2, 16)) \
        .astype(np.int32)
    t0s = np.array([16, 11], np.int32)
    runs = []
    for net in (cpu_net, gpu_net):
        eng = LlamaServingEngine(net, max_len=64, num_slots=2, int8=int8,
                                 kv_mode="paged", block_size=8)
        mgr = PagedKVCacheManager(2, 64, eng.num_blocks, 8)
        admitted = [mgr.admit(i, int(t0s[i]), 8) for i in range(2)]
        slots = np.array([s for s, _ in admitted], np.int32)
        toks, rows = eng.prefill_rows(prompts, t0s)
        first = toks.cpu().numpy()
        eng.commit_rows(rows, slots, [b for _, b in admitted], t0s, first)
        steps = [eng.step(list(slots)).copy() for _ in range(4)]
        pool = eng._pool[1][0][:eng.num_blocks].float().cpu()
        runs.append((first, steps, pool))
    assert str(gpu_net.model.embed_tokens.weight.data()._data.device) \
        == "cuda:0"
    (f_cpu, s_cpu, p_cpu), (f_gpu, s_gpu, p_gpu) = runs
    np.testing.assert_array_equal(f_gpu, f_cpu)
    for a, b in zip(s_gpu, s_cpu):
        np.testing.assert_array_equal(a, b)
    assert (p_gpu - p_cpu).abs().max().item() <= 1e-4 * \
        p_cpu.abs().max().item()


# -- slice 7: the fused multi-tensor update and the CUDA graphs ---------------

_MT_SIZES = [1, 7, 4097, 16389, 3 * 16384]
_MT_RULES = [("sgd", {}), ("sgd", {"momentum": 0.9}),
             ("nag", {"momentum": 0.9}), ("adam", {}), ("adamw", {})]


def _ulps(got, ref, dtype):
    """|got - ref| in units of ``dtype``'s spacing at ``ref`` (the
    smallest subnormal step below the normal range), as float64."""
    got, ref = got.double(), ref.double()
    eps = torch.finfo(dtype).eps
    _, e = torch.frexp(ref)
    ulp = torch.ldexp(torch.full_like(ref, eps), e - 1).clamp_min(
        torch.finfo(dtype).smallest_normal * eps)
    return ((got - ref).abs() / ulp).max().item()


def _mt_items(device, wdtype, mp, rule_states, seed):
    """Weights, gradients, states and masters at the ragged sizes."""
    from mxnet_tpu_torch.ops import multi_tensor as mt

    rng = np.random.RandomState(seed)
    items = []
    for n in _MT_SIZES:
        w32 = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        g = torch.from_numpy((2 * rng.normal(size=n)).astype(np.float32))
        w = w32.to(device, wdtype)
        master = w.float().clone() if mp else None
        # NAG keeps its momentum in the weight's dtype, the others in f32
        sdt = wdtype if rule_states == "nag" and not mp else torch.float32
        n_states = {"sgd": 0, "mom": 1, "nag": 1, "adam": 2}[rule_states]
        states = tuple(
            torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32)
                             * 0.1).to(device, sdt) for _ in range(n_states))
        items.append(mt.UpdateItem(w, g.to(device, wdtype), states, master,
                                   0.0, 0.0, 0))
    return items


# Each rule of the kernel against its plain version (the optimizer's
# per-tensor ``_step``, run by torch on the card) over three steps with an
# lr schedule, rescale, clipping and weight decay on: weights within 1 ulp
# of their dtype, f32 states and masters within 2 f32 ulps (the kernel
# rounds where the plain rule's ops round; Adam's lr_t is computed in
# double on both sides).
@pytest.mark.cuda
@pytest.mark.parametrize("wdtype,mp", [(torch.float32, False),
                                       (torch.bfloat16, False),
                                       (torch.bfloat16, True),
                                       (torch.float16, False)])
@pytest.mark.parametrize("name,kw", _MT_RULES)
def test_multi_tensor_kernel_matches_plain_on_card(cuda_nvcc, name, kw,
                                                   wdtype, mp):
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import multi_tensor as mt

    opt = topt.create(name, multi_precision=mp, rescale_grad=0.5,
                      clip_gradient=1.5, **kw)
    kind = {"sgd": "mom" if kw else "sgd", "nag": "nag"}.get(name, "adam")
    ker = _mt_items(cuda_nvcc, wdtype, mp, kind, seed=5)
    ref = [mt.UpdateItem(it.w.clone(), it.g, tuple(s.clone()
                                                   for s in it.states),
                         None if it.master is None else it.master.clone(),
                         0.0, 0.0, 0) for it in ker]
    before = mt.multi_tensor_update.launches
    for step, lr in enumerate((0.1, 0.05, 0.025)):
        sched = [it._replace(lr=lr * (1 + j % 2), wd=0.01 * (j % 3),
                             t=step + 1) for j, it in enumerate(ker)]
        mt.multi_tensor_update(opt, sched)
        mt._update_plain(opt, [r._replace(lr=s.lr, wd=s.wd, t=s.t)
                               for r, s in zip(ref, sched)])
    torch.cuda.synchronize()
    assert mt.multi_tensor_update.launches == before + 3
    for k, r in zip(ker, ref):
        assert _ulps(k.w, r.w, wdtype) <= 1, (k.w.numel(), "weight")
        for a, b in zip(k.states, r.states):
            assert _ulps(a, b, a.dtype) <= (2 if a.dtype == torch.float32
                                            else 1), (a.numel(), "state")
        if mp:
            assert _ulps(k.master, r.master, torch.float32) <= 2


@pytest.mark.cuda
def test_multi_tensor_kernel_rejects_what_it_does_not_take(cuda_nvcc):
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import multi_tensor as mt

    opt = topt.create("sgd", momentum=0.9)
    w = torch.zeros(8, device=cuda_nvcc)
    mom = torch.zeros(8, device=cuda_nvcc)
    bad = [
        mt.UpdateItem(w.double(), w.double(), (mom,), None, 0.1, 0.0, 1),
        mt.UpdateItem(w, w.half(), (mom,), None, 0.1, 0.0, 1),
        mt.UpdateItem(w, w, (), None, 0.1, 0.0, 1),  # no momentum state
        mt.UpdateItem(torch.zeros(4, 4, device=cuda_nvcc).t(),
                      torch.zeros(4, 4, device=cuda_nvcc).t(),
                      (torch.zeros(4, 4, device=cuda_nvcc),), None, 0.1,
                      0.0, 1),
        mt.UpdateItem(w, w.cpu(), (mom,), None, 0.1, 0.0, 1)]
    for item in bad:
        with pytest.raises(MXNetError):
            mt.multi_tensor_update(opt, [item])


def _mlp(mx, ctx, seed, bn=True):
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, in_units=8, activation="relu"))
    if bn:
        net.add(mx.gluon.nn.BatchNorm(in_channels=16))
    net.add(mx.gluon.nn.Dense(4, in_units=16))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def _copy_params(src, dst):
    for (_, a), (_, b) in zip(src.collect_params().items(),
                              dst.collect_params().items()):
        b.set_data(a.data())


@pytest.mark.cuda
def test_trainer_step_is_one_fused_launch_on_card(cuda_nvcc):
    """``Trainer.step`` on card parameters updates every tensor in one
    launch, and equals the NaiveEngine's tensor-by-tensor route."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import multi_tensor as mt

    ctx = mx.gpu(0)
    nets = [_mlp(mx, ctx, 3), _mlp(mx, ctx, 4)]
    _copy_params(nets[0], nets[1])
    x = mx.nd.array(np.random.RandomState(0).normal(size=(8, 8)).astype(
        np.float32), ctx=ctx)
    y = mx.nd.array((np.arange(8) % 4).astype(np.float32), ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for net, engine in zip(nets, ("ThreadedEnginePerDevice",
                                  "NaiveEngine")):
        mx.engine.set_engine_type(engine)
        try:
            tr = mx.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 0.01, "wd": 1e-3})
            before = mt.multi_tensor_update.launches
            for _ in range(3):
                with mx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                tr.step(8)
            launched = mt.multi_tensor_update.launches - before
        finally:
            mx.engine.set_engine_type("ThreadedEnginePerDevice")
        assert launched == (3 if engine != "NaiveEngine" else 0)
    for (_, a), (_, b) in zip(nets[0].collect_params().items(),
                              nets[1].collect_params().items()):
        assert _ulps(a.data()._data, b.data()._data, torch.float32) <= 2


def _narrow_resnet(mx, ctx, seed=0):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    mx.random.seed(seed)
    net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                          [8, 32, 64, 128, 256], classes=10)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(mx.nd.zeros((1, 3, 32, 32), ctx=ctx))
    return net


@pytest.mark.cuda
def test_hybridized_block_replays_its_graph_on_card(cuda_nvcc):
    """A hybridized narrow ResNetV1: the first call of a signature
    captures, the later ones replay; each replay counts its 4 fused
    launches; the outputs are the eager forward's bit for bit (the same
    kernels); a new batch size is a new signature."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    net = _narrow_resnet(mx, ctx)
    rng = np.random.RandomState(1)
    xs = [mx.nd.array(rng.normal(size=(2, 3, 32, 32)).astype(np.float32),
                      ctx=ctx) for _ in range(3)]
    eager = [net(x).asnumpy() for x in xs]
    net.hybridize(static_alloc=True, static_shape=True)
    fn = cbr.fused_matmul_affine_relu
    for x, ref in zip(xs, eager):
        before = fn.launches
        got = net(x).asnumpy()
        assert fn.launches == before + 4
        np.testing.assert_array_equal(got, ref)
    assert net.cache_stats() == {"hits": 2, "misses": 1, "signatures": 1,
                                 "recorded": 0}
    net(mx.nd.array(rng.normal(size=(4, 3, 32, 32)).astype(np.float32),
                    ctx=ctx))
    assert net.cache_stats()["signatures"] == 2


@pytest.mark.cuda
def test_hybridized_block_captures_again_after_cast_and_load(cuda_nvcc,
                                                             tmp_path):
    """``cast`` moves the parameters: the next call captures again and
    equals a fresh eager net in bf16; ``load_parameters`` copies in place:
    the graph reads the loaded weights."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    net = _narrow_resnet(mx, ctx, seed=0)
    other = _narrow_resnet(mx, ctx, seed=5)
    x = mx.nd.array(np.random.RandomState(2).normal(
        size=(2, 3, 32, 32)).astype(np.float32), ctx=ctx)
    net.hybridize()
    net(x)
    net(x)
    net.cast("bfloat16")
    xb = x.astype("bfloat16")
    fresh = _narrow_resnet(mx, ctx, seed=0)
    fresh.cast("bfloat16")
    np.testing.assert_array_equal(net(xb).asnumpy(), fresh(xb).asnumpy())
    np.testing.assert_array_equal(net(xb).asnumpy(), fresh(xb).asnumpy())
    assert net.cache_stats()["misses"] == 2
    other.cast("bfloat16")
    other.save_parameters(str(tmp_path / "other.params"))
    net.load_parameters(str(tmp_path / "other.params"))
    np.testing.assert_array_equal(net(xb).asnumpy(), other(xb).asnumpy())


def _tiny_llama(mx, ctx, seed=0, dtype=None):
    from mxnet_tpu_torch.models import llama_tiny

    mx.random.seed(seed)
    net = llama_tiny()
    net.initialize(ctx=ctx)
    if dtype:
        net.cast(dtype)
    return net


def _eager_decode(mx, dec, ids, n, **kw):
    """``dec.generate`` with eager decode steps (the NaiveEngine)."""
    prev = mx.engine.engine_type()
    mx.engine.set_engine_type("NaiveEngine")
    try:
        return dec.generate(ids, n, **kw)
    finally:
        mx.engine.set_engine_type(prev)


@pytest.mark.cuda
def test_generate_replays_decode_graphs_on_card(cuda_nvcc, tmp_path):
    """``generate`` on the card replays a captured decode step: greedy
    tokens equal the eager decoder's at B=1 and B=3; after ``cast`` the
    graph is captured again and equals a fresh net's; after
    ``load_parameters`` it equals the loaded net's; seeded sampling gives
    the same tokens twice."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    net = _tiny_llama(mx, ctx)
    rng = np.random.RandomState(4)
    for b in (1, 3):
        ids = mx.nd.array(rng.randint(1, 250, (b, 12)), ctx=ctx,
                          dtype="int32")
        got = net.generate(ids, max_new_tokens=10).asnumpy()
        dec = net._kv_decoders[64]
        ref = _eager_decode(mx, dec, ids._data, 10).cpu().numpy()
        np.testing.assert_array_equal(got, ref)
    ids = mx.nd.array(rng.randint(1, 250, (2, 12)), ctx=ctx, dtype="int32")
    net.generate(ids, max_new_tokens=10)
    net.cast("bfloat16")
    fresh = _tiny_llama(mx, ctx, dtype="bfloat16")
    np.testing.assert_array_equal(
        net.generate(ids, max_new_tokens=10).asnumpy(),
        fresh.generate(ids, max_new_tokens=10).asnumpy())
    other = _tiny_llama(mx, ctx, seed=9, dtype="bfloat16")
    other.save_parameters(str(tmp_path / "other.params"))
    net.load_parameters(str(tmp_path / "other.params"))
    np.testing.assert_array_equal(
        net.generate(ids, max_new_tokens=10).asnumpy(),
        other.generate(ids, max_new_tokens=10).asnumpy())
    s1 = net.generate(ids, max_new_tokens=10, do_sample=True, seed=3,
                      top_k=20).asnumpy()
    s2 = net.generate(ids, max_new_tokens=10, do_sample=True, seed=3,
                      top_k=20).asnumpy()
    np.testing.assert_array_equal(s1, s2)
    assert ((s1 >= 0) & (s1 < 256)).all()


@pytest.mark.cuda
def test_generate_keeps_one_decode_state_per_batch_on_card(cuda_nvcc):
    """Sampled ``generate`` at several temperatures and top_p values:
    tokens equal the eager decoder's with the same seed, and the batch
    keeps one state (one set of caches) with one graph for the nucleus
    and one without, whatever the values; the decoder keeps the states
    of 4 batch sizes at most."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    net = _tiny_llama(mx, ctx)
    rng = np.random.RandomState(16)
    ids = mx.nd.array(rng.randint(1, 250, (2, 12)), ctx=ctx, dtype="int32")
    for temperature, top_p in ((0.7, 0.9), (1.3, 0.95), (1.0, 1.0),
                               (2.0, 1.0)):
        kw = dict(do_sample=True, seed=5, temperature=temperature,
                  top_p=top_p)
        got = net.generate(ids, max_new_tokens=10, **kw).asnumpy()
        dec = net._kv_decoders[64]
        ref = _eager_decode(mx, dec, ids._data, 10, **kw).cpu().numpy()
        np.testing.assert_array_equal(got, ref)
    states = dec._decode_states
    assert list(states) == [2] and len(states[2]["graphs"]) == 2
    static, pool = dec.decode_graph_bytes()
    caches = sum(t.numel() * t.element_size()
                 for kv in states[2]["caches"] for t in kv)
    assert static > caches > 0 and pool > 0
    for b in (1, 3, 4, 5):
        net.generate(mx.nd.array(rng.randint(1, 250, (b, 12)), ctx=ctx,
                                 dtype="int32"), max_new_tokens=10)
    assert list(states) == [1, 3, 4, 5]


def _fused_vs_eager(mx, make, batch, k, opt, kw, batch_size):
    """K eager ``Trainer.step``s on one net and a ``FusedTrainStep`` of K
    on a copy → (eager losses, fused losses, eager net, fused net, the
    fused step)."""
    nets = [make(), make()]
    _copy_params(nets[0], nets[1])
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = batch
    tr = mx.gluon.Trainer(nets[0].collect_params(), opt, dict(kw))
    eager = []
    for _ in range(k):
        with mx.autograd.record():
            loss = loss_fn(nets[0](x), y)
        loss.backward()
        tr.step(batch_size)
        eager.append(float(loss.sum().asscalar()))
    tr2 = mx.gluon.Trainer(nets[1].collect_params(), opt, dict(kw))
    fstep = mx.gluon.FusedTrainStep(
        nets[1], tr2, lambda n, a, b: loss_fn(n(a), b),
        steps_per_execution=k, batch_size=batch_size)
    fused = fstep(x, y).asnumpy()
    return np.array(eager), fused, nets[0], nets[1], fstep


@pytest.mark.cuda
def test_fused_train_step_graph_matches_eager_on_card(cuda_nvcc):
    """``FusedTrainStep`` on the card (step 0 eager, then K - 1 graph
    replays; a second call K replays of the same graph) equals K eager
    ``Trainer.step``s: losses and weights, BatchNorm's moving statistics
    included, within 1e-5 (f32, the same kernels; cuDNN may sum in
    another order between the two)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import multi_tensor as mt

    ctx = mx.gpu(0)
    rng = np.random.RandomState(6)
    batch = (mx.nd.array(rng.normal(size=(8, 8)).astype(np.float32),
                         ctx=ctx),
             mx.nd.array(rng.randint(0, 4, 8).astype(np.float32), ctx=ctx))
    before = mt.multi_tensor_update.launches
    eager, fused, net_e, net_f, fstep = _fused_vs_eager(
        mx, lambda: _mlp(mx, ctx, 7), batch, 4, "sgd",
        {"learning_rate": 0.1, "momentum": 0.9}, 8)
    np.testing.assert_allclose(fused, eager, rtol=1e-5, atol=1e-6)
    for (n, a), (_, b) in zip(net_e.collect_params().items(),
                              net_f.collect_params().items()):
        np.testing.assert_allclose(b.data().asnumpy(), a.data().asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    assert mt.multi_tensor_update.launches - before == 8  # 4 + 4
    entry, = fstep._graphs.values()
    fstep(*batch)
    assert entry["graph"].replays == 3 + 4 and len(fstep._graphs) == 1


@pytest.mark.cuda
def test_fused_train_step_honours_an_lr_schedule_without_capture(cuda_nvcc):
    """The lr of a schedule changes between calls: the graph is not
    captured again (lr, wd and t live in the update's device table), and
    the weights equal the CPU's unrolled route from the same weights."""
    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(8)
    xs = rng.normal(size=(8, 8)).astype(np.float32)
    ys = rng.randint(0, 4, 8).astype(np.float32)
    cpu_net = _mlp(mx, mx.cpu(), 9, bn=False)
    results = []
    for ctx in (mx.gpu(0), mx.cpu()):
        net = _mlp(mx, ctx, 9, bn=False)
        _copy_params(cpu_net, net)  # each device draws its own init
        sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5,
                                                base_lr=0.2)
        tr = mx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 0.2, "lr_scheduler": sched})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        fstep = mx.gluon.FusedTrainStep(
            net, tr, lambda n, a, b: loss_fn(n(a), b),
            steps_per_execution=2, batch_size=8)
        x, y = mx.nd.array(xs, ctx=ctx), mx.nd.array(ys, ctx=ctx)
        losses = [fstep(x, y).asnumpy() for _ in range(3)]
        results.append((losses, [p.data().asnumpy() for p in
                                 net.collect_params().values()]))
        if ctx.device.type == "cuda":
            assert len(fstep._graphs) == 1
    (lg, wg), (lc, wc) = results
    np.testing.assert_allclose(np.concatenate(lg), np.concatenate(lc),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(wg, wc):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_fused_train_step_counts_flash_launches_through_replays(cuda_nvcc):
    """``llama_tiny`` (2 layers) in a ``FusedTrainStep`` of K = 3: the
    flash forward, dQ and dK/dV kernels run inside the graph, and their
    counters say 2 launches a step each (the warm-up step and two
    replays); the losses equal eager steps'."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    vocab = 256
    ids = np.random.RandomState(10).randint(0, vocab, (2, 33))
    x = mx.nd.array(ids[:, :-1], ctx=ctx, dtype="int32")
    y = mx.nd.array(ids[:, 1:].astype(np.float32), ctx=ctx)

    def make():
        return _tiny_llama(mx, ctx, seed=11)

    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def lm_loss(n, a, b):
        return loss_fn(n(a).reshape((-1, vocab)), b.reshape((-1,)))

    nets = [make(), make()]
    tr = mx.gluon.Trainer(nets[0].collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9})
    eager = []
    for _ in range(3):
        with mx.autograd.record():
            loss = lm_loss(nets[0], x, y)
        loss.backward()
        tr.step(64)
        eager.append(float(loss.sum().asscalar()))
    tr2 = mx.gluon.Trainer(nets[1].collect_params(), "sgd",
                           {"learning_rate": 0.05, "momentum": 0.9})
    fstep = mx.gluon.FusedTrainStep(nets[1], tr2, lm_loss,
                                    steps_per_execution=3, batch_size=64)
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    fused = fstep(x, y).asnumpy()
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [6] * 3
    np.testing.assert_allclose(fused, eager, rtol=1e-5)


@pytest.mark.cuda
def test_fused_train_step_draws_fresh_random_numbers_per_replay(cuda_nvcc):
    """A loss that draws from the package's generator (as a dropout mask
    would) inside a ``FusedTrainStep``: at lr 0 only the draws change the
    loss, and every replay of the graph draws anew."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import NDArray

    ctx = mx.gpu(0)
    net = _mlp(mx, ctx, 12, bn=False)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.0})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    gen = mx.random.generator(ctx.device)

    def noisy_loss(n, a, b):
        noise = torch.rand(a.shape[0], generator=gen, device=ctx.device)
        return loss_fn(n(a), b) + NDArray(noise)

    rng = np.random.RandomState(13)
    x = mx.nd.array(rng.normal(size=(8, 8)).astype(np.float32), ctx=ctx)
    y = mx.nd.array(rng.randint(0, 4, 8).astype(np.float32), ctx=ctx)
    fstep = mx.gluon.FusedTrainStep(net, tr, noisy_loss,
                                    steps_per_execution=6, batch_size=8)
    losses = np.concatenate([fstep(x, y).asnumpy() for _ in range(2)])
    assert len(np.unique(losses)) == len(losses), losses


def _noisy_step(mx, ctx, lr):
    """A ``FusedTrainStep`` (K = 3) whose loss draws from the package's
    generator of the card (as a dropout mask would), with its batch."""
    from mxnet_tpu_torch.ndarray import NDArray

    net = _mlp(mx, ctx, 14, bn=False)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": lr, "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def noisy_loss(n, a, b):
        noise = torch.rand(a.shape[0], device=ctx.device,
                           generator=mx.random.generator(ctx.device))
        return loss_fn(n(a), b) + NDArray(noise)

    rng = np.random.RandomState(15)
    x = mx.nd.array(rng.normal(size=(8, 8)).astype(np.float32), ctx=ctx)
    y = mx.nd.array(rng.randint(0, 4, 8).astype(np.float32), ctx=ctx)
    fstep = mx.gluon.FusedTrainStep(net, tr, noisy_loss,
                                    steps_per_execution=3, batch_size=8)
    return net, tr, fstep, (x, y)


@pytest.mark.cuda
def test_seed_reaches_the_draws_of_a_captured_step(cuda_nvcc):
    """``mx.random.seed`` after a ``FusedTrainStep`` captured its graph
    reaches the draws inside the replays: at lr 0 only the draws change
    the loss, and a call after the same seed repeats them."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    net, tr, fstep, batch = _noisy_step(mx, ctx, 0.0)
    gen = mx.random.generator(ctx.device)
    fstep(*batch)  # the capture
    mx.random.seed(3)
    first = fstep(*batch).asnumpy()
    second = fstep(*batch).asnumpy()
    mx.random.seed(3)
    again = fstep(*batch).asnumpy()
    assert mx.random.generator(ctx.device) is gen
    np.testing.assert_array_equal(again, first)
    assert not np.array_equal(second, first)
    assert len(fstep._graphs) == 1


@pytest.mark.cuda
def test_resume_into_a_captured_step_continues_the_run(cuda_nvcc,
                                                       tmp_path):
    """A checkpoint resumed into the net, trainer and ``FusedTrainStep``
    that wrote it (its graph already captured) gives the uninterrupted
    run's next losses and weights, draws included, bit for bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint

    ctx = mx.gpu(0)
    mx.random.seed(4)
    net, tr, fstep, batch = _noisy_step(mx, ctx, 0.05)
    fstep(*batch)
    checkpoint.save_checkpoint(str(tmp_path), 3, net, tr)
    straight = fstep(*batch).asnumpy()
    weights = [p.data().asnumpy() for p in net.collect_params().values()]
    assert checkpoint.resume(str(tmp_path), net, tr)[0] == 3
    resumed = fstep(*batch).asnumpy()
    np.testing.assert_array_equal(resumed, straight)
    for a, p in zip(weights, net.collect_params().values()):
        np.testing.assert_array_equal(p.data().asnumpy(), a)
    assert len(fstep._graphs) == 1

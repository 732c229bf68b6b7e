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


# -- slice 8: BERT's attention, Dropout in a captured step, InferenceServer --

def _bert_qkv(device, seed, b=64, t=128, n=12, h=64):
    """(B, T, N, H) bf16 operands at BERT-base's attention shape."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.randn(b, t, n, h, generator=g, device=device,
                        dtype=torch.bfloat16) for _ in range(3)]


@pytest.mark.cuda
def test_sdpa_raw_at_bert_shape_runs_the_tensor_core_kernels(cuda_nvcc):
    """B·N·T·H = 64·12·128·64, non-causal, bf16, unmasked: one launch of
    each flash kernel's tensor-core design (forward, then dQ and dK/dV
    in the backward); O and the three gradients against the plain masked
    route (no mask) on f32 copies of the same inputs, row by row, within
    the tolerances the flash kernels are held to at bf16 (O: 2u a row and
    in norm; gradients: 1e-2 of a row, 5e-3 in norm)."""
    from mxnet_tpu_torch.ops import attention as tatt

    q, k, v = (t.requires_grad_() for t in _bert_qkv(cuda_nvcc, 0))
    do = _bert_qkv(cuda_nvcc, 1)[0]
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv)
    before = [c.launches_mma for c in counters]
    out = tatt.sdpa_raw(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert [c.launches_mma - n for c, n in zip(counters, before)] == [1] * 3
    ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = tatt._sdpa_plain(*ref_in, None, 0.125, False)
    ref_grads = torch.autograd.grad(ref, ref_in, do.float())
    _assert_rows_close(out.detach(), ref.detach(), 2 * 2.0 ** -8,
                       2 * 2.0 ** -8)
    for g, r in zip(grads, ref_grads):
        assert g.dtype == torch.bfloat16
        _assert_rows_close(g, r, 1e-2, 5e-3)


@pytest.mark.cuda
def test_masked_attention_launches_no_kernel_on_card(cuda_nvcc):
    """A padding mask (BERT's (B, 1, 1, T) with ``valid_length``, and a
    row with no key): the plain route, no flash launch, finite, and the
    row that sees no key is the mean of V (within one bf16 step)."""
    from mxnet_tpu_torch.ops import attention as tatt

    q, k, v = _bert_qkv(cuda_nvcc, 2, b=4, t=128, n=2)
    lengths = torch.tensor([128, 77, 5, 1], device=cuda_nvcc)
    mask = (torch.arange(128, device=cuda_nvcc)[None, None, None, :] <
            lengths[:, None, None, None]).float()
    full = torch.ones(4, 1, 128, 128, dtype=torch.bool, device=cuda_nvcc)
    full[2, :, 9, :] = False
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    out = tatt.sdpa_raw(q, k, v, mask)
    out2 = tatt.sdpa_raw(q, k, v, full)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before
    assert bool(torch.isfinite(out).all() and torch.isfinite(out2).all())
    mean_v = v[2].float().mean(0)
    assert torch.allclose(out2[2, 9].float(), mean_v,
                          atol=2.0 ** -8 * mean_v.abs().max().item())
    # the masked batch row 3 (length 1) reads value 0 alone
    assert torch.equal(out[3], v[3, 0].expand_as(out[3]))


def _dropout_step(mx, ctx, lr, seed):
    """A ``FusedTrainStep`` (K = 4) of a net with a real ``Dropout``
    layer (p = 0.5) between two Dense layers, with its batch."""
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(64, in_units=8, activation="relu"),
            mx.gluon.nn.Dropout(0.5),
            mx.gluon.nn.Dense(4, in_units=64))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": lr, "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(seed)
    x = mx.nd.array(rng.normal(size=(16, 8)).astype(np.float32), ctx=ctx)
    y = mx.nd.array(rng.randint(0, 4, 16).astype(np.float32), ctx=ctx)
    fstep = mx.gluon.FusedTrainStep(net, tr, lambda n, a, b: loss_fn(n(a), b),
                                    steps_per_execution=4, batch_size=16)
    return net, tr, fstep, (x, y)


@pytest.mark.cuda
def test_fused_train_step_dropout_layer_draws_fresh_masks(cuda_nvcc,
                                                          tmp_path):
    """A Dropout layer inside a captured step: at lr 0 only its masks
    change the loss, and every replay draws a new one; after
    ``mx.random.seed`` the replays repeat the same masks; a checkpoint
    resumed into the captured step at lr > 0 continues the uninterrupted
    run bit for bit, masks included."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint

    ctx = mx.gpu(0)
    net, tr, fstep, batch = _dropout_step(mx, ctx, 0.0, 21)
    losses = np.concatenate([fstep(*batch).asnumpy() for _ in range(2)])
    assert len(np.unique(losses)) == len(losses), losses
    mx.random.seed(5)
    first = fstep(*batch).asnumpy()
    mx.random.seed(5)
    np.testing.assert_array_equal(fstep(*batch).asnumpy(), first)
    assert len(fstep._graphs) == 1

    net, tr, fstep, batch = _dropout_step(mx, ctx, 0.05, 22)
    fstep(*batch)
    checkpoint.save_checkpoint(str(tmp_path), 4, net, tr)
    straight = fstep(*batch).asnumpy()
    weights = [p.data().asnumpy() for p in net.collect_params().values()]
    assert checkpoint.resume(str(tmp_path), net, tr)[0] == 4
    np.testing.assert_array_equal(fstep(*batch).asnumpy(), straight)
    for a, p in zip(weights, net.collect_params().values()):
        np.testing.assert_array_equal(p.data().asnumpy(), a)


@pytest.mark.cuda
def test_inference_server_replays_resnet_graphs_on_card(cuda_nvcc):
    """A hybridized narrow ResNetV1 behind ``InferenceServer``: 12
    requests from 4 client threads, each reply equal to its solo forward;
    4 fused launches a batch forward, from the graphs; signatures within
    the policy's ceiling, one miss each."""
    import threading

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving

    ctx = mx.gpu(0)
    net = _narrow_resnet(mx, ctx)
    rng = np.random.RandomState(7)
    images = [rng.normal(size=(3, 32, 32)).astype(np.float32)
              for _ in range(12)]
    solo = [net(mx.nd.array(x[None], ctx=ctx)).asnumpy()[0]
            for x in images]
    net.hybridize(static_alloc=True)
    srv = serving.InferenceServer(net, serving.ServerConfig(
        max_batch=4, min_batch=4, max_length=32, min_length=32,
        length_axis=1, batch_window_ms=20.0))
    replies = [None] * len(images)

    def client(ids):
        for i in ids:
            replies[i] = srv.infer(images[i], timeout=120)

    fn = cbr.fused_matmul_affine_relu
    before = fn.launches
    with srv:
        threads = [threading.Thread(target=client, args=(range(j, 12, 4),))
                   for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    stats = srv.stats()
    assert stats["completed"] == 12 and stats["failed"] == 0
    assert fn.launches - before == 4 * stats["batches"]
    assert stats["cache"]["signatures"] <= stats["signature_ceiling"] == 1
    assert stats["cache"]["misses"] == stats["cache"]["signatures"]
    for got, ref in zip(replies, solo):
        # the same kernels at batch 4 and batch 1: other tiles of M, the
        # same f32 accumulation order within a row
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_inference_server_batch_waits_on_an_event_on_card(cuda_nvcc,
                                                          monkeypatch):
    """Each batch of a hybridized block behind ``InferenceServer``
    (outputs are NDArrays) waits for the card on a CUDA event, which
    releases the GIL, before its copy to the host: one event wait on
    the scheduler thread a batch."""
    import threading

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving

    ctx = mx.gpu(0)
    net = _narrow_resnet(mx, ctx)
    net.hybridize(static_alloc=True)
    waits = []

    class Event(torch.cuda.Event):
        def synchronize(self):
            if threading.current_thread().name == "mxt-serving-sched":
                waits.append(1)
            super().synchronize()

    monkeypatch.setattr(torch.cuda, "Event", Event)
    rng = np.random.RandomState(3)
    srv = serving.InferenceServer(net, serving.ServerConfig(
        max_batch=2, min_batch=1, max_length=32, min_length=32,
        length_axis=1, batch_window_ms=0.0))
    with srv:
        for _ in range(5):
            srv.infer(rng.normal(size=(3, 32, 32)).astype(np.float32),
                      timeout=120)
    stats = srv.stats()
    assert stats["completed"] == 5 and stats["failed"] == 0
    assert len(waits) == stats["batches"] == 5


@pytest.mark.cuda
def test_servers_capture_while_another_server_replays_on_card(cuda_nvcc,
                                                              monkeypatch):
    """Three ``InferenceServer``s live at once, each over its own
    hybridized narrow ResNetV1.  C's graph is captured before the servers
    start; the first batches of A and B capture on their scheduler
    threads, and both captures stay open (a barrier inside the captured
    function) until C has served two batches (graph replays, event
    waits, copies to the host) meanwhile.  Every reply equals its
    request's solo forward, nothing fails, and the fused launches are
    counted exactly: 4 a batch forward, none for a capture."""
    import threading
    import time

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cuda_graph, serving

    ctx = mx.gpu(0)
    nets = [_narrow_resnet(mx, ctx, seed=s) for s in range(3)]
    rng = np.random.RandomState(11)
    images = [rng.normal(size=(3, 32, 32)).astype(np.float32)
              for _ in range(6)]
    solo = [[net(mx.nd.array(x[None], ctx=ctx)).asnumpy()[0]
             for x in images] for net in nets]
    for net in nets:
        net.hybridize(static_alloc=True)
    nets[2](mx.nd.array(images[0][None], ctx=ctx))  # C's capture, here
    srvs = [serving.InferenceServer(net, serving.ServerConfig(
        max_batch=1, min_batch=1, max_length=32, min_length=32,
        length_axis=1, batch_window_ms=0.0)) for net in nets]
    both_open = threading.Barrier(2, timeout=120)
    held = []
    real_capture = cuda_graph.capture

    def capture(fn, **kw):
        def hold_then_run():
            both_open.wait()
            n = srvs[2].stats()["batches"]
            deadline = time.monotonic() + 120
            while srvs[2].stats()["batches"] < n + 2:
                if time.monotonic() > deadline:
                    raise RuntimeError("C served nothing during a capture")
                time.sleep(0.001)
            held.append(threading.current_thread().name)
            return fn()
        return real_capture(hold_then_run, **kw)

    monkeypatch.setattr(cuda_graph, "capture", capture)
    replies = [[None] * len(images) for _ in nets]
    c_replies = []
    errors = []
    done = threading.Event()

    def client(k):
        try:
            for i, x in enumerate(images):
                replies[k][i] = srvs[k].infer(x, timeout=300)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(f"server {k}: {e!r}")

    def c_client():
        i = 0
        try:
            while not done.is_set():
                c_replies.append((i, srvs[2].infer(images[i], timeout=300)))
                i = (i + 1) % len(images)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(f"server 2: {e!r}")

    fn = cbr.fused_matmul_affine_relu
    before = fn.launches
    for srv in srvs:
        srv.start()
    try:
        c_thread = threading.Thread(target=c_client)
        c_thread.start()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        done.set()
        c_thread.join(600)
    finally:
        for srv in srvs:
            srv.stop()
    stats = [srv.stats() for srv in srvs]
    assert errors == []
    assert len(held) == 2
    assert all(s["failed"] == 0 for s in stats)
    assert [s["cache"]["signatures"] for s in stats] == [1, 1, 1]
    assert fn.launches - before == 4 * sum(s["batches"] for s in stats)
    for k in (0, 1):
        for got, ref in zip(replies[k], solo[k]):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert len(c_replies) >= 2
    for i, got in c_replies:
        np.testing.assert_allclose(got, solo[2][i], rtol=1e-5, atol=1e-5)


# -- slice 9: the vision model zoo ---------------------------------------------
# The distinct 1×1 (H'·W', K, N) of the nets whose Conv2D → BatchNorm →
# ReLU runs fuse (MobileNet v1 1.0 at 224, Inception v3 at 299,
# DenseNet-121 at 224), here at B=2 (M = 2·H'·W'); ``chip_smoke.py`` holds
# them at B=128.
_MOBILENET_1X1 = [(12544, 32, 64), (3136, 64, 128), (3136, 128, 128),
                  (784, 128, 256), (784, 256, 256), (196, 256, 512),
                  (196, 512, 512), (49, 512, 1024), (49, 1024, 1024)]
_INCEPTION_1X1 = [(5329, 64, 80)] + [
    (1225, k, n) for k in (192, 256, 288) for n in (32, 48, 64)
    if (k, n) != (256, 32) and (k, n) != (288, 32)] + [
    (289, 768, n) for n in (128, 160, 192)] + [
    (64, k, n) for k in (1280, 2048) for n in (192, 320, 384, 448)]
_DENSENET_1X1 = [(hw, k0 + 32 * i, 128) for hw, k0, layers in
                 ((3136, 64, 6), (784, 128, 12), (196, 256, 24),
                  (49, 512, 16)) for i in range(layers)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw,k,n", _MOBILENET_1X1 + _INCEPTION_1X1 +
                         _DENSENET_1X1)
def test_fused_kernel_at_vision_zoo_shapes_matches_plain_on_card(
        cuda_nvcc, hw, k, n):
    """bf16 on the tensor cores, within 2^-8 of each value and 1e-4 of the
    largest (the tolerances of the ResNet shapes above)."""
    m = 2 * hw
    x, w, scale, bias = _mm_operands(cuda_nvcc, torch.bfloat16, m, k, n)
    fn = cbr.fused_matmul_affine_relu
    before = fn.launches_mma
    got = fn(x, w, scale, bias)
    torch.cuda.synchronize()
    assert fn.launches_mma == before + 1
    ref = cbr._fused_matmul_affine_relu_plain(x.float(), w.float(), scale,
                                              bias)
    diff = (got.float() - ref).abs()
    assert bool((diff <= 2.0 ** -8 * ref.abs() +
                 1e-4 * ref.abs().max()).all()), diff.max().item()


@pytest.mark.cuda
def test_mobilenet_bf16_hybridized_launches_13_tensor_core_kernels(
        cuda_nvcc):
    """``mobilenet1.0`` in bf16, hybridized: the capturing call and each
    replay launch the fused kernel's tensor-core design 13 times (one per
    pointwise convolution), and a replay equals the eager forward."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mx.random.seed(0)
    net = vision.mobilenet1_0()
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.cast("bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = mx.nd.array(torch.rand((2, 3, 224, 224), generator=gen,
                               device="cuda").bfloat16())
    fn = cbr.fused_matmul_affine_relu
    eager = net(x)._data.clone()
    net.hybridize(static_alloc=True)
    for _ in range(3):
        before = (fn.launches, fn.launches_mma)
        out = net(x)
        torch.cuda.synchronize()
        assert (fn.launches - before[0], fn.launches_mma - before[1]) == \
            (13, 13)
    assert net.cache_stats()["hits"] == 2
    assert torch.equal(out._data, eager)


@pytest.mark.cuda
def test_fused_train_step_with_rmsprop_matches_eager_on_card(cuda_nvcc):
    """``FusedTrainStep`` with RMSProp, which has no rule code of the
    multi-tensor kernel: the optimizer's own rule is captured in the step
    graph (lr, wd and t read from a device table), no multi-tensor launch,
    and K=4 steps equal four eager ``Trainer.step``s within 1e-5 (f32)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import multi_tensor as mt

    ctx = mx.gpu(0)
    rng = np.random.RandomState(8)
    batch = (mx.nd.array(rng.normal(size=(8, 8)).astype(np.float32),
                         ctx=ctx),
             mx.nd.array(rng.randint(0, 4, 8).astype(np.float32), ctx=ctx))
    before = mt.multi_tensor_update.launches
    kw = {"learning_rate": 0.01, "gamma1": 0.9, "epsilon": 1.0,
          "clip_gradient": 2.0, "centered": True, "wd": 1e-3}
    eager, fused, net_e, net_f, fstep = _fused_vs_eager(
        mx, lambda: _mlp(mx, ctx, 7), batch, 4, "rmsprop", kw, 8)
    np.testing.assert_allclose(fused, eager, rtol=1e-5, atol=1e-6)
    for (n, a), (_, b) in zip(net_e.collect_params().items(),
                              net_f.collect_params().items()):
        np.testing.assert_allclose(b.data().asnumpy(), a.data().asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    assert mt.multi_tensor_update.launches == before
    entry, = fstep._graphs.values()
    assert entry["plan"] is None
    more = fstep(*batch).asnumpy()
    assert np.isfinite(more).all() and entry["graph"].replays == 3 + 4


# -- slice 10: the data plane on the card -------------------------------------

@pytest.mark.cuda
def test_prefetcher_copies_on_its_stream_and_the_consumer_never_syncs(
        cuda_nvcc, monkeypatch):
    """``DevicePrefetcher`` copies pinned batches on a stream of its own;
    ``get()`` makes the current stream wait for the batch's event and
    the consumer thread never synchronizes the host (every synchronize
    entry point raises there).  Large batches, read at once on the
    current stream, come out exact."""
    import threading

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import data

    consumer = threading.current_thread()

    def guard(orig):
        def call(*a, **kw):
            if threading.current_thread() is consumer:
                raise AssertionError("host synchronize in the consumer")
            return orig(*a, **kw)
        return call

    waits = []
    orig_wait = torch.cuda.Stream.wait_event

    def wait_event(self, event):
        waits.append(self)
        return orig_wait(self, event)

    rng = np.random.RandomState(0)
    host = [rng.normal(size=(8, 1 << 20)).astype(np.float32)
            for _ in range(4)]
    p = data.DevicePrefetcher(iter(host), depth=2, ctx=mx.gpu(0))
    doubled = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        guard(torch.cuda.synchronize))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        guard(torch.cuda.Event.synchronize))
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        guard(torch.cuda.Stream.synchronize))
    monkeypatch.setattr(torch.cuda.Stream, "wait_event", wait_event)
    for _ in host:
        x = p.get(timeout=120)
        assert x._data.is_cuda
        doubled.append(x._data * 2)  # on the current stream, at once
    monkeypatch.undo()
    current = torch.cuda.current_stream()
    assert p._stream is not None and p._stream != current
    assert len(waits) == len(host) and all(w == current for w in waits)
    for h, d in zip(host, doubled):
        assert torch.equal(d.cpu(), torch.from_numpy(h) * 2)
    with pytest.raises(StopIteration):
        p.get(timeout=120)
    assert p.stats()["batches"] == len(host) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("workers,worker_type", [(0, "thread"),
                                                 (2, "thread"),
                                                 (2, "process")])
def test_dataloader_pin_memory_pins_host_batches_on_card(cuda_nvcc, workers,
                                                         worker_type):
    import mxnet_tpu_torch as mx

    ds = mx.gluon.data.ArrayDataset(
        np.arange(40, dtype=np.float32).reshape(20, 2),
        np.arange(20, dtype=np.float32))
    loader = mx.gluon.data.DataLoader(ds, batch_size=8, pin_memory=True,
                                      num_workers=workers,
                                      worker_type=worker_type)
    try:
        batches = list(loader)
    finally:
        loader.close()
    assert [d.shape for d, _ in batches] == [(8, 2), (8, 2), (4, 2)]
    for d, lab in batches:
        for b in (d, lab):
            assert b._data.is_pinned() and not b._data.is_cuda
    np.testing.assert_array_equal(batches[2][1].asnumpy(),
                                  np.arange(16, 20, dtype=np.float32))
    plain = next(iter(mx.gluon.data.DataLoader(ds, batch_size=8)))
    assert not plain[0]._data.is_pinned()


@pytest.mark.cuda
def test_fused_train_step_fed_by_the_prefetcher_matches_resident(cuda_nvcc):
    """``FusedTrainStep`` (K=2, captured) over three prefetched batches
    equals the same step over the same batches made on the card (bit for
    bit: the same graph), and equals two eager ``Trainer.step``s a batch
    within 1e-5: each call trains on its own batch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import data

    ctx = mx.gpu(0)
    rng = np.random.RandomState(9)
    host = [(rng.normal(size=(8, 8)).astype(np.float32),
             rng.randint(0, 4, 8).astype(np.float32)) for _ in range(3)]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    hp = {"learning_rate": 0.1, "momentum": 0.9}

    def fused(feed):
        net = _mlp(mx, ctx, 7)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(hp))
        fstep = mx.gluon.FusedTrainStep(
            net, tr, lambda n, a, b: loss_fn(n(a), b),
            steps_per_execution=2, batch_size=8)
        losses = np.concatenate([fstep(*b).asnumpy() for b in feed])
        assert len(fstep._graphs) == 1
        return losses, net

    with data.DevicePrefetcher(host, depth=2, ctx=ctx) as pf:
        fed, net_p = fused(pf)
    resident, net_r = fused([(mx.nd.array(x, ctx=ctx),
                              mx.nd.array(y, ctx=ctx)) for x, y in host])
    np.testing.assert_array_equal(fed, resident)
    net_e = _mlp(mx, ctx, 7)
    tr = mx.gluon.Trainer(net_e.collect_params(), "sgd", dict(hp))
    eager = []
    for x, y in host:
        xb, yb = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
        for _ in range(2):
            with mx.autograd.record():
                loss = loss_fn(net_e(xb), yb)
            loss.backward()
            tr.step(8)
            eager.append(float(loss.sum().asscalar()))
    np.testing.assert_allclose(fed, eager, rtol=1e-5, atol=1e-6)
    for (n, a), (_, b) in zip(net_e.collect_params().items(),
                              net_p.collect_params().items()):
        np.testing.assert_allclose(b.data().asnumpy(), a.data().asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.cuda
def test_image_record_iter_batches_land_on_the_card(cuda_nvcc, tmp_path):
    """``ImageRecordIter`` on the card: the uint8 batch is copied once and
    finished there, equal to the same iterator's batch on the CPU."""
    import mxnet_tpu_torch as mx

    path = str(tmp_path / "i.rec")
    rec = mx.recordio.MXRecordIO(path, "w")
    rng = np.random.RandomState(3)
    for i in range(10):
        img = rng.randint(0, 256, (30, 34, 3)).astype(np.uint8)
        rec.write(mx.recordio.pack_img((0, float(i), i, 0), img,
                                       quality=3, img_fmt=".png"))
    rec.close()
    kw = dict(path_imgrec=path, data_shape=(3, 24, 24), batch_size=4,
              shuffle=True, rand_crop=True, rand_mirror=True, seed=2,
              mean_r=120.0, mean_g=110.0, mean_b=100.0, std_r=50.0,
              std_g=60.0, std_b=70.0)
    with mx.gpu(0):
        card = [(b.data[0], b.label[0]) for b in mx.io.ImageRecordIter(**kw)]
    with mx.cpu():
        host = [(b.data[0], b.label[0]) for b in mx.io.ImageRecordIter(**kw)]
    assert len(card) == len(host) == 3
    for (d, lab), (hd, hl) in zip(card, host):
        assert d._data.is_cuda and lab._data.is_cuda
        np.testing.assert_allclose(d.asnumpy(), hd.asnumpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(lab.asnumpy(), hl.asnumpy())


# -- slice 11: the NCCL route at world size 1, the sequence-parallel bodies

@pytest.fixture
def nccl_group(cuda_nvcc):
    """A one-rank NCCL group on a free port, left after the test."""
    from mxnet_tpu_torch import parallel

    parallel.initialize(f"127.0.0.1:{parallel.free_port()}", 1, 0,
                        init_timeout=60)
    yield parallel
    parallel.shutdown()


@pytest.mark.cuda
def test_nccl_group_of_one_runs_the_store_and_a_mesh_step(nccl_group):
    """``all_sum``, ``broadcast`` and ``allreduce_grads`` are the identity
    at world size 1, and a Dense step through a {'dp': 1, 'tp': 1} mesh
    (DTensor parameters, ``dist_sync``) equals the plain step."""
    import mxnet_tpu_torch as mx

    parallel = nccl_group
    assert torch.distributed.get_backend() == "nccl"
    assert mx.gpu(0, mesh={"dp": 1}) == mx.gpu(0)  # and makes it current
    assert parallel.mesh_axes(parallel.current_mesh()) == {"dp": 1}
    parallel.set_mesh(None)
    x = mx.nd.array(torch.randn(8, 16, device="cuda"))
    assert torch.equal(parallel.all_sum([x])[0]._data, x._data)
    out = mx.nd.zeros((8, 16), ctx=mx.gpu(0))
    mx.kv.create("dist_tpu_sync").broadcast("x", x, out=out)
    assert torch.equal(out._data, x._data)
    weights = []
    for mesh in (None, parallel.make_mesh({"dp": 1, "tp": 1})):
        net = mx.gluon.nn.Dense(4, in_units=16)
        net.initialize(ctx=mx.gpu(0))
        net.weight.set_data(torch.linspace(-1, 1, 64).reshape(4, 16))
        kw = {} if mesh is None else dict(
            mesh=mesh, partition_rules=[(r"weight$", (None, "tp")),
                                        (r".*", ())])
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1}, kvstore="dist_sync",
                              **kw)
        xx = x if mesh is None else parallel.shard_batch(x, mesh)
        with mx.autograd.record():
            loss = (net(xx) ** 2).sum()
        loss.backward()
        tr.step(8)
        weights.append(net.weight.data().asnumpy())
    parallel.set_mesh(None)
    np.testing.assert_allclose(weights[1], weights[0], rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sequence_parallel_bodies_match_one_flash_call_on_card(cuda_nvcc,
                                                               kind):
    """The ring and Ulysses bodies for 4 virtual ranks over local
    transports (as ``chip_smoke.py`` phase 18c, at B1·H8·T512·D64, bf16,
    causal) against one flash call, forward and backward; Ulysses
    launches #1-#3 once per virtual rank, each the tensor-core design."""
    import chip_smoke as cs
    from mxnet_tpu_torch.parallel import ring

    n, t, h, d = 4, 512, 8, 64
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    full = [torch.randn((1, t, h, d), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(3)]
    w = torch.randn((1, t, h, d), generator=g, device="cuda")

    def run(fn):
        leaves = [a.clone().requires_grad_(True) for a in full]
        out = fn(*leaves)
        (out.float() * w).sum().backward()
        return [out] + [a.grad for a in leaves]

    ref = run(lambda q, k, v: tfa.flash_attention_raw(
        *(a.transpose(1, 2).contiguous() for a in (q, k, v)), True,
        d ** -0.5).transpose(1, 2))

    def bodies(q, k, v):
        chunks = [list(a.split(t // n, dim=1)) for a in (q, k, v)]
        outs = []
        for idx in range(n):
            qc, kc, vc = (c[idx] for c in chunks)
            if kind == "ring":
                outs.append(ring._ring_body(
                    qc, kc, vc, idx, n, True, d ** -0.5,
                    cs._LocalRing(chunks[1], chunks[2], idx)))
            else:
                tr = cs._LocalAllToAll(chunks, idx)
                outs.append(ring._ulysses_body(qc, kc, vc, True, d ** -0.5,
                                               tr.to_heads, tr.to_seq))
        return torch.cat(outs, dim=1 if kind == "ring" else 2)

    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    before_mma = [c.launches_mma for c in counters]
    got = run(bodies)
    launched = [c.launches - b for c, b in zip(counters, before)]
    mma = [c.launches_mma - b for c, b in zip(counters, before_mma)]
    assert launched == ([0, 0, 0] if kind == "ring" else [n] * 3)
    assert mma == launched  # bf16: the tensor-core designs
    for a, b in zip(got, ref):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel < 2e-2, rel


# -- slice 12: the pipeline, graphs over a mesh, serving on a mesh ---------

@pytest.mark.cuda
def test_pipeline_launches_the_flash_kernels_as_predicted_on_card(
        cuda_nvcc):
    """``llama_tiny`` (4 layers, f32) over 2 stages of the local transport
    with M=2 microbatches: one 1F1B step launches the forward (2L - L/S)·M
    times (the forward leg of stages 0..S-2 and every stage's recompute),
    dQ and dK/dV L·M times each; its
    loss and gradients equal the plain route's accumulated over the same
    microbatches; GPipe's forward launches the forward L·M times."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import llama

    ctx = mx.gpu(0)
    vocab, layers, m = 256, 4, 2
    ids = np.random.RandomState(12).randint(0, vocab, (m, 33))
    x = mx.nd.array(ids[:, :-1], ctx=ctx, dtype="int32")
    y = mx.nd.array(ids[:, 1:], ctx=ctx, dtype="int32")
    mx.random.seed(13)
    net = llama.llama_tiny(num_layers=layers)
    net.initialize(ctx=ctx)
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    for p in params:
        p.grad_req = "add"
        p.zero_grad()
    plain = 0.0
    for b in range(m):
        with mx.autograd.record():
            loss = mx.nd.softmax_cross_entropy(
                net(x[b:b + 1]).reshape((-1, vocab)),
                y[b:b + 1].reshape((-1,))) / y.size
        loss.backward()
        plain += float(loss.asscalar())
    ref = [p.grad()._data.clone() for p in params]
    for p in params:
        p.grad_req = "write"
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    with mx.autograd.record():
        loss = llama.llama_pipeline_train_step(net, x, y, m,
                                               mesh={"pp": 2})
    loss.backward()
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == \
        [(2 * layers - layers // 2) * m, layers * m, layers * m]
    np.testing.assert_allclose(float(loss.asscalar()), plain, rtol=1e-5)
    for p, r in zip(params, ref):
        g = p.grad()._data
        assert ((g - r).norm() / r.norm()).item() < 1e-4, p.name
    before = counters[0].launches
    gpipe = llama.llama_pipeline_forward(net, x, m, mesh={"pp": 2})
    assert counters[0].launches - before == layers * m
    np.testing.assert_allclose(gpipe.asnumpy(), net(x).asnumpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_captured_mesh_step_equals_the_eager_one_on_card(nccl_group):
    """``FusedTrainStep`` (K=3) of ``llama_tiny`` placed on a {'dp': 1,
    'tp': 1} mesh through ``dist_sync``: the graph holds the step's NCCL
    all-reduces; its losses and weights equal three eager mesh steps',
    and a hybridized forward of the placed net replays its eager logits."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import llama
    from mxnet_tpu_torch.parallel.local import local

    parallel = nccl_group
    mesh = parallel.make_mesh({"dp": 1, "tp": 1})
    ctx = mx.gpu(0)
    vocab = 256
    ids = np.random.RandomState(14).randint(0, vocab, (2, 33))
    # dp-sharded ids at B=2: before the embedding read a replicated table
    # on local ids, torch 2.11's DTensor failed to propagate the lookup's
    # backward (``index_put``) here
    x = parallel.shard_batch(mx.nd.array(ids[:, :-1], ctx=ctx,
                                         dtype="int32"), mesh)
    y = parallel.shard_batch(mx.nd.array(ids[:, 1:].astype(np.float32),
                                         ctx=ctx), mesh)

    def make():
        net = _tiny_llama(mx, ctx, seed=15)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9},
                              kvstore="dist_sync",
                              partition_rules=parallel.LLAMA_RULES,
                              mesh=mesh)
        return net, tr

    def lm_loss(n, a, b):
        return mx.nd.softmax_cross_entropy(
            n(a).reshape((-1, vocab)), b.reshape((-1,))) / 64

    net, tr = make()
    eager = []
    for _ in range(3):
        with mx.autograd.record():
            loss = lm_loss(net, x, y)
        loss.backward()
        tr.step(1)
        eager.append(float(loss.asscalar()))
    del loss
    net2, tr2 = make()
    fstep = mx.gluon.FusedTrainStep(net2, tr2, lm_loss,
                                    steps_per_execution=3, batch_size=1)
    fused = fstep(x, y).asnumpy()
    np.testing.assert_allclose(fused, eager, rtol=1e-5)
    got = net2._collect_params_with_prefix()
    for k, p in net._collect_params_with_prefix().items():
        np.testing.assert_allclose(got[k].data().asnumpy(),
                                   p.data().asnumpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    with torch.no_grad():
        want = local(net2(x)._data).clone()
        net2.hybridize()
        net2(x)
        got = local(net2(x)._data)
    assert net2.cache_stats()["hits"] == 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    parallel.set_mesh(None)


@pytest.mark.cuda
def test_serving_on_a_one_card_mesh_replays_the_tick_on_card(cuda_nvcc):
    """``GenerativeServer(mesh={'dp': 1, 'tp': 1})`` on the card: one
    replica with its graphed tick, replies equal the server's without a
    mesh."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving

    net = _tiny_llama(mx, mx.gpu(0), seed=16)
    prompts = [np.random.RandomState(i).randint(1, 250, size=n)
               for i, n in enumerate((5, 9, 12, 7))]
    replies = []
    for mesh in (None, {"dp": 1, "tp": 1}):
        cfg = serving.ServerConfig(max_batch=1, max_length=64, num_slots=2)
        with serving.GenerativeServer(net, cfg, mesh=mesh) as srv:
            replies.append([srv.generate(p, max_new_tokens=6)
                            for p in prompts])
            assert srv.engine._step_graph is not None
            assert (srv.engine.mesh is None) == (mesh is None)
    for a, b in zip(*replies):
        np.testing.assert_array_equal(a, b)


def _moe_pair(mx, router, dtype, seed=20):
    """An MoEMLP (H=256, I=512, 8 experts, top 2) on the CPU from a seed
    and the same weights on the card."""
    from mxnet_tpu_torch.models import moe

    mx.random.seed(seed)
    cpu = moe.MoEMLP(256, 512, 8, 2, 1.25, router)
    cpu.initialize(mx.init.Normal(0.05), ctx=mx.cpu())
    card = moe.MoEMLP(256, 512, 8, 2, 1.25, router)
    card.initialize(ctx=mx.gpu(0))
    for name, p in cpu._collect_params_with_prefix().items():
        card._collect_params_with_prefix()[name].set_data(
            p.data()._data.cuda())
    if dtype != "float32":
        cpu.cast(dtype)
        card.cast(dtype)
    return cpu, card


# f32: cuBLAS and the CPU sum in other orders (TF32 off): 1e-4 of the
# largest output; bf16: each product rounds to 8 bits on either side:
# relative norm within 2e-2.  The router runs in f32 on both, so the same
# tokens reach the same slots.
@pytest.mark.cuda
@pytest.mark.parametrize("router", ["topk", "expert_choice"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_on_card_matches_its_cpu_run(cuda_nvcc, router, dtype):
    """The MoE layer's forward, aux loss and gradients of x and the
    router and banks, B=2, T=128 (capacity 80 of 256 tokens: drops)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import moe

    cpu, card = _moe_pair(mx, router, dtype)
    x = torch.from_numpy(np.random.RandomState(21).normal(
        size=(2, 128, 256)).astype(np.float32)).to(getattr(torch, dtype))
    head = torch.from_numpy(np.random.RandomState(22).normal(
        size=(2, 128, 256)).astype(np.float32))
    outs = []
    for blk, ctx in ((cpu, mx.cpu()), (card, mx.gpu(0))):
        xn = mx.nd.array(x.to(ctx.device), ctx=ctx)
        xn.attach_grad()
        with moe.collect_aux() as aux:
            with mx.autograd.record():
                y = blk(xn)
                loss = (y.astype("float32") * mx.nd.array(
                    head, ctx=ctx)).sum() + 0.3 * aux[0]
            loss.backward()
        grads = {n: p.grad()._data.float().cpu() for n, p in
                 blk._collect_params_with_prefix().items()}
        outs.append((y._data.float().cpu(), aux[0]._data.cpu(),
                     xn.grad._data.float().cpu(), grads))
    (y0, a0, gx0, g0), (y1, a1, gx1, g1) = outs
    torch.testing.assert_close(a1, a0, rtol=1e-5, atol=1e-6)
    pairs = [(y1, y0), (gx1, gx0)] + [(g1[n], g0[n]) for n in g0]
    for got, want in pairs:
        if dtype == "float32":
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()
        else:
            norm = torch.linalg.vector_norm(got - want) / \
                torch.linalg.vector_norm(want)
            assert norm <= 2e-2, norm


@pytest.mark.cuda
def test_captured_moe_step_equals_the_eager_one_on_card(cuda_nvcc):
    """``FusedTrainStep`` (K=3) of a 2-layer Mixtral (width 256, 8
    experts) on the card: the routing, the expert bank and the combine
    are captured with the flash kernels and the update (no host read in
    the step); losses and weights equal three eager steps' (f32, rtol
    1e-5); ``collect_aux`` inside the capture raises."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import llama, moe

    ctx, vocab = mx.gpu(0), 512
    ids = np.random.RandomState(23).randint(0, vocab, (2, 129))
    x = mx.nd.array(ids[:, :-1], ctx=ctx, dtype="int32")
    y = mx.nd.array(ids[:, 1:].astype(np.float32), ctx=ctx)

    def make():
        mx.random.seed(24)
        net = llama.mixtral_tiny(hidden_size=256, intermediate_size=512,
                                 num_heads=4, num_kv_heads=2,
                                 num_experts=8, vocab_size=vocab)
        net.initialize(mx.init.Normal(0.05), ctx=ctx)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
        return net, tr

    def lm_loss(n, a, b):
        return mx.nd.softmax_cross_entropy(
            n(a).reshape((-1, vocab)), b.reshape((-1,))) / 256

    net, tr = make()
    eager = []
    for _ in range(3):
        with mx.autograd.record():
            loss = lm_loss(net, x, y)
        loss.backward()
        tr.step(1)
        eager.append(float(loss.asscalar()))
    del loss
    net2, tr2 = make()
    fstep = mx.gluon.FusedTrainStep(net2, tr2, lm_loss,
                                    steps_per_execution=3, batch_size=1)
    fused = fstep(x, y).asnumpy()
    assert next(iter(fstep._graphs.values()))["graph"].replays == 2
    np.testing.assert_allclose(fused, eager, rtol=1e-5)
    got = net2._collect_params_with_prefix()
    for k, p in net._collect_params_with_prefix().items():
        np.testing.assert_allclose(got[k].data().asnumpy(),
                                   p.data().asnumpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    net3, tr3 = make()
    fstep3 = mx.gluon.FusedTrainStep(net3, tr3, lm_loss,
                                     steps_per_execution=2, batch_size=1)
    with moe.collect_aux():
        with pytest.raises(MXNetError, match="hybridize"):
            fstep3(x, y)


@pytest.mark.cuda
def test_moe_ep_route_on_a_one_rank_group_equals_the_plain_route(
        nccl_group):
    """The mesh route at ep = 1 (``shard_llama`` over {'ep': 1}: DTensor
    banks, replicated, since a size-1 axis shards nothing; the
    routing and the experts through ``sharded_call``) of a 2-layer
    Mixtral on the card: logits and loss equal the plain route's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import llama

    parallel = nccl_group
    ids = mx.nd.array(np.random.RandomState(25).randint(0, 256, (2, 64)),
                      ctx=mx.gpu(0), dtype="int32")
    outs = []
    for mesh in (None, parallel.make_mesh({"ep": 1})):
        mx.random.seed(26)
        net = llama.mixtral_tiny(hidden_size=256, intermediate_size=512,
                                 num_heads=4, num_kv_heads=2, num_experts=8)
        net.initialize(mx.init.Normal(0.05), ctx=mx.gpu(0))
        if mesh is not None:
            llama.shard_llama(net, mesh)
        outs.append(net(ids).asnumpy())
        parallel.set_mesh(None)
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.cuda
def test_dist_async_table_and_update_stay_on_the_card(cuda_nvcc):
    """The in-process ``dist_async`` store on the card: its table lies on
    the card, and each step's pushes are applied by the fused
    multi-tensor kernel there.  A Dense net stepped through it in
    lockstep with the ``device`` store's (the same gradients) ends with
    the same weights (f32, rtol 1e-6: both run the same kernel)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kvstore import dist_async
    from mxnet_tpu_torch.ops import multi_tensor as mt

    ctx = mx.gpu(0)
    x = mx.nd.array(np.random.RandomState(27).randn(8, 32), ctx=ctx,
                    dtype="float32")
    nets, trainers = [], []
    for store in ("device", dist_async.AsyncPSKVStore()):
        mx.random.seed(28)
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(64, in_units=32, activation="relu"),
                mx.gluon.nn.Dense(16, in_units=64))
        net.initialize(mx.init.Xavier(), ctx=ctx)
        nets.append(net)
        trainers.append(mx.gluon.Trainer(
            net.collect_params(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9}, kvstore=store))
    for _ in range(3):
        with mx.autograd.record():
            loss = (nets[0](x) ** 2).mean()
        loss.backward()
        for pd, pa in zip(nets[0].collect_params().values(),
                          nets[1].collect_params().values()):
            pa.grad()._data.copy_(pd.grad()._data)
        trainers[0].step(8)
        before = mt.multi_tensor_update.launches
        trainers[1].step(8)
        assert mt.multi_tensor_update.launches > before
    kv = trainers[1]._kvstore
    assert kv.type == "dist_async" and kv._local.device.type == "cuda"
    assert all(v._data.is_cuda for v in kv._local._store.values())
    for pd, pa in zip(nets[0].collect_params().values(),
                      nets[1].collect_params().values()):
        np.testing.assert_allclose(pa.data().asnumpy(), pd.data().asnumpy(),
                                   rtol=1e-6, atol=1e-7)
    kv.close()


# -- slice 14: int8 products and recurrent nets on the card ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 147, 64), (9, 15, 13), (16, 64, 8),
                                   (17, 3, 5), (200, 576, 64), (75, 32, 40)])
def test_int8_matmul_pads_to_what_cublaslt_takes_on_card(cuda_nvcc, m, k,
                                                         n):
    """``torch._int_mm`` on the card takes M > 16 and K, N multiples of 8;
    ``_int8_matmul`` zero-pads up to that and slices, with both operands
    K-contiguous: the int32 product equals the CPU's exact one at ragged
    M, K and N, and at (75, 32, 40), which cuBLASLt refused with the
    weight copied K-major."""
    from mxnet_tpu_torch.ops import quantization as q

    g = torch.Generator().manual_seed(m * 1000 + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = q._int8_matmul(a.to(cuda_nvcc), w.to(cuda_nvcc))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), a.long().matmul(w.long().t()).int())


@pytest.mark.cuda
@pytest.mark.parametrize("xs,ws,stride,pad,dilate", [
    ((2, 3, 30, 30), (16, 3, 7, 7), 2, 3, 1),
    ((2, 16, 13, 11), (24, 16, 3, 3), 1, 1, 1),
    ((1, 8, 17, 17), (8, 8, 3, 3), 2, 2, 2),
    ((3, 32, 9, 9), (40, 32, 1, 1), 2, 0, 1)])
def test_int8_conv_matches_cpu_on_card(cuda_nvcc, xs, ws, stride, pad,
                                       dilate):
    """``nd.quantized_conv`` (f16 unfold, int8 product) on the card: the
    int32 output equals the CPU route's, the range too."""
    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(sum(xs) + sum(ws))
    x = rng.normal(size=xs).astype(np.float32)
    w = rng.normal(0, 0.2, ws).astype(np.float32)
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        qd = mx.nd.quantize_v2(mx.nd.array(x, ctx=ctx))
        qw = mx.nd.quantize_v2(mx.nd.array(w, ctx=ctx))
        out = mx.nd.quantized_conv(
            qd[0], qw[0], qd[1], qd[2], qw[1], qw[2], kernel=ws[2:],
            stride=stride, pad=pad, dilate=dilate, num_filter=ws[0],
            no_bias=True)
        outs.append([o._data.cpu() for o in out])
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][2], outs[1][2])


@pytest.mark.cuda
def test_quantized_net_replays_its_graph_on_card(cuda_nvcc):
    """``quantize_net`` on a hybridized ``mobilenet0.25``: the next call
    captures the int8 graph (depthwise convs stay f32), replays equal the
    eager int8 forward bit for bit, and no 1×1 conv runs the fused
    kernel #4 (each is rewritten)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.gluon.model_zoo import vision

    ctx = mx.gpu(0)
    mx.random.seed(3)
    net = vision.get_model("mobilenet0.25", classes=10)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    rng = np.random.RandomState(4)
    x = mx.nd.array(rng.uniform(-1, 1, (4, 3, 64, 64)).astype(np.float32),
                    ctx=ctx)
    net.hybridize(static_alloc=True)
    net(x)
    quantize_net(net, calib_data=[x])
    fn = cbr.fused_matmul_affine_relu
    before = fn.launches
    net.hybridize(False)
    eager = net(x).asnumpy()
    net.hybridize(static_alloc=True)
    outs = [net(x).asnumpy() for _ in range(3)]
    assert fn.launches == before
    assert net.cache_stats()["hits"] == 2
    for got in outs:
        np.testing.assert_array_equal(got, eager)


def _lstm_lm(mx, ctx, vocab=50, units=32):
    class LM(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.emb = mx.gluon.nn.Embedding(vocab, units)
                self.rnn = mx.gluon.rnn.LSTM(units, 2, input_size=units)
                self.out = mx.gluon.nn.Dense(vocab, flatten=False,
                                             in_units=units)

        def hybrid_forward(self, F, ids):
            return self.out(self.rnn(self.emb(ids)))

    mx.random.seed(9)
    net = LM()
    net.initialize(mx.init.Uniform(0.1), ctx=ctx)
    return net


@pytest.mark.cuda
def test_captured_lstm_step_replays_like_eager_on_card(cuda_nvcc):
    """An LSTM language model's step (the T-step loop of both layers,
    forward and backward, and the update) under ``FusedTrainStep``: one
    CUDA graph a step, no host read inside; K=3 replayed steps equal 3
    eager ``Trainer.step``s within 1e-5 (f32, the same kernels; cuBLAS may
    pick another algorithm inside a capture)."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    rng = np.random.RandomState(10)
    x = mx.nd.array(rng.randint(0, 50, (12, 4)), ctx=ctx, dtype="int32")
    y = mx.nd.array(rng.randint(0, 50, (12, 4)), ctx=ctx, dtype="int32")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def lm_loss(n, a, b):
        return loss_fn(n(a).reshape((-1, 50)), b.reshape((-1,)))

    net_e, net_f = _lstm_lm(mx, ctx), _lstm_lm(mx, ctx)
    tr = mx.gluon.Trainer(net_e.collect_params(), "sgd",
                          {"learning_rate": 0.5, "clip_gradient": 0.1})
    eager = []
    for _ in range(3):
        with mx.autograd.record():
            loss = lm_loss(net_e, x, y)
        loss.backward()
        tr.step(48)
        eager.append(float(loss.sum().asscalar()))
    del loss
    tr2 = mx.gluon.Trainer(net_f.collect_params(), "sgd",
                           {"learning_rate": 0.5, "clip_gradient": 0.1})
    fstep = mx.gluon.FusedTrainStep(net_f, tr2, lm_loss,
                                    steps_per_execution=3, batch_size=48)
    fused = fstep(x, y).asnumpy()
    np.testing.assert_allclose(fused, eager, rtol=1e-5)
    entry, = fstep._graphs.values()
    assert entry["graph"].replays == 2
    for (n, a), (_, b) in zip(net_e.collect_params().items(),
                              net_f.collect_params().items()):
        np.testing.assert_allclose(b.data().asnumpy(), a.data().asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.cuda
def test_hybridized_rnn_layer_with_states_replays_on_card(cuda_nvcc):
    """A hybridized ``GRU`` with states in and out: the first call
    captures, the later ones replay, output and states equal the eager
    call's bit for bit."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    layer = mx.gluon.rnn.GRU(16, num_layers=2, bidirectional=True,
                             layout="NTC", input_size=8)
    layer.initialize(mx.init.Uniform(0.2), ctx=ctx)
    rng = np.random.RandomState(11)
    x = mx.nd.array(rng.normal(size=(3, 7, 8)).astype(np.float32), ctx=ctx)
    h = mx.nd.array(rng.normal(size=(4, 3, 16)).astype(np.float32), ctx=ctx)
    out, (h1,) = layer(x, [h])
    eager = (out.asnumpy(), h1.asnumpy())
    layer.hybridize(static_alloc=True)
    for _ in range(3):
        out, (h1,) = layer(x, [h])
        np.testing.assert_array_equal(out.asnumpy(), eager[0])
        np.testing.assert_array_equal(h1.asnumpy(), eager[1])
    assert layer.cache_stats()["hits"] == 2


@pytest.mark.cuda
def test_ctc_training_step_captures_on_card(cuda_nvcc):
    """A BiLSTM + ``CTCLoss`` step under ``FusedTrainStep``: the label
    checks read the host in the eager warm-up and are skipped while the
    graph captures; K=3 replayed steps equal 3 eager steps within
    1e-5."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    rng = np.random.RandomState(12)
    x = mx.nd.array(rng.normal(size=(4, 16, 8)).astype(np.float32), ctx=ctx)
    lab = np.full((4, 3), -1, np.float32)
    lab[:, :2] = rng.randint(0, 5, (4, 2))
    y = mx.nd.array(lab, ctx=ctx)
    loss_fn = mx.gluon.loss.CTCLoss()

    def make():
        mx.random.seed(13)
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.rnn.LSTM(8, layout="NTC", bidirectional=True,
                                  input_size=8),
                mx.gluon.nn.Dense(6, flatten=False, in_units=16))
        net.initialize(mx.init.Xavier(), ctx=ctx)
        return net

    net_e, net_f = make(), make()
    tr = mx.gluon.Trainer(net_e.collect_params(), "adam",
                          {"learning_rate": 1e-2})
    eager = []
    for _ in range(3):
        with mx.autograd.record():
            loss = loss_fn(net_e(x), y).mean()
        loss.backward()
        tr.step(1)
        eager.append(float(loss.asscalar()))
    del loss
    tr2 = mx.gluon.Trainer(net_f.collect_params(), "adam",
                           {"learning_rate": 1e-2})
    fstep = mx.gluon.FusedTrainStep(
        net_f, tr2, lambda n, a, b: loss_fn(n(a), b).mean(),
        steps_per_execution=3, batch_size=1)
    np.testing.assert_allclose(fstep(x, y).asnumpy(), eager, rtol=1e-5)


# -- slice 15: the NMS scan kernel and a hybridized detector ---

def _nms_case(device, g, n, with_cls, seed):
    """Sorted-order NMS operands: boxes (G, n, 4) clustered so that many
    overlap, ~10% invalid, three classes or none."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(0, 1, (g, n, 2)) * np.sqrt(n) * 4
    wh = rng.uniform(2, 12, (g, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    valid = rng.rand(g, n) > 0.1
    cls = rng.randint(0, 3, (g, n)).astype(np.float32) if with_cls else None
    to = (lambda a: None if a is None else torch.from_numpy(a).to(device))
    return to(boxes), to(valid), to(cls)


# (G, n, class ids): chip_smoke's 23a sizes; 11,200 boxes with ids (21
# bytes a box) and 14,000 without (17) are past the block's shared memory
NMS_SHAPES = [(32, 128, True), (32, 400, True), (32, 1364, True),
              (1, 2000, False), (1, 10647, True), (1, 11200, True),
              (2, 14000, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("g, n, with_cls", NMS_SHAPES)
def test_nms_keep_kernel_matches_plain_on_card(cuda_nvcc, g, n, with_cls):
    from mxnet_tpu_torch.ops import contrib as tc

    boxes, valid, cls = _nms_case(cuda_nvcc, g, n, with_cls, seed=n)
    before = tc.nms_keep.launches
    got = tc.nms_keep(boxes, valid, cls, 0.45)
    torch.cuda.synchronize()
    assert tc.nms_keep.launches == before + 1
    ref = tc._nms_keep_plain(boxes, valid, cls, 0.45)
    assert torch.equal(got, ref)
    assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.cuda
def test_nms_keep_kernel_rejects_what_it_does_not_take(cuda_nvcc):
    from mxnet_tpu_torch.ops import contrib as tc

    boxes, valid, cls = _nms_case(cuda_nvcc, 2, 16, True, seed=0)
    for args in ((boxes.half(), valid, cls), (boxes, valid.float(), cls),
                 (boxes, valid, cls[:, :8]), (boxes.cpu(), valid, cls)):
        with pytest.raises(MXNetError, match="nms_keep"):
            tc.nms_keep(*args, 0.5)


@pytest.mark.cuda
def test_hybridized_ssd_replays_its_eager_forward_on_card(cuda_nvcc):
    """``ssd_300_resnet18_v1`` f32 at 96×96: the captured graph's replays
    give the eager forward's ids, scores and boxes bit for bit, and each
    forward launches ``nms_keep`` once (eager and replayed)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import detection
    from mxnet_tpu_torch.ops import contrib as tc

    ctx = mx.gpu(0)
    mx.random.seed(3)
    net = detection.ssd_300_resnet18_v1(classes=3)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    x = mx.nd.array(np.random.RandomState(4).rand(2, 3, 96, 96)
                    .astype(np.float32), ctx=ctx)
    before = tc.nms_keep.launches
    eager = [o.asnumpy() for o in net(x)]
    assert tc.nms_keep.launches == before + 1
    net.hybridize()
    for _ in range(3):
        before = tc.nms_keep.launches
        got = [o.asnumpy() for o in net(x)]
        assert tc.nms_keep.launches == before + 1
        for g, e in zip(got, eager):
            np.testing.assert_array_equal(g, e)
    assert net.cache_stats()["hits"] == 2


# -- slice 16: sparse storage on the card -------------------------------------
# The sparse ops are torch ops on the card, but for the CSR products
# (csrc/csr_dense_dot.cu in both directions, held bit for bit further
# down).  These checks hold the card to the CPU at rtol 1e-5 (f32), which
# the card's own reductions (sums over duplicates, the losses) stay
# within; indices and untouched rows exactly.

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _fm_csr(mx, ctx, rows=64, features=5000, nnz=39, seed=0):
    rng = np.random.RandomState(seed)
    cols = np.sort(np.stack([rng.choice(features, nnz, replace=False)
                             for _ in range(rows)]), axis=1).reshape(-1)
    vals = rng.uniform(0.01, 1.0, rows * nnz).astype(np.float32)
    indptr = np.arange(0, rows * nnz + 1, nnz)
    return mx.nd.sparse.csr_matrix((vals, cols, indptr),
                                   shape=(rows, features), ctx=ctx)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_on_card_matches_the_cpu(cuda_card, transpose_a):
    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(1)
    w = rng.randn(64 if transpose_a else 5000, 16).astype(np.float32)
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        csr = _fm_csr(mx, ctx)
        out = mx.nd.dot(csr, mx.nd.array(w, ctx=ctx),
                        transpose_a=transpose_a)
        assert out._data.device.type == ctx.device.type
        outs.append(out.asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01})])
def test_lazy_rows_on_card_leave_the_others_bit_equal(cuda_card, name, kw):
    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(2)
    w0 = rng.randn(1000, 16).astype(np.float32)
    rows = np.sort(rng.choice(1000, 50, replace=False))
    g = rng.randn(50, 16).astype(np.float32)
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        opt = mx.optimizer.create(name, **kw)
        w = mx.nd.array(w0, ctx=ctx)
        state = opt.create_state(0, w)
        states = [s for s in (state if isinstance(state, tuple)
                              else (state,)) if s is not None]
        before = [s.asnumpy() for s in states]
        grad = mx.nd.sparse.row_sparse_array((g, rows), shape=w0.shape,
                                             ctx=ctx)
        for _ in range(2):
            opt.update(0, w, grad, state)
        assert w._data.device.type == ctx.device.type
        untouched = np.setdiff1d(np.arange(1000), rows)
        np.testing.assert_array_equal(w.asnumpy()[untouched],
                                      w0[untouched])
        for s, b in zip(states, before):
            np.testing.assert_array_equal(s.asnumpy()[untouched],
                                          b[untouched])
        res.append(w.asnumpy())
    np.testing.assert_allclose(res[0], res[1], rtol=1e-5, atol=1e-6)


def _recording_store(mx, pushed):
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.Adam(learning_rate=0.01))
    push = kv.push

    def call(key, value, priority=0):
        pushed[key] = value.copy()
        push(key, value, priority)

    kv.push = call
    return kv


@pytest.mark.cuda
def test_fm_step_on_card_matches_the_cpu(cuda_card):
    """One FM step with the store's Adam on the card against the CPU:
    the loss and the pushed gradients within 1e-5 (of the step's largest
    gradient), and the card's tables equal to the CPU's Adam applied to
    the card's own gradients (Adam's first step, lr·g/(|g| + 3.2e-7),
    turns the atomics' last bits in a nearly cancelling gradient into
    differences of ~1e-4 of lr, so the two models' tables are not held
    to each other element by element)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import fm

    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        pushed = {}
        model = fm.FMModel(5000, 16, seed=5, ctx=ctx,
                           kvstore=_recording_store(mx, pushed))
        csr = _fm_csr(mx, ctx, seed=6)
        labels = mx.nd.array(np.arange(64) % 2, ctx=ctx)
        loss = model.step(csr, labels)
        assert model.v._data.device.type == ctx.device.type
        res.append((loss, pushed, model))
    (loss, pushed, model), (cpu_loss, cpu_pushed, _) = res
    np.testing.assert_allclose(loss, cpu_loss, rtol=1e-5)
    # w0's gradient is a sum over the batch that nearly cancels: every
    # gradient is held within 1e-5 of the step's largest one
    scale = max(float(np.abs(g.asnumpy()).max()) for g in cpu_pushed.values())
    for key, g in cpu_pushed.items():
        c = pushed[key].as_in_context(mx.cpu())
        if hasattr(g, "indices"):
            assert torch.equal(c.indices._data, g.indices._data)
            c, g = c.data, g.data
        np.testing.assert_allclose(c.asnumpy(), g.asnumpy(), rtol=0,
                                   atol=1e-5 * scale)
    replay = fm.FMModel(5000, 16, seed=5, ctx=mx.cpu(),
                        kvstore=_recording_store(mx, {}))
    for key, g in pushed.items():
        replay.kv.push(key, g.as_in_context(mx.cpu()))
    for k, key in (("w0", "fm_w0"), ("w", "fm_w"), ("v", "fm_v")):
        np.testing.assert_allclose(getattr(model, k).asnumpy(),
                                   replay.kv._store[key].asnumpy(),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_sparse_results_stay_on_the_card(cuda_card, tmp_path):
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    csr = _fm_csr(mx, ctx, rows=8, features=100, nnz=5)
    rsp = csr.tostype("row_sparse")
    dense = mx.nd.array(np.eye(8, 100, dtype=np.float32), ctx=ctx)
    outs = [csr, rsp, csr.tostype("csr"), rsp.tostype("csr"),
            dense.tostype("row_sparse"), dense.tostype("csr"), rsp + rsp,
            rsp * rsp, csr + csr, csr * csr, csr * dense, rsp * 2.0,
            mx.nd.square(csr), mx.nd.sparse.retain(rsp, [0, 3]),
            mx.nd.sparse.zeros("row_sparse", (4, 2), ctx=ctx)]
    for x in outs:
        parts = [x.data, x.indices] + ([x.indptr] if x.stype == "csr"
                                       else [])
        assert all(p._data.device.type == "cuda" for p in parts), x
    assert rsp.todense()._data.is_cuda and \
        mx.nd.dot(csr, mx.nd.ones((100, 2), ctx=ctx))._data.is_cuda
    path = tmp_path / "d.libsvm"
    path.write_text("1 0:0.5 3:2\n0 1:1\n")
    with ctx:
        batch = next(iter(mx.io.LibSVMIter(data_libsvm=str(path),
                                           data_shape=(4,), batch_size=2)))
    assert batch.data[0].data._data.is_cuda and batch.label[0]._data.is_cuda
    kv = mx.kv.create("local")
    kv.init("t", mx.nd.ones((10, 2), ctx=ctx))
    out = mx.nd.zeros((10, 2), ctx=ctx)
    kv.row_sparse_pull("t", out=out, row_ids=mx.nd.array([2, 5], ctx=ctx))
    assert out._data.is_cuda and out.asnumpy().sum() == 4.0


# -- slice 17: the kernels as custom ops, and exported programs ---

def _fmar_operands(dev, dtype, m=300, k=64, n=96, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g).to(dev, dtype)
    w = (torch.randn((k, n), generator=g) * 0.1).to(dev, dtype)
    scale = (torch.rand(n, generator=g) + 0.5).to(dev)
    bias = torch.randn(n, generator=g).to(dev)
    return x, w, scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_launch_the_kernels_and_match_plain_on_card(cuda_nvcc,
                                                               dtype):
    """``torch.ops.mxnet_tpu_torch.*`` on CUDA tensors launch the kernels
    (the counters rise) and agree with the plain versions within the
    tolerances of the wrappers' own card tests."""
    ops = torch.ops.mxnet_tpu_torch
    x, w, scale, bias = _fmar_operands(cuda_nvcc, dtype)
    before = cbr.fused_matmul_affine_relu.launches
    got = ops.fused_matmul_affine_relu(x, w, scale, bias)
    assert cbr.fused_matmul_affine_relu.launches == before + 1
    ref = cbr._fused_matmul_affine_relu_plain(x, w, scale, bias)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                               atol=1e-4)
    q, k, v = (torch.from_numpy(a).to(cuda_nvcc, dtype)
               for a in _qkv(1, 2, 2, 128, 128, 64))
    before = tfa.flash_attention_fwd.launches
    o, lse = ops.flash_attention_fwd(q, k, v, False, 0.125)
    assert tfa.flash_attention_fwd.launches == before + 1
    ro, rlse = tfa._fa_forward_plain(q, k, v, False, 0.125,
                                     round_p=dtype != torch.float32)
    torch.testing.assert_close(o.float(), ro.float(),
                               rtol=0, atol=1e-4 if dtype == torch.float32
                               else 2e-2)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_fake_implementations_give_the_real_shapes_on_card(cuda_nvcc):
    from torch._subclasses.fake_tensor import FakeTensorMode

    ops = torch.ops.mxnet_tpu_torch
    real = (ops.fused_matmul_affine_relu(*_fmar_operands(
        cuda_nvcc, torch.bfloat16)),)
    q = torch.randn((1, 2, 70, 32), device=cuda_nvcc, dtype=torch.bfloat16)
    real += ops.flash_attention_fwd(q, q, q, True, 0.2)
    with FakeTensorMode() as mode:
        fx, fw, fs, fb = (mode.from_tensor(t) for t in _fmar_operands(
            cuda_nvcc, torch.bfloat16))
        fq = mode.from_tensor(q)
        fake = (ops.fused_matmul_affine_relu(fx, fw, fs, fb),) + \
            tuple(ops.flash_attention_fwd(fq, fq, fq, True, 0.2))
    for f, r in zip(fake, real):
        assert (f.shape, f.dtype, f.device) == (r.shape, r.dtype, r.device)


def _export_on_cpu(tmp_path):
    """A conv + BN + ReLU net (one fused 1x1 run) and a tiny BERT (two
    flash forwards), each exported on the CPU; returns [(symbol file,
    params file, inputs, the CPU outputs)]."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.models import bert

    cpu = mx.cpu()
    out = []
    mx.random.seed(0)
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(16, 1), nn.BatchNorm(), nn.Activation("relu"),
            nn.GlobalAvgPool2D(), nn.Dense(5))
    net.initialize(mx.init.Xavier(), ctx=cpu)
    net.hybridize()
    x = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
    y = net(mx.nd.array(x, ctx=cpu))
    files = net.export(str(tmp_path / "conv"))
    out.append(files + ({"data": x}, [y.asnumpy()]))
    b = bert.bert_tiny(vocab_size=50)
    b.initialize(mx.init.Xavier(), ctx=cpu)
    b.hybridize()
    ids = np.random.RandomState(1).randint(0, 50, (2, 16)).astype(np.int32)
    tt = np.zeros_like(ids)
    ys = b(mx.nd.array(ids, ctx=cpu, dtype="int32"),
           mx.nd.array(tt, ctx=cpu, dtype="int32"))
    files = b.export(str(tmp_path / "bert"))
    out.append(files + ({"data0": ids, "data1": tt},
                        [o.asnumpy() for o in ys]))
    return out


@pytest.mark.cuda
def test_program_exported_on_cpu_launches_the_kernels_on_card(cuda_nvcc,
                                                               tmp_path):
    import mxnet_tpu_torch as mx

    (conv_sym, conv_params, conv_in, conv_out), \
        (bert_sym, bert_params, bert_in, bert_out) = _export_on_cpu(tmp_path)
    fused, flash = cbr.fused_matmul_affine_relu, tfa.flash_attention_fwd
    for sym, params, inputs, want, fn, per_forward in (
            (conv_sym, conv_params, conv_in, conv_out, fused, 1),
            (bert_sym, bert_params, bert_in, bert_out, flash, 2)):
        pred = mx.predictor.Predictor(sym, params, ctx=mx.gpu(0))
        for _ in range(3):  # capture, then two replays
            before = fn.launches
            outs = pred.forward(**inputs)
            torch.cuda.synchronize()
            assert fn.launches == before + per_forward
        assert pred.cache_stats() == {"hits": 2, "misses": 1,
                                      "signatures": 1}
        for o, r in zip(outs, want):
            assert o.context == mx.gpu(0)
            np.testing.assert_allclose(o.asnumpy(), r, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_export_reaching_nms_keep_is_refused_on_card(cuda_nvcc, tmp_path):
    """Refused until slice 23, which made ``nms_keep`` a custom op: the
    exported program launches the scan on the card and gives the live
    block's rows bit for bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import contrib

    class Nms(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.contrib.box_nms(x, overlap_thresh=0.5)

    net = Nms()
    net.hybridize()
    x = np.array([[[0, 0.9, 0, 0, 1, 1], [0, 0.8, 0, 0, 1, 0.9]]],
                 np.float32)
    live = net(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    sym_file, params_file = net.export(str(tmp_path / "nms"))
    block = mx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                         ctx=mx.gpu(0))
    before = contrib.nms_keep.launches
    got = block(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    assert contrib.nms_keep.launches > before
    np.testing.assert_array_equal(got, live)


# -- slice 18: the NumPy front end, custom ops, the tools ----------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _register_host_sigmoid(mx, name):
    """A custom sigmoid whose forward and backward go through the host
    (``asnumpy``, ``nd.array``)."""
    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0],
                        mx.nd.array(1.0 / (1.0 + np.exp(-x))))

        def backward(self, req, out_grad, in_data, out_data, in_grad,
                     aux):
            y = out_data[0].asnumpy()
            self.assign(in_grad[0], req[0], mx.nd.array(
                out_grad[0].asnumpy() * y * (1 - y)))

    @mx.operator.register(name)
    class Prop(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()


@pytest.mark.cuda
def test_custom_in_a_hybridized_block_follows_each_input_on_card(
        cuda_nvcc):
    """Trap 3: two calls on different inputs; the second output follows
    its own input (a graph replay would return the first call's), and
    the block runs eagerly on every call."""
    import mxnet_tpu_torch as mx

    _register_host_sigmoid(mx, "card_sigmoid")

    class Block(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, a):
            return F.Custom(a * 2, op_type="card_sigmoid") + 1

    blk = Block()
    blk.hybridize(static_alloc=True)
    rng = np.random.RandomState(0)
    for _ in range(3):
        x = rng.normal(size=(4, 5)).astype(np.float32)
        out = blk(mx.nd.array(x, ctx=mx.gpu(0)))
        assert out.context == mx.gpu(0)
        np.testing.assert_allclose(out.asnumpy(),
                                   1 / (1 + np.exp(-2 * x)) + 1, rtol=1e-6)
    assert blk.cache_stats() == {"hits": 0, "misses": 1, "signatures": 1,
                                 "recorded": 0, "eager": 3}
    a = mx.nd.array(x, ctx=mx.gpu(0))
    a.attach_grad()
    with mx.autograd.record():
        blk(a).backward()
    s = 1 / (1 + np.exp(-2 * x))
    np.testing.assert_allclose(a.grad.asnumpy(), 2 * s * (1 - s),
                               rtol=1e-5)


@pytest.mark.cuda
def test_a_capture_that_reaches_custom_is_refused_on_card(cuda_nvcc):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cuda_graph

    _register_host_sigmoid(mx, "card_sigmoid_capture")
    x = mx.nd.array(np.ones((2, 3), np.float32), ctx=mx.gpu(0))
    with pytest.raises(MXNetError, match="card_sigmoid_capture"):
        cuda_graph.capture(lambda: mx.nd.Custom(
            x, op_type="card_sigmoid_capture")._data)
    # the card still works after the refused capture
    y = mx.nd.Custom(x, op_type="card_sigmoid_capture")
    np.testing.assert_allclose(y.asnumpy(), 1 / (1 + np.exp(-1.0)),
                               rtol=1e-6)


@pytest.mark.cuda
def test_np_table_on_card_matches_the_cpu(cuda_nvcc):
    """Every name of the np table (``chip_smoke.np_cases`` at n = 64) on
    CUDA tensors against the same call on the CPU, within 1e-5 of the
    largest |value| (integers and bools exact)."""
    import mxnet_tpu_torch as mx

    cs = _chip_smoke()

    def conv(a, ctx):
        if isinstance(a, np.ndarray):
            return mx.np.array(a, ctx=ctx)
        if isinstance(a, (list, tuple)) and a and \
                isinstance(a[0], np.ndarray):
            return type(a)(conv(x, ctx) for x in a)
        return a

    seen, bad = set(), []
    for name, fam, args, kw in cs.np_cases(64):
        fn = getattr(mx.np, name)
        got = cs.np_outputs(fn(*[conv(a, mx.gpu(0)) for a in args], **kw))
        want = cs.np_outputs(fn(*[conv(a, mx.cpu()) for a in args], **kw))
        errs = [cs.np_rel_err(g, w) for g, w in zip(got, want)]
        if len(got) != len(want) or max(errs, default=0.0) > 1e-5:
            bad.append((name, errs))
        seen.add(name)
    assert bad == [] and seen == set(mx.np.FUNCTIONS)


@pytest.mark.cuda
def test_monitor_keeps_the_fused_kernel_launching_on_card(cuda_nvcc):
    """Trap 6: a monitored fusable run still launches #4 and reports its
    three blocks' outputs; the net's output is the unmonitored one."""
    import mxnet_tpu_torch as mx

    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(64, 1, in_channels=32), nn.BatchNorm(in_channels=64),
            nn.Activation("relu"))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.cast("bfloat16")
    x = mx.nd.array(np.random.RandomState(1).normal(
        size=(2, 32, 14, 14)).astype(np.float32), ctx=mx.gpu(0)) \
        .astype("bfloat16")
    plain = net(x).asnumpy()
    mon = mx.monitor.Monitor(1)
    mon.install(net)
    before = cbr.fused_matmul_affine_relu.launches
    mon.tic()
    out = net(x).asnumpy()
    rows = mon.toc()
    assert cbr.fused_matmul_affine_relu.launches == before + 1
    assert len(rows) == 3
    np.testing.assert_array_equal(out, plain)
    mon.uninstall()
    # slice 19: on the hybridized block the taps are outputs of its CUDA
    # graph; every replay launches #4 once and reports the three blocks
    # with the l2 norms an eager monitor computes (bf16 tolerance)
    from mxnet_tpu_torch.telemetry import numerics

    eager = mx.monitor.Monitor(1, stat_func=mx.nd.norm, sort=True)
    eager.install(net)
    eager.tic()
    net(x)
    want = eager.toc()
    eager.uninstall()
    net.hybridize()
    try:
        mon = mx.monitor.Monitor(1, sort=True).install(net)
        for _ in range(3):  # the capture's call, then two replays
            before = cbr.fused_matmul_affine_relu.launches
            mon.tic()
            got = net(x).asnumpy()
            rows = mon.toc()
            assert cbr.fused_matmul_affine_relu.launches == before + 1
            np.testing.assert_array_equal(got, plain)
            assert [r[1] for r in rows] == [r[1] for r in want]
            for g, w in zip(rows, want):
                assert float(g[2]) == pytest.approx(float(w[2]), rel=1e-2)
        mon.uninstall()
    finally:
        numerics.clear()


@pytest.mark.cuda
def test_runtime_features_on_card(cuda_nvcc):
    import mxnet_tpu_torch as mx

    feats = mx.runtime.Features()
    assert feats.is_enabled("CUDA") and feats.is_enabled("CUDNN")
    assert not feats.is_enabled("TPU") and not feats.is_enabled("PALLAS")
    assert mx.util.get_gpu_count() == torch.cuda.device_count()
    free, total = mx.util.get_gpu_memory(0)
    assert 0 < free <= total
    assert mx.test_utils.default_context() == mx.gpu(0)


@pytest.mark.cuda
def test_create_graph_through_the_flash_kernels_raises_on_card(cuda_nvcc):
    """Trap 7: higher-order gradients through #1-#3 raise."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.flash_attention import flash_attention

    q = mx.nd.array(np.random.RandomState(2).normal(
        size=(1, 2, 128, 64)).astype(np.float32), ctx=mx.gpu(0))
    q.attach_grad()
    with mx.autograd.record():
        y = flash_attention(q, q * 0.5, q * 2.0).sum()
        with pytest.raises(MXNetError, match="first-order"):
            mx.autograd.grad(y, [q], create_graph=True)
    with mx.autograd.record():
        y = flash_attention(q, q * 0.5, q * 2.0).sum()
    g, = mx.autograd.grad(y, [q])
    assert np.isfinite(g.asnumpy()).all()


# -- slice 19: telemetry on the card -------------------------------------------

def _tel_llama(mx, ctx, seed=19):
    """A 2-layer tiny Llama, f32, weights from a seed, on ``ctx``."""
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.models import llama

    cfg = {**llama.LLAMA_CONFIGS["llama_tiny"], "num_layers": 2}
    src = llama.LlamaForCausalLM(llama.LlamaConfig(**cfg), prefix="tl_")
    mx.random.seed(seed)
    src.initialize(mx.init.Xavier(), ctx=mx.cpu())
    arrays = {k: p.data().asnumpy()
              for k, p in src._collect_params_with_prefix().items()}
    net = llama.LlamaForCausalLM(llama.LlamaConfig(**cfg), prefix="tl_")
    net.initialize(ctx=ctx)
    load_numpy_params(net, arrays, ctx=ctx)
    return net


def _stat_rows(tensors, paths=None):
    paths = paths or list(tensors)
    return np.array([[tensors[p][k] for k in ("l2", "maxabs", "mean", "nan",
                                              "inf")] for p in paths])


@pytest.mark.cuda
def test_numerics_taps_are_outputs_of_the_cachedop_graph_on_card(cuda_nvcc):
    """Trap 1: the forward's taps captured into a hybridized block's graph
    equal the eager taps of the same inputs after each replay, two
    replays on different inputs give their own stats (none stale), and
    numerics on and off keep one graph each."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.telemetry import numerics

    gpu = mx.gpu(0)
    eager, hyb = _tel_llama(mx, gpu), _tel_llama(mx, gpu)
    hyb.hybridize()
    rs = np.random.RandomState(3)
    batches = [mx.nd.array(rs.randint(0, 256, (2, 16)).astype(np.int32),
                           ctx=gpu) for _ in range(3)]
    try:
        numerics.enable(stride=1)
        got, want = [], []
        for ids in batches:  # capture, then two replays
            hyb(ids)
            got.append(numerics.step_summary(0)["tensors"])
            eager(ids)
            want.append(numerics.step_summary(0)["tensors"])
        for g, w in zip(got, want):
            assert list(g) == list(w) == ["embed", "decoder.0", "decoder.1",
                                          "norm", "logits"]
            np.testing.assert_allclose(_stat_rows(g), _stat_rows(w),
                                       rtol=1e-5, atol=1e-6)
        assert not np.allclose(_stat_rows(got[1]), _stat_rows(got[2]))
        numerics.disable()
        hyb(batches[0])
        assert hyb.cache_stats()["signatures"] == 2
    finally:
        numerics.clear()


@pytest.mark.cuda
def test_numerics_folded_inside_the_fused_step_graph_on_card(cuda_nvcc):
    """The K = 2 fused step's bundles, folded over its inner steps inside
    the graph (the capture's call and a replayed call), against the same
    fused step on the CPU (the unrolled route), f32 within 1e-4."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.telemetry import numerics

    rs = np.random.RandomState(4)
    ids = rs.randint(0, 256, (2, 16)).astype(np.int32)
    summaries = {}
    try:
        numerics.enable(stride=1)
        for ctx in (mx.gpu(0), mx.cpu()):
            net = _tel_llama(mx, ctx)
            tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9})
            loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
            step = mx.gluon.FusedTrainStep(
                net, tr, lambda n, a, b: loss_fn(n(a), b),
                steps_per_execution=2, batch_size=2)
            x = mx.nd.array(ids, ctx=ctx)
            out = []
            for _ in range(2):
                step(x, x)
                out.append(numerics.step_summary(0)["tensors"])
            summaries[ctx.device_type] = out
    finally:
        numerics.clear()
    for g, c in zip(summaries["gpu"], summaries["cpu"]):
        assert list(g) == list(c)
        assert any(p.startswith("update.") for p in g)
        np.testing.assert_allclose(_stat_rows(g), _stat_rows(c), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.cuda
def test_retrace_names_param_addresses_on_card(cuda_nvcc):
    """Trap 7: a parameter rebound to new storage after warmup makes the
    CachedOp capture again; the sanitizer names ``param_addresses``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.telemetry import retrace

    net = mx.gluon.nn.Dense(8, in_units=16, prefix="mv_")
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    x = mx.nd.ones((4, 16), ctx=mx.gpu(0))
    try:
        retrace.enable("raise")
        net(x)
        retrace.warm()
        net(x)
        w = net.weight
        w._data._data = torch.nn.Parameter(w._data._data.detach().clone())
        with pytest.raises(retrace.RetraceError, match="param_addresses"):
            net(x)
        (v,) = retrace.violations()
        assert len(v["diff"]) == 1 and "mv_weight@" in v["diff"][0]
    finally:
        retrace.disable()
        retrace.reset()


@pytest.mark.cuda
def test_oom_postmortem_names_the_largest_buffer_on_card(cuda_nvcc, tmp_path):
    """An allocation beyond the card's memory inside an op raises
    ``OOMError`` naming the largest live buffer; any other error passes
    through unchanged."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops.registry import apply_op
    from mxnet_tpu_torch.telemetry import memwatch

    try:
        telemetry.enable()
        memwatch.enable(report_path=str(tmp_path / "oom.json"))
        net = mx.gluon.nn.Dense(1024, in_units=2048, prefix="big_")
        net.initialize(ctx=mx.gpu(0))
        x = mx.nd.ones((2, 2048), ctx=mx.gpu(0))
        total = torch.cuda.get_device_properties(0).total_memory
        with pytest.raises(memwatch.OOMError) as ei:
            apply_op(lambda a: torch.empty(2 * total, dtype=torch.uint8,
                                           device=a.device), x,
                     name="huge")
        assert isinstance(ei.value.__cause__, torch.cuda.OutOfMemoryError)
        assert "big_weight" in str(ei.value)
        with pytest.raises(RuntimeError) as ei:
            apply_op(lambda a: a @ a, x, name="bad_shapes")
        assert not isinstance(ei.value, memwatch.OOMError)
    finally:
        telemetry.disable()


# -- slice 20: serving observability on the card ------------------------------

def _tiny_card_net():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import llama_tiny

    mx.random.seed(3)
    net = llama_tiny()
    net.initialize(ctx=mx.gpu(0))
    return net


@pytest.mark.cuda
def test_graphed_tick_holds_the_logit_taps_on_card(cuda_nvcc):
    """With numerics on at construction the engine captures its decode
    tick with ``stats_of(logits)`` as a second graph output, keyed apart
    from the tapless graph; each replay queues one copy of the statistics
    (never the static output), and the tokens equal the tapless graph's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import LlamaServingEngine
    from mxnet_tpu_torch.telemetry import numerics

    net = _tiny_card_net()
    prompts = np.random.RandomState(4).randint(1, 250, (2, 16)) \
        .astype(np.int32)
    t0s = np.array([16, 9], np.int32)
    runs = {}
    try:
        for mode in (False, True):
            if mode:
                numerics.enable(stride=1)
            eng = LlamaServingEngine(net, max_len=64, num_slots=2,
                                     kv_mode="paged", block_size=8)
            assert eng._step_graph is not None
            assert eng._numerics is mode
            assert (eng._step_key[-1] == "numerics") is mode
            from mxnet_tpu_torch.serving import PagedKVCacheManager

            mgr = PagedKVCacheManager(2, 64, eng.num_blocks, 8)
            admitted = [mgr.admit(i, int(t0s[i]), 8) for i in range(2)]
            slots = np.array([s for s, _ in admitted], np.int32)
            toks, rows = eng.prefill_rows(prompts, t0s)
            eng.commit_rows(rows, slots, [b for _, b in admitted], t0s,
                            toks.cpu().numpy())
            steps = [eng.step(list(slots)).copy() for _ in range(4)]
            runs[mode] = steps
            if mode:
                outs = eng._step_graph.outputs
                assert isinstance(outs, tuple) and outs[1].shape == (5,)
                pend = [e for e in numerics._pending
                        if e[0] == ("serving.logits",)]
                assert len(pend) == 4
                assert all(e[1].data_ptr() != outs[1].data_ptr()
                           for e in pend)
                stats = torch.cat([e[1].reshape(-1, 5) for e in pend])
                assert bool(torch.isfinite(stats).all())
                assert stats[:, 3:].sum().item() == 0
                assert len({tuple(r.tolist()) for r in stats}) > 1
        for a, b in zip(runs[True], runs[False]):
            np.testing.assert_array_equal(a, b)
    finally:
        numerics.disable()
        numerics.clear()
    del mx


@pytest.mark.cuda
def test_tick_stamps_bracket_the_replay_on_card(cuda_nvcc):
    """The lanes' stamps around a graphed tick close after the tick's
    tokens reach the host: each ``decode.step`` span and busy interval
    holds at least the replay's device time (CUDA events), with no sync
    added for the stamps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving, telemetry
    from mxnet_tpu_torch.telemetry import capacity, tracing
    from mxnet_tpu_torch.telemetry.sinks import ListSink

    net = _tiny_card_net()
    try:
        telemetry.enable(memory=False, cost=False, trace=True,
                         capacity=True)
        sink = ListSink()
        telemetry.add_sink(sink)
        cfg = serving.ServerConfig(max_batch=2, max_length=64, min_length=8,
                                   num_slots=2)
        srv = serving.GenerativeServer(net, cfg)
        eng = srv.engine
        graph = eng._step_graph
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            graph.replay()
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end) / 20
        prompts = np.random.RandomState(5).randint(1, 250, (2, 12))
        with srv:
            futs = [srv.submit(p, max_new_tokens=8) for p in prompts]
            [f.result(120) for f in futs]
        steps = [s for r in sink.records if r.get("record") == "trace"
                 for s in r["spans"] if s["name"] == "decode.step"]
        assert steps and min(s["dur_ms"] for s in steps) >= replay_ms
        led = capacity._replicas[0].lanes["decode"]
        assert min(b - a for a, b in led._intervals) * 1e3 >= replay_ms
    finally:
        telemetry.disable()
        tracing.clear()
    del mx


# -- slice 21: memory as a managed budget on the card ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "float16",
                                   "bfloat16"])
def test_csr_dense_dot_kernel_is_bit_equal_to_the_cpu_over_runs(
        cuda_nvcc, dtype):
    """``csrc/csr_dense_dot.cu`` adds each output element's terms in
    stored order with the plain version's rounding: 20 launches on the
    card give one result, bit-equal to the CPU's ``index_add_`` route, at
    the factorization machine's row width (39 entries, 16 columns) and at
    a ragged one; each launch is counted."""
    from mxnet_tpu_torch.ndarray import sparse as sp

    dt = getattr(torch, dtype)
    rng = np.random.RandomState(3)
    for rows, k, n, nnz in ((300, 5000, 16, 39), (33, 70, 5, 7)):
        cols = np.sort(np.stack([rng.choice(k, nnz, replace=False)
                                 for _ in range(rows)]), 1).reshape(-1)
        vals = torch.from_numpy(
            rng.uniform(-1, 1, rows * nnz).astype(np.float32)).to(dt)
        rhs = torch.from_numpy(rng.normal(size=(k, n)).astype(
            np.float32)).to(dt)
        cols = torch.from_numpy(cols)
        indptr = torch.arange(0, rows * nnz + 1, nnz)
        rws = torch.repeat_interleave(torch.arange(rows), nnz)
        host = sp.csr_dense_dot(vals, cols, indptr, rws, rhs)
        on = [t.cuda() for t in (vals, cols, indptr, rws, rhs)]
        before = sp.csr_dense_dot.launches
        outs = [sp.csr_dense_dot(*on) for _ in range(20)]
        torch.cuda.synchronize()
        assert sp.csr_dense_dot.launches - before == 20
        for out in outs:
            assert out.dtype == dt and out.is_cuda
            assert torch.equal(out.cpu(), host)


@pytest.mark.cuda
def test_csr_dense_dot_gradient_is_the_transposed_product_on_card(
        cuda_nvcc):
    """The kernel's ``autograd.Function``: the gradient of ``rhs`` is the
    transposed product (the same kernel on the column-ordered view,
    bit-equal: ``test_csr_dense_dot_gradients_are_bit_equal_to_the_cpu_
    on_card``), within 1e-5 of the CPU's."""
    from mxnet_tpu_torch.ndarray import sparse as sp

    rng = np.random.RandomState(4)
    rows, k, n, nnz = 64, 500, 16, 39
    cols = torch.from_numpy(np.sort(np.stack(
        [rng.choice(k, nnz, replace=False) for _ in range(rows)]),
        1).reshape(-1))
    vals = torch.from_numpy(rng.uniform(0.1, 1, rows * nnz).astype("f"))
    indptr = torch.arange(0, rows * nnz + 1, nnz)
    rws = torch.repeat_interleave(torch.arange(rows), nnz)
    w = rng.normal(size=(k, n)).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=(rows, n)).astype(np.float32))
    grads = []
    for dev in ("cuda", "cpu"):
        rhs = torch.tensor(w, device=dev, requires_grad=True)
        out = sp.csr_dense_dot(vals.to(dev), cols.to(dev), indptr.to(dev),
                               rws.to(dev), rhs)
        out.backward(g.to(dev))
        grads.append(rhs.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_offload_copies_on_a_side_stream_and_the_step_never_syncs(
        cuda_nvcc, monkeypatch):
    """``Trainer(offload="host")`` on the card: the optimizer state lives
    in pinned host tensors between steps; a step fetches and stashes it
    with copies on the offload side stream (the current stream waits for
    each fetch, no host synchronize runs: every synchronize entry point
    raises during the steps), one launch of the update kernel a group;
    the weights equal an on-device trainer's bit for bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.memory import offload
    from mxnet_tpu_torch.ops import multi_tensor as mt

    ctx = mx.gpu(0)
    kw = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}
    nets = []
    for _ in range(2):
        net = _mlp(mx, ctx, 21, bn=False)
        net.cast("bfloat16")
        nets.append(net)
    _copy_params(nets[0], nets[1])
    oracle = mx.gluon.Trainer(nets[0].collect_params(), "sgd", dict(kw))
    offed = mx.gluon.Trainer(nets[1].collect_params(), "sgd", dict(kw),
                             offload="host")
    # every parameter a group of its own
    monkeypatch.setattr(mx.gluon.Trainer, "_offload_groups",
                        lambda self, live: [[i] for i in live])
    rng = np.random.RandomState(8)
    xs = [mx.nd.array(rng.normal(size=(8, 8)).astype(np.float32),
                      ctx=ctx).astype("bfloat16") for _ in range(3)]

    def step(net, tr, x):
        with mx.autograd.record():
            loss = (net(x).astype("float32") ** 2).mean()
        loss.backward()
        tr.step(8)

    for x in xs[:1]:  # the first step makes the states (host copies)
        step(nets[0], oracle, x)
        step(nets[1], offed, x)
    for i in offed._live():
        for arr in offed._offloaded_ndarrays(i):
            assert offload.is_stashed(arr) and arr._data.is_pinned()

    def refuse(*a, **k):
        raise AssertionError("host synchronize during an offloaded step")

    waits = []
    orig_wait = torch.cuda.Stream.wait_stream

    def wait_stream(self, other):
        waits.append((self, other))
        return orig_wait(self, other)

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Stream, "wait_stream", wait_stream)
    before = mt.multi_tensor_update.launches
    for x in xs[1:]:
        step(nets[1], offed, x)
    launches = mt.multi_tensor_update.launches - before
    monkeypatch.undo()
    for x in xs[1:]:
        step(nets[0], oracle, x)
    torch.cuda.synchronize()
    side = offload._side(torch.device("cuda", 0))
    current = torch.cuda.current_stream()
    assert launches == 2 * len(offed._live())
    assert any(s == current and o == side for s, o in waits)
    assert any(s == side and o == current for s, o in waits)
    for (n, a), (_, b) in zip(nets[0].collect_params().items(),
                              nets[1].collect_params().items()):
        assert torch.equal(a.data()._data, b.data()._data), n
    assert offload.resident_bytes() > 0


@pytest.mark.cuda
def test_remat_layer_inside_a_fused_train_step_capture(cuda_nvcc):
    """A block hybridized with ``remat="layer"`` inside a
    ``FusedTrainStep`` capture: the recompute is part of the captured
    backward; the losses and weights equal the same step without remat
    bit for bit (dropout at rate 0), over the eager warm-up and the
    replays."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    rng = np.random.RandomState(9)
    batch = (mx.nd.array(rng.normal(size=(8, 8)).astype(np.float32),
                         ctx=ctx),
             mx.nd.array(rng.randint(0, 4, 8).astype(np.float32), ctx=ctx))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    results = []
    for tier in ("none", "layer"):
        net = _mlp(mx, ctx, 12, bn=False)
        net.hybridize(remat=tier)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
        fstep = mx.gluon.FusedTrainStep(
            net, tr, lambda n, a, b: loss_fn(n(a), b),
            steps_per_execution=3, batch_size=8)
        losses = np.concatenate([fstep(*batch).asnumpy(),
                                 fstep(*batch).asnumpy()])
        entry = next(iter(fstep._graphs.values()))
        assert entry["graph"].replays == 2 + 3
        results.append((losses, [p.data().asnumpy() for p in
                                 net.collect_params().values()]))
    np.testing.assert_array_equal(results[1][0], results[0][0])
    for a, b in zip(results[0][1], results[1][1]):
        np.testing.assert_array_equal(b, a)


# -- slice 22: the two kernels redesigned ------------------------------------

def _csr_case(rng, rows, k, n, widths, dt):
    """A CSR array with rows of the given widths (increasing distinct
    columns), its entries' rows, and a (k, n) rhs, in ``dt``, on the
    CPU."""
    cols = np.concatenate([np.sort(rng.choice(k, w, replace=False))
                           for w in widths]).astype(np.int64)
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(widths)])
                              .astype(np.int64))
    vals = torch.from_numpy(rng.uniform(-1, 1, cols.size).astype(
        np.float32)).to(dt)
    rhs = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dt)
    rws = torch.repeat_interleave(torch.arange(rows), torch.diff(indptr))
    return vals, torch.from_numpy(cols), indptr, rws, rhs


def _csr_shapes(rng):
    """(rows, columns, n, widths): the factorization machine's row width
    at its factor size, a ragged one with empty rows, n not a multiple of
    the vector width, one column, and wide rows (more than 32 vectors)."""
    ragged = list(rng.randint(0, 12, 40))
    ragged[0] = ragged[17] = 0
    ragged[-1] = 70
    return [(300, 5000, 16, [39] * 300), (40, 90, 5, ragged),
            (40, 90, 1, ragged), (12, 400, 258, list(rng.randint(0, 60, 12))),
            (12, 400, 256, list(rng.randint(0, 60, 12)))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "float16",
                                   "bfloat16"])
def test_csr_dense_dot_transposed_kernel_is_bit_equal_to_the_cpu_over_runs(
        cuda_nvcc, dtype):
    """``Aᵀ @ g`` on the card is ``csrc/csr_dense_dot.cu`` on the
    column-ordered view: 20 launches give one result, bit-equal to the
    CPU's ``index_add_`` route, at every shape of ``_csr_shapes`` (the
    forward kernel too, at the same shapes); each launch is counted on
    ``launches_transposed``, the forward's on ``launches``."""
    from mxnet_tpu_torch.ndarray import sparse as sp

    dt = getattr(torch, dtype)
    rng = np.random.RandomState(22)
    for rows, k, n, widths in _csr_shapes(rng):
        vals, cols, indptr, rws, rhs = _csr_case(rng, rows, k, n, widths, dt)
        g = torch.from_numpy(rng.normal(size=(rows, n)).astype(
            np.float32)).to(dt)
        host_t = sp.csr_dense_dot(vals, cols, indptr, rws, g,
                                  transpose_a=True, n_cols=k)
        host = sp.csr_dense_dot(vals, cols, indptr, rws, rhs)
        on = [t.cuda() for t in (vals, cols, indptr, rws)]
        fwd, tr = sp.csr_dense_dot.launches, \
            sp.csr_dense_dot.launches_transposed
        outs = [sp.csr_dense_dot(*on, g.cuda(), transpose_a=True, n_cols=k)
                for _ in range(20)]
        outs_f = [sp.csr_dense_dot(*on, rhs.cuda()) for _ in range(20)]
        torch.cuda.synchronize()
        assert sp.csr_dense_dot.launches_transposed - tr == 20
        assert sp.csr_dense_dot.launches - fwd == 20
        for out in outs:
            assert out.dtype == dt and out.is_cuda and out.shape == (k, n)
            assert torch.equal(out.cpu(), host_t)
        for out in outs_f:
            assert torch.equal(out.cpu(), host)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dense_dot_gradients_are_bit_equal_to_the_cpu_on_card(
        cuda_nvcc, transpose_a):
    """Each direction's gradient of ``rhs`` is the product in the other
    direction, on the kernel: ``torch.equal`` to the CPU's autograd
    through ``index_add_``, at the factorization machine's row width."""
    from mxnet_tpu_torch.ndarray import sparse as sp

    rng = np.random.RandomState(23)
    rows, k, n = 64, 500, 16
    vals, cols, indptr, rws, _ = _csr_case(rng, rows, k, n, [39] * rows,
                                           torch.float32)
    w = rng.normal(size=(rows if transpose_a else k, n)).astype(np.float32)
    g = rng.normal(size=(k if transpose_a else rows, n)).astype(np.float32)
    grads = []
    for dev in ("cuda", "cpu"):
        rhs = torch.tensor(w, device=dev, requires_grad=True)
        out = sp.csr_dense_dot(vals.to(dev), cols.to(dev), indptr.to(dev),
                               rws.to(dev), rhs, transpose_a=transpose_a,
                               n_cols=k)
        out.backward(torch.from_numpy(g).to(dev))
        grads.append(rhs.grad.cpu())
    assert torch.equal(grads[0], grads[1])


def _nms_image(rng, n, kind):
    """One image's sorted-order NMS boxes (n, 4) of a kind that exercises
    the scan: 0 sparse (chip_smoke's field), 1 dense (about a box a unit
    square), 2 a chain of boxes each overlapping the next (kept 0, 2, 4,
    ...), 3 such chains in a random order, 4 identical boxes."""
    if kind == 0:
        c = rng.uniform(0, 1, (n, 2)) * np.sqrt(n) * 4
        wh = rng.uniform(2, 12, (n, 2))
    elif kind == 1:
        c = rng.uniform(0, 1, (n, 2)) * np.sqrt(n)
        wh = rng.uniform(2, 6, (n, 2))
    elif kind in (2, 3):
        x = np.arange(n) if kind == 2 else rng.permutation(n)
        c = np.stack([x * 2.0, np.zeros(n)], 1)
        wh = np.full((n, 2), 10.0)
    else:
        c, wh = np.zeros((n, 2)), np.full((n, 2), 4.0)
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _nms_hard_case(device, g, n, with_cls, seed):
    """G images of ``_nms_image``'s kinds in turn (image i of kind
    (i + n) % 5), ~5% invalid, image 5 all invalid when G > 5; two classes
    or none."""
    rng = np.random.RandomState(seed)
    boxes = np.stack([_nms_image(rng, n, (i + n) % 5) for i in range(g)])
    valid = rng.rand(g, n) > 0.05
    if g > 5:
        valid[5] = False
    cls = rng.randint(0, 2, (g, n)).astype(np.float32) if with_cls else None
    to = (lambda a: None if a is None else torch.from_numpy(a).to(device))
    return to(boxes), to(valid), to(cls)


@pytest.mark.cuda
@pytest.mark.parametrize("with_cls", [True, False])
@pytest.mark.parametrize("g", [1, 32])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 400, 2000,
                               11200])
def test_nms_keep_bitmask_scan_is_bit_equal_to_plain_on_card(
        cuda_nvcc, n, g, with_cls):
    """The bitmask scan's keep mask equals ``_nms_keep_plain``'s bit for
    bit on either side of every word edge (63, 64, 65, 127, 128, 129), at
    SSD's 400, the RPN's 2,000 and past the old kernel's shared memory
    (11,200), one image and 32, on sparse, dense, chained and identical
    boxes and an all-invalid image; one call counts one launch, and two
    kernels a chunk of images."""
    from mxnet_tpu_torch.ops import contrib as tc

    boxes, valid, cls = _nms_hard_case(cuda_nvcc, g, n, with_cls, seed=n)
    before = tc.nms_keep.launches, tc.nms_keep.cuda_launches
    got = tc.nms_keep(boxes, valid, cls, 0.45)
    torch.cuda.synchronize()
    assert tc.nms_keep.launches == before[0] + 1
    chunks = -(-g // tc._nms_plan(g, n))
    assert tc.nms_keep.cuda_launches == before[1] + 2 * chunks
    ref = tc._nms_keep_plain(boxes, valid, cls, 0.45)
    assert torch.equal(got, ref)
    if g > 5:
        assert not got[5].any()


@pytest.mark.cuda
@pytest.mark.parametrize("with_cls", [True, False])
def test_nms_keep_all_invalid_and_identical_boxes_on_card(cuda_nvcc,
                                                          with_cls):
    """An image with no valid box keeps none; an image of identical boxes
    keeps its first valid box of each class; a chain in score order keeps
    every other box; each equal to the plain version."""
    from mxnet_tpu_torch.ops import contrib as tc

    n = 130
    rng = np.random.RandomState(5)
    boxes = torch.from_numpy(np.stack(
        [_nms_image(rng, n, 0), _nms_image(rng, n, 4),
         _nms_image(rng, n, 2)])).to(cuda_nvcc)
    valid = torch.ones((3, n), dtype=torch.bool, device=cuda_nvcc)
    valid[0] = False
    valid[1, 0] = False
    cls = (torch.arange(n, device=cuda_nvcc) % 2).float().expand(3, n) \
        .contiguous() if with_cls else None
    got = tc.nms_keep(boxes, valid, cls, 0.45)
    assert torch.equal(got, tc._nms_keep_plain(boxes, valid, cls, 0.45))
    assert not got[0].any()
    firsts = [1, 2] if with_cls else [1]
    assert got[1].nonzero().flatten().tolist() == firsts
    chain = list(range(0, n, 2)) if not with_cls else list(range(n))
    assert got[2].nonzero().flatten().tolist() == chain


@pytest.mark.cuda
@pytest.mark.parametrize("g, n, cap", [(3, 2000, 72 * 1024),
                                       (40, 400, 110 * 1024)])
def test_nms_keep_image_chunks_match_plain_on_card(cuda_nvcc, monkeypatch,
                                                   g, n, cap):
    """Under a small scratch cap the scan gives each 2,000-box image,
    whose scratch alone passes the cap, a chunk and a scratch of its own,
    and takes 40 images of 400 in chunks of 4: the keep mask stays equal
    to the plain version's, refusing no n, and the call launches two
    kernels a chunk (``nms_keep.cuda_launches``, counted from what the C
    entry point reports)."""
    from mxnet_tpu_torch.ops import contrib as tc

    monkeypatch.setattr(tc, "_NMS_SCRATCH_CAP", cap)
    assert tc._nms_plan(g, n) == (1 if n == 2000 else 4)
    boxes, valid, cls = _nms_hard_case(cuda_nvcc, g, n, True, seed=g)
    before = tc.nms_keep.cuda_launches
    got = tc.nms_keep(boxes, valid, cls, 0.45)
    assert tc.nms_keep.cuda_launches - before == (6 if n == 2000 else 20)
    assert torch.equal(got, tc._nms_keep_plain(boxes, valid, cls, 0.45))


# -- slice 23: graphed recorded forwards, serving graphs, bulk segments --------

def _rec_net(mx, ctx, dropout=0.0, seed=4):
    nn = mx.gluon.nn
    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(64, activation="relu", in_units=32),
            nn.BatchNorm(axis=-1, in_channels=64), nn.Dropout(dropout),
            nn.Dense(8, in_units=64))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def _rec_steps(mx, net, xs, twice=False):
    """Recorded steps (SGD on the grads by hand); the losses, the
    gradients of the last step and the moving mean after it."""
    losses = []
    for x in xs:
        with mx.autograd.record():
            out = net(x)
            if twice:
                out = out * net(x * 0.5)
            loss = (out ** 2).mean()
        loss.backward()
        losses.append(float(loss.asscalar()))
        with torch.no_grad():
            for p in net.collect_params().values():
                if p.grad_req != "null":
                    p.data()._data.sub_(0.01 * p.grad()._data)
    grads = [p.grad().asnumpy() for p in net.collect_params().values()
             if p.grad_req != "null"]
    return losses, grads, net[1].running_mean.data().asnumpy()


@pytest.mark.cuda
@pytest.mark.parametrize("twice", [False, True])
def test_graphed_recorded_forward_matches_eager_on_card(cuda_nvcc, twice):
    """Steps of a hybridized Dense/BatchNorm net under ``record()``: the
    first call of the signature runs eagerly, later ones replay the
    forward and backward graphs as one tape node; losses, gradients and
    the moving statistics equal the unhybridized net's bit for bit (the
    same kernels), also when the block is called twice before its
    backward (a second instance of the graph pair)."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    rng = np.random.RandomState(0)
    xs = [mx.nd.array(rng.normal(size=(16, 32)).astype(np.float32),
                      ctx=ctx) for _ in range(4)]
    plain, hyb = _rec_net(mx, ctx), _rec_net(mx, ctx)
    hyb.hybridize()
    want = _rec_steps(mx, plain, xs, twice)
    got = _rec_steps(mx, hyb, xs, twice)
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], want[2])
    stats = hyb.cache_stats()
    assert stats["recorded"] == 0 and stats["misses"] == 1
    assert stats["hits"] == (2 * len(xs) - 1 if twice else len(xs) - 1)
    entry = next(iter(hyb._cached_op._rec_graphs.values()))
    assert len(entry.instances) == (2 if twice else 1)


@pytest.mark.cuda
def test_graphed_recorded_dropout_draws_fresh_masks_on_card(cuda_nvcc):
    """Dropout at rate 0.1 inside the graphed forward: two replays draw
    different masks, each keeping 90% of the units within 1%."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    drop = mx.gluon.nn.Dropout(0.1)
    drop.hybridize()
    x = mx.nd.ones((1024, 1024), ctx=ctx)
    x.attach_grad()
    masks = []
    for _ in range(3):
        with mx.autograd.record():
            y = drop(x)
        y.backward()
        masks.append(y.asnumpy() != 0)
    assert drop.cache_stats()["hits"] == 2
    assert not np.array_equal(masks[1], masks[2])
    for m in masks[1:]:
        assert abs(m.mean() - 0.9) < 0.01


@pytest.mark.cuda
def test_graphed_recorded_node_refuses_create_graph_on_card(cuda_nvcc):
    """A second derivative through the graphed node raises, as the
    reference's jitted node does; a second backward with
    ``retain_graph=True`` replays the backward graph again."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    net = _rec_net(mx, ctx)
    net.hybridize()
    x = mx.nd.array(np.ones((16, 32), np.float32), ctx=ctx)
    x.attach_grad("add")
    for _ in range(2):  # the warm-up, then the capture
        with mx.autograd.record():
            y = (net(x) ** 2).sum()
        y.backward()
    with mx.autograd.record():
        y = (net(x) ** 2).sum()
        with pytest.raises(MXNetError, match="create_graph"):
            mx.autograd.grad(y, [x], create_graph=True)
    with mx.autograd.record():
        y = (net(x) ** 2).sum()
    x.zero_grad()
    y.backward(retain_graph=True)
    first = x.grad.asnumpy().copy()
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 2 * first, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("asy", [False, True])
def test_bulk_segments_replay_graphs_on_card(cuda_nvcc, asy):
    """Bulked chains on the card: the first segment of a signature runs
    eagerly and is captured, later ones replay its graph (with a changed
    float attribute too); the results equal the eager ops' (bit for bit
    but for a division by a float attribute, which the eager kernel takes
    as a product with its reciprocal: within 1 ulp)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import engine, nd

    ctx = mx.gpu(0)
    a = nd.array(np.random.RandomState(3).randn(64, 64).astype(np.float32),
                 ctx=ctx)

    def chain(x, s):
        return nd.tanh(nd.relu(x * s) + x).sum(axis=0) - s

    prev = engine.set_async_enabled(asy)
    engine.clear_segment_cache()
    try:
        for s in (2.5, 3.5, 4.5):
            want = chain(a, s).asnumpy()
            with engine.bulk(16):
                got = chain(a, s).asnumpy()
            np.testing.assert_array_equal(got, want)
        stats = engine.segment_cache_stats()
        assert stats["miss"] == 1 and stats["hit"] == 2
        entry = next(iter(engine._SEG_CACHE.values()))
        assert entry.graph not in (None, False) and entry.graph.replays == 2
        want = (a / 1.7).asnumpy()
        for _ in range(2):
            with engine.bulk(4):
                got = (a / 1.7).asnumpy()
            np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    finally:
        engine.set_async_enabled(prev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paged", "radix", "spec", "slots",
                                  "int8"])
def test_serving_graphs_give_the_eager_tokens_on_card(cuda_nvcc, mode):
    """``llama_tiny`` served on the card: every program a CUDA graph (the
    tick in speculative mode too) gives the NaiveEngine's eager tokens,
    token for token, in each mode."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving

    net = _tiny_llama(mx, mx.gpu(0), seed=3)
    rs = np.random.RandomState(9)
    sysp = rs.randint(1, 250, size=24)
    prompts = [rs.randint(1, 250, size=n) for n in (5, 17)] + \
        [np.concatenate([sysp, rs.randint(1, 250, size=n)])
         for n in (3, 6)]
    kw = dict(max_batch=2, max_length=64, min_length=8, num_slots=2)
    kw.update({"paged": {}, "radix": {"radix_cache": True,
                                      "block_size": 8},
               "spec": {"draft_net": net, "spec_k": 3},
               "slots": {"kv_mode": "slots"},
               "int8": {"int8": True}}[mode])
    outs = []
    for naive in (True, False):
        prev = mx.engine.engine_type()
        if naive:
            mx.engine.set_engine_type("NaiveEngine")
        try:
            srv = serving.GenerativeServer(net, serving.ServerConfig(**kw))
            with srv:
                got = [srv.submit(p, max_new_tokens=8).result(120)
                       for p in prompts]
            outs.append((got, srv.engine))
        finally:
            mx.engine.set_engine_type(prev)
    (eager, e_eng), (graphed, g_eng) = outs
    for a, b in zip(graphed, eager):
        np.testing.assert_array_equal(a, b)
    assert e_eng.graph_pool_bytes() == {}
    kinds = {k[0] for k in g_eng.graph_pool_bytes()}
    assert "prefill" in kinds and "step" in kinds
    if mode == "spec":
        assert "verify" in kinds
    if mode == "radix":
        assert {"gather", "prefill_sfx"} <= kinds


@pytest.mark.cuda
def test_graphed_recorded_pairs_stay_bounded_over_shapes_on_card(
        cuda_nvcc, monkeypatch):
    """Four input shapes, each trained on again and again, through a
    block that keeps at most two recorded graph pairs: each call equals
    the unhybridized net's bit for bit, two instances are kept, and the
    card's reserved memory stops growing once the pairs are bounded (an
    evicted pair's pool goes back at the next capture)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import block as gluon_block

    ctx = mx.gpu(0)
    rng = np.random.RandomState(2)
    xs = [mx.nd.array(rng.normal(size=(n, 32)).astype(np.float32), ctx=ctx)
          for n in (8192, 12288, 16384, 20480)]
    plain, hyb = _rec_net(mx, ctx), _rec_net(mx, ctx)
    monkeypatch.setattr(gluon_block, "_MAX_RECORDED_GRAPHS", 2)
    hyb.hybridize()
    reserved = []
    for _ in range(4):
        for x in xs:
            want = _rec_steps(mx, plain, [x])
            got = _rec_steps(mx, hyb, [x])
            assert got[0] == want[0]
            for g, w in zip(got[1], want[1]):
                np.testing.assert_array_equal(g, w)
        op = hyb._cached_op
        # the first round is every shape's warm-up
        assert sum(len(e.instances) for e in op._rec_graphs.values()) == \
            (2 if reserved else 0)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert op.recorded_graph_bytes() > 0
    assert max(reserved[2:]) <= reserved[1] + 4 * 2 ** 20, reserved
    stats = hyb.cache_stats()
    assert stats["recorded"] == 0 and "over_budget" not in stats


@pytest.mark.cuda
def test_serving_graph_table_and_budget_on_card(cuda_nvcc, monkeypatch):
    """``capture_buckets=True``: the bucket table's prefill and scatter
    graphs are captured when the server is built and serving captures
    nothing more; past the graphs' budget every program runs eagerly.
    Both give the NaiveEngine's tokens."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cuda_graph, serving

    net = _tiny_llama(mx, mx.gpu(0), seed=3)
    rs = np.random.RandomState(10)
    prompts = [rs.randint(1, 250, size=n) for n in (5, 17, 40)]
    kw = dict(max_batch=2, max_length=64, min_length=8, num_slots=2)

    def serve(**more):
        srv = serving.GenerativeServer(net, serving.ServerConfig(**kw,
                                                                 **more))
        built = dict(srv.engine._graphs or {})
        with srv:
            got = [srv.submit(p, max_new_tokens=8).result(120)
                   for p in prompts]
        return got, srv.engine, built

    prev = mx.engine.engine_type()
    mx.engine.set_engine_type("NaiveEngine")
    try:
        eager, _, _ = serve()
    finally:
        mx.engine.set_engine_type(prev)
    got, eng, built = serve(capture_buckets=True)
    table = serving.ServerConfig(**kw).policy.signatures()
    assert set(built) == {(p, kb, lb) for p in ("prefill", "scatter")
                          for kb, lb in table}
    assert set(eng._graphs) == set(built)
    assert all(e != "eager" for e in eng._graphs.values())
    pools = eng.graph_pool_bytes()
    assert pools[("arena",)] > 0 and eng._graph_bytes() == sum(
        pools.values())
    for a, b in zip(got, eager):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(cuda_graph, "budget", lambda device: 1)
    got, eng, _ = serve()
    assert eng._graphs and all(e == "eager" for e in eng._graphs.values())
    for a, b in zip(got, eager):
        np.testing.assert_array_equal(a, b)

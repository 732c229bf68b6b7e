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

"""Flash attention of the PyTorch/CUDA port against the JAX package,
forward and backward.

The plain PyTorch versions (``_fa_forward_plain``, ``_fa_backward_plain``)
are held against the real Pallas kernels run in interpret mode on the
CPU, and against the chunked and dense JAX paths (and ``jax.vjp`` of the
dense reference) on the shapes the Pallas gate never takes.  With
``round_p=True`` the plain versions round P (and dS) to bf16 as the
tensor-core kernels do; held against the Pallas kernels at bf16 inputs
within ``chip_smoke.py``'s card tolerances, that shows the rounding fits
the card check.  The CUDA kernels themselves are compared with the plain
versions on the card in ``test_torch_kernels_cuda.py``.
"""
import contextlib
import importlib.util
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import flash_attention as jfa
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tfa


def _chip_smoke():
    """``chip_smoke.py`` as a module, for its tolerances (it imports
    nothing at the top that needs a card)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _qkv(seed, b, h, tq, tk, d):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(b, h, tq, d)).astype(np.float32),
            rng.normal(size=(b, h, tk, d)).astype(np.float32),
            rng.normal(size=(b, h, tk, d)).astype(np.float32))


def _plain(q, k, v, causal, scale):
    o, lse = tfa._fa_forward_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal, scale)
    return o.numpy(), lse.numpy()


def _dense_lse(q, k, causal, scale):
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    if causal:
        tq, tk = s.shape[-2:]
        s = np.where(np.tril(np.ones((tq, tk), bool), k=tk - tq), s,
                     -np.inf)
    m = s.max(-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return m + np.log(np.exp(s - np.where(np.isfinite(m), m,
                                              0)[..., None]).sum(-1))


# O and lse: both sides are f32 online softmax over the same scores and
# differ only in block order, so 1e-5 absolute holds.
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (2, 4, 128, 16)])
def test_plain_matches_interpret_pallas_kernel(causal, shape):
    b, h, t, d = shape
    q, k, v = _qkv(0, b, h, t, t, d)
    scale = 1.0 / math.sqrt(d)
    o_ref, lse_ref = jfa._fa_forward_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        with_lse=True, interpret=True)
    o, lse = _plain(q, k, v, causal, scale)
    assert o.dtype == np.float32 and o.shape == shape
    assert lse.shape == (b, h, t)
    assert np.abs(o - np.asarray(o_ref)).max() <= 1e-5
    lse_ref = np.asarray(lse_ref)
    assert np.isfinite(lse_ref).all()
    assert np.abs(lse - lse_ref).max() <= 1e-5


@pytest.mark.parametrize("causal,tq,tk", [
    (False, 200, 200),   # ragged T, no 128 multiple
    (True, 200, 200),
    (True, 4, 6),        # Tq < Tk: bottom-right causal alignment
    (True, 6, 4),        # Tq > Tk: rows 0 and 1 see no key
])
def test_plain_matches_reference_on_unaligned_shapes(causal, tq, tk):
    q, k, v = _qkv(1, 2, 3, tq, tk, 32)
    scale = 0.2
    o, lse = _plain(q, k, v, causal, scale)
    chunked = np.asarray(jfa._fa_forward_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        block=64))
    assert np.abs(o - chunked).max() <= 1e-5
    dense = np.asarray(jfa._sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, scale))
    lse_ref = _dense_lse(q, k, causal, scale)
    seen = np.isfinite(lse_ref)
    assert np.abs(o - dense)[seen].max() <= 1e-5
    assert np.abs(lse[seen] - lse_ref[seen]).max() <= 1e-5
    # rows that see no key: O = 0, lse = -inf (the dense softmax gives NaN)
    assert (o[~seen] == 0).all()
    assert np.isneginf(lse[~seen]).all()
    assert seen.all() == (tq <= tk or not causal)


def test_bottom_right_alignment_differs_from_top_left():
    """Tq=4, Tk=6: query i sees keys j <= i + 2.  torch's is_causal is
    top-left (j <= i); the port must not take it."""
    q, k, v = _qkv(2, 1, 2, 4, 6, 16)
    o, _ = _plain(q, k, v, True, 0.25)
    top_left = torch.nn.functional.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True,
        scale=0.25).numpy()
    assert np.abs(o - top_left).max() > 0.1
    ref = np.asarray(jfa._sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), True, 0.25))
    assert np.abs(o - ref).max() <= 1e-5


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_ref_matches_reference(causal):
    q, k, v = _qkv(3, 2, 2, 32, 32, 16)
    ref = np.asarray(jfa._sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, 0.25))
    got = tfa._sdpa_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal, 0.25).numpy()
    assert np.abs(got - ref).max() <= 1e-5


def test_wrapper_takes_plain_version_on_cpu_only():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 2, 64, 64, 32))
    before = tfa.flash_attention_fwd.launches
    out = tfa.flash_attention_raw(q, k, v, True)
    o, _ = tfa._fa_forward_plain(q, k, v, True, 1.0 / math.sqrt(32))
    assert torch.equal(out, o)
    assert tfa.flash_attention_fwd.launches == before == 0


# dq/dk/dv: both sides recompute P from the same f32 lse and sum the same
# products in another order, so 1e-5 absolute at these magnitudes.
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_backward_matches_interpret_pallas_kernels(causal, d):
    b, h, t = 2, 2, 256
    q, k, v = _qkv(10 + d, b, h, t, t, d)
    do = np.random.RandomState(d).normal(size=q.shape).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    o, lse = jfa._fa_forward_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        with_lse=True, interpret=True)
    ref = jfa._fa_backward_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, jnp.asarray(do),
        lse, causal, scale, interpret=True)
    got = tfa._fa_backward_plain(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, do, lse)),
        causal, scale)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-5


def _vjp_reference(q, k, v, do, causal, scale):
    """jax.vjp of the dense reference ``_sdpa_ref``."""
    _, pull = jax.vjp(lambda a, b, c: jfa._sdpa_ref(a, b, c, causal, scale),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in pull(jnp.asarray(do))]


@pytest.mark.parametrize("causal,tq,tk", [
    (False, 200, 200),   # ragged T, no 128 multiple
    (True, 200, 200),
    (True, 4, 6),        # Tq < Tk: bottom-right causal alignment
    (True, 70, 130),
])
def test_plain_backward_matches_vjp_of_reference(causal, tq, tk):
    q, k, v = _qkv(11, 2, 3, tq, tk, 32)
    do = np.random.RandomState(12).normal(size=q.shape).astype(np.float32)
    scale = 0.2
    o, lse = _plain(q, k, v, causal, scale)
    got = tfa._fa_backward_plain(
        *(torch.from_numpy(a) for a in (q, k, v, o, do, lse)), causal, scale)
    for g, r in zip(got, _vjp_reference(q, k, v, do, causal, scale)):
        assert np.abs(g.numpy() - r).max() <= 1e-5


def test_fully_masked_rows_get_zero_dq():
    """Tq=6 > Tk=4, causal: rows 0 and 1 see no key (lse = -inf).  Their
    dq is exactly 0, they add nothing to dk/dv, and nothing is NaN (the
    dense reference's vjp is NaN there)."""
    q, k, v = _qkv(13, 1, 2, 6, 4, 32)
    do = np.random.RandomState(14).normal(size=q.shape).astype(np.float32)
    o, lse = _plain(q, k, v, True, 0.3)
    dq, dk, dv = tfa._fa_backward_plain(
        *(torch.from_numpy(a) for a in (q, k, v, o, do, lse)), True, 0.3)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert bool((dq[:, :, :2] == 0).all())
    # rows 2..5 alone give the same dk, dv
    q2, do2, o2 = q[:, :, 2:], do[:, :, 2:], o[:, :, 2:]
    _, dk2, dv2 = tfa._fa_backward_plain(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (q2, k, v, o2, do2, lse[:, :, 2:])), True, 0.3)
    assert torch.allclose(dk, dk2, atol=1e-6)
    assert torch.allclose(dv, dv2, atol=1e-6)
    ref = _vjp_reference(q, k, v, do, True, 0.3)
    assert np.abs(dq[:, :, 2:].numpy() - ref[0][:, :, 2:]).max() <= 1e-5


@pytest.mark.parametrize("causal,tq,tk", [(True, 64, 64), (False, 33, 47),
                                          (True, 9, 17)])
def test_autograd_function_matches_torch_autograd_of_sdpa_ref(causal, tq,
                                                              tk):
    """``flash_attention_raw`` is differentiable: on the CPU its
    gradients (the plain backward) equal torch autograd through the
    port's dense ``_sdpa_ref``, and no kernel is launched."""
    arrays = _qkv(15, 2, 2, tq, tk, 16)
    do = torch.from_numpy(
        np.random.RandomState(16).normal(size=(2, 2, tq, 16)).astype("f"))
    grads = []
    for fn in (tfa.flash_attention_raw, tfa._sdpa_ref):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
        out = fn(q, k, v, causal, 0.25)
        grads.append(torch.autograd.grad(out, (q, k, v), do))
    for g, r in zip(*grads):
        assert (g - r).abs().max().item() <= 1e-5
    assert tfa.flash_attention_bwd_dq.launches == 0
    assert tfa.flash_attention_bwd_dkv.launches == 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64])
def test_round_p_plain_matches_interpret_pallas_at_bf16(causal, d):
    """bf16 inputs: the plain versions with ``round_p=True`` (P rounded to
    bf16 before PV; P and dS before the dV, dQ and dK products) against
    the Pallas kernels in interpret mode (f32 P), within chip_smoke.py's
    O_TOL, LSE_TOL, ROW_TOL and NORM_TOL, and O against the plain version
    on f32 copies within O_ROW_TOL and O_NORM_TOL: the rounding the
    tensor-core kernels add fits the check the card holds them to."""
    cs = _chip_smoke()
    b, h, t = 1, 2, 256
    rng = np.random.RandomState(30 + d)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(
        np.float32)).bfloat16() for _ in range(4))

    def jax_bf16(x):
        return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)

    def to_torch(x):
        return torch.from_numpy(np.asarray(x).astype(np.float32))

    scale = 1.0 / math.sqrt(d)
    o_ref, lse_ref = jfa._fa_forward_pallas(
        jax_bf16(q), jax_bf16(k), jax_bf16(v), causal, scale, with_lse=True,
        interpret=True)
    o, lse = tfa._fa_forward_plain(q, k, v, causal, scale, round_p=True)
    assert o.dtype == torch.bfloat16
    assert not torch.equal(o, tfa._fa_forward_plain(q, k, v, causal,
                                                    scale)[0])
    assert (o.float() - to_torch(o_ref)).abs().max().item() <= \
        cs.O_TOL["bfloat16"]
    assert (lse - to_torch(lse_ref)).abs().max().item() <= cs.LSE_TOL
    # O row by row and by norm, as the card holds the kernel: against the
    # plain version on f32 copies (f32 P, O not rounded)
    o_f32, _ = tfa._fa_forward_plain(q.float(), k.float(), v.float(), causal,
                                     scale)
    _, share, norm = cs.grad_errors(torch, o, o_f32)
    assert share <= cs.O_ROW_TOL["bfloat16"], share
    assert norm <= cs.O_NORM_TOL["bfloat16"], norm

    ref = jfa._fa_backward_pallas(
        jax_bf16(q), jax_bf16(k), jax_bf16(v), o_ref, jax_bf16(do), lse_ref,
        causal, scale, interpret=True)
    args = (q, k, v, to_torch(o_ref).bfloat16(), do, to_torch(lse_ref),
            causal, scale)
    got = tfa._fa_backward_plain(*args, round_p=True)
    # the rounding of dS reaches dQ too, as the tensor-core dQ kernel has it
    assert not torch.equal(got[0], tfa._fa_backward_plain(*args)[0])
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.bfloat16
        _, share, norm = cs.grad_errors(torch, g, to_torch(r))
        assert norm <= cs.NORM_TOL["bfloat16"], norm
        # dQ's row 0 by norm only: it is exactly 0 in the Pallas result (a
        # causal query 0 sees key 0 alone, and dP - delta cancels) and
        # f32 noise of about 2e-7 in the plain one, with or without round_p
        if i == 0:
            _, share, _ = cs.grad_errors(torch, g[:, :, 1:],
                                         to_torch(r)[:, :, 1:])
        assert share <= cs.ROW_TOL["bfloat16"], share


def test_wrapper_round_p_default_is_off():
    """The CPU route of the wrappers keeps exact f32 P (round_p=False)."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(31, 1, 2, 64,
                                                            64, 32))
    o, _ = tfa.flash_attention_fwd(q, k, v, True)
    assert torch.equal(o, tfa._fa_forward_plain(q, k, v, True,
                                                1.0 / math.sqrt(32))[0])


def test_wrapper_launches_the_design_of_its_dtype(monkeypatch):
    """bf16 and f16 launch the tensor-core entry points (``_mma``), f32 the
    FMA ones (``_fma``), for each of the three kernels.  Driven with meta
    tensors and a stand-in library that records the C entry point each
    wrapper calls; each design counts its own launches."""
    calls = []

    class Lib:
        def __getattr__(self, symbol):
            def entry(*args):
                calls.append(symbol)
                return 0
            return entry

    monkeypatch.setattr(_kernels, "load", lambda name: Lib())
    monkeypatch.setattr(tfa, "_check_kernel_operands", lambda *a: None)
    # meta tensors dispatch the forward's custom op to its fake
    # implementation: the test reaches its CUDA implementation directly
    monkeypatch.setattr(tfa, "_fa_fwd_op", tfa._fa_fwd_cuda)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    fwd, dq, dkv = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                    tfa.flash_attention_bwd_dkv)
    for fn in (fwd, dq, dkv):
        for key in [a for a in vars(fn) if a.startswith("launches")]:
            monkeypatch.setattr(fn, key, 0)
    for dtype, design in [(torch.bfloat16, "mma"), (torch.float16, "mma"),
                          (torch.float32, "fma")]:
        assert tfa._design(dtype) == design
        q = torch.empty(1, 2, 8, 32, device="meta", dtype=dtype)
        lse = torch.empty(1, 2, 8, device="meta")
        tfa.flash_attention_fwd(q, q, q, True)
        tfa.flash_attention_bwd_dq(q, q, q, q, lse, lse, True, 0.3)
        tfa.flash_attention_bwd_dkv(q, q, q, q, lse, lse, True, 0.3)
        assert calls[-3:] == [f"mxt_flash_attention_fwd_{design}",
                              f"mxt_flash_attention_bwd_dq_{design}",
                              f"mxt_flash_attention_bwd_dkv_{design}"]
    assert (fwd.launches, fwd.launches_mma) == (3, 2)
    assert (dq.launches, dq.launches_mma) == (3, 2)
    assert (dkv.launches, dkv.launches_mma) == (3, 2)
    declared = {**_kernels.SYMBOLS["flash_attention_fwd"],
                **_kernels.SYMBOLS["flash_attention_bwd"]}
    assert set(calls) <= set(declared)


def test_wrappers_pad_head_dims_to_the_next_instance(monkeypatch):
    """D = 24 reaches the kernels as D = 32 (zero-padded, forward and both
    backward kernels) and comes back as D = 24; the instance dims pass
    through, and above 128 there is no instance to pad to.  Driven with
    meta tensors and a stand-in library that records each entry point's
    arguments."""
    seen = []

    class Lib:
        def __getattr__(self, symbol):
            def entry(*args):
                seen.append((symbol, args))
                return 0
            return entry

    monkeypatch.setattr(_kernels, "load", lambda name: Lib())
    monkeypatch.setattr(tfa, "_check_kernel_operands", lambda *a: None)
    # meta tensors dispatch the forward's custom op to its fake
    # implementation: the test reaches its CUDA implementation directly
    monkeypatch.setattr(tfa, "_fa_fwd_op", tfa._fa_fwd_cuda)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    for fn in (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
               tfa.flash_attention_bwd_dkv):
        for key in [a for a in vars(fn) if a.startswith("launches")]:
            monkeypatch.setattr(fn, key, 0)  # restored after the test
    assert [tfa._padded_head_dim(d) for d in (8, 16, 24, 48, 80, 96, 128,
                                               200)] == \
        [16, 16, 32, 64, 128, 128, 128, 200]
    for d, instance in [(24, 32), (48, 64), (96, 128), (64, 64)]:
        seen.clear()
        q = torch.empty(1, 2, 8, d, device="meta", dtype=torch.bfloat16)
        lse = torch.empty(1, 2, 8, device="meta")
        o, _ = tfa.flash_attention_fwd(q, q, q, True)
        grads = tfa.flash_attention_bwd(q, q, q, o, q, lse, True)
        assert o.shape == q.shape
        assert [g.shape for g in grads] == [q.shape] * 3
        # the head dim follows the pointers and (B·H, Tq, Tk)
        n_ptr = {s: len(a) - 8 for s, a in {
            **_kernels.SYMBOLS["flash_attention_fwd"],
            **_kernels.SYMBOLS["flash_attention_bwd"]}.items()}
        assert [args[n_ptr[s] + 3] for s, args in seen] == [instance] * 3


def test_padded_plain_route_equals_the_unpadded_plain_version():
    """On the CPU the wrappers pad as on the card and hand the padded
    tensors to the plain versions: the same O, lse and gradients as the
    plain versions at the unpadded D (zero columns add exact zeros)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(41, 1, 2, 40, 56, 24))
    do = torch.from_numpy(np.random.RandomState(42).normal(
        size=q.shape).astype(np.float32))
    o, lse = tfa.flash_attention_fwd(q, k, v, True, 0.3)
    o_ref, lse_ref = tfa._fa_forward_plain(q, k, v, True, 0.3)
    assert o.shape == q.shape
    torch.testing.assert_close(o, o_ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-6, atol=1e-6)
    got = tfa.flash_attention_bwd(q, k, v, o, do, lse, True, 0.3)
    ref = tfa._fa_backward_plain(q, k, v, o_ref, do, lse_ref, True, 0.3)
    for g, r, t in zip(got, ref, (q, k, v)):
        assert g.shape == r.shape == t.shape
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)

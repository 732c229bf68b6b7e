"""Attention ops of the PyTorch/CUDA port against the JAX package.

``dot_product_attention`` (and ``sdpa_raw``), ``div_sqrt_dim`` and the
interleaved self-attention pair, forward and gradients, on the same
numpy inputs in both packages.  The port's unmasked calls run the flash
kernels' plain versions (CPU tensors); its masked calls run the plain
masked route, which must give the mean of V for a row whose keys are
all masked, as ``jax.nn.dot_product_attention`` does.  Everything runs
on the CPU.

Tolerances: f32 on both sides, other summation orders: 2e-5 absolute on
outputs and gradients of magnitude about 1.  bf16: both sides round the
same f32 scores' softmax to bf16 and take a bf16 product; the results
differ by summation order in f32 before their last rounding, at most two
bf16 steps (2 * 2^-8) of the largest output.
"""
import functools

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import flash_attention as jfa

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import flash_attention as tfa

CPU = tmx.cpu()
TOL = 2e-5
BF16_TOL = 2 * 2.0 ** -8


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run(pkg, autograd, arrays, fn, grad_out, ctx=None):
    """``fn`` over NDArrays of ``arrays`` (the float ones get gradients)
    → (output, [gradient of each float input])."""
    kw = {"ctx": ctx} if ctx is not None else {}
    nds = [pkg.nd.array(a, **kw) if a.dtype != np.bool_ else
           pkg.nd.array(a, dtype="bool", **kw) for a in arrays]
    live = [x for x, a in zip(nds, arrays) if a.dtype == np.float32]
    for x in live:
        x.attach_grad()
    with autograd.record():
        out = fn(*nds)
    out.backward(pkg.nd.array(grad_out, **kw))
    return out.asnumpy(), [x.grad.asnumpy() for x in live]


def _both(arrays, make_fn, grad_out):
    ref = _run(jmx, jautograd, arrays, make_fn(jmx), grad_out)
    got = _run(tmx, tautograd, arrays, make_fn(tmx), grad_out, ctx=CPU)
    return ref, got


def _close(got, ref, tol=TOL):
    (o, gs), (o_ref, gs_ref) = got, ref
    assert o.shape == o_ref.shape and np.isfinite(o).all()
    np.testing.assert_allclose(o, o_ref, atol=tol, rtol=0)
    assert len(gs) == len(gs_ref)
    for g, g_ref in zip(gs, gs_ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, g_ref, atol=tol, rtol=0)


def _mask(b, tq, tk, seed):
    """(B, 1, Tq, Tk) boolean mask, random, with query 0 of batch 0
    seeing no key at all."""
    m = np.random.RandomState(seed).rand(b, 1, tq, tk) < 0.7
    m[0, 0, 0, :] = False
    return m


CASES = {
    # name: (B, Tq, Tk, N, N_kv, H, causal, masked)
    "unmasked": (2, 8, 8, 2, 2, 16, False, False),
    "unmasked_cross": (2, 5, 9, 2, 2, 16, False, False),
    "causal": (2, 8, 8, 2, 2, 16, True, False),
    "masked": (2, 8, 8, 2, 2, 16, False, True),
    "masked_causal": (2, 8, 8, 2, 2, 16, True, True),
    "gqa": (2, 8, 8, 4, 2, 16, False, False),
    # the reference's jax.nn route: causal at Tq != Tk (top-left), and a
    # head dim above its kernel's 256
    "causal_cross": (1, 4, 6, 2, 2, 16, True, False),
    "wide_head": (1, 8, 8, 2, 2, 320, True, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dot_product_attention_forward_and_gradients(case):
    b, tq, tk, n, nkv, h, causal, masked = CASES[case]
    arrays = [_rand((b, tq, n, h), 1), _rand((b, tk, nkv, h), 2),
              _rand((b, tk, nkv, h), 3)]
    if masked:
        arrays.append(_mask(b, tq, tk, 4))

    def make(pkg):
        def fn(q, k, v, *m):
            return pkg.nd.dot_product_attention(
                q, k, v, mask=m[0] if m else None, causal=causal)
        return fn

    ref, got = _both(arrays, make, _rand((b, tq, n, h), 5))
    _close(got, ref)


def test_fully_masked_row_is_the_mean_of_v_in_both_packages():
    b, t, n, h = 2, 6, 2, 8
    q, k, v = (_rand((b, t, n, h), s) for s in (7, 8, 9))
    m = np.ones((b, 1, t, t), bool)
    m[1, 0, 3, :] = False
    ref = jatt.sdpa_raw(jmx.nd.array(q)._data, jmx.nd.array(k)._data,
                        jmx.nd.array(v)._data, jmx.nd.array(
                            m, dtype="bool")._data)
    got = tatt.sdpa_raw(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), torch.from_numpy(m))
    mean_v = v[1].mean(axis=0)  # (N, H)
    np.testing.assert_allclose(np.asarray(ref)[1, 3], mean_v, atol=1e-6)
    np.testing.assert_allclose(got.numpy()[1, 3], mean_v, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_float_mask_reads_nonzero_as_attend():
    b, t, n, h = 1, 5, 1, 8
    q, k, v = (torch.from_numpy(_rand((b, t, n, h), s)) for s in (1, 2, 3))
    m = torch.from_numpy(_mask(b, t, t, 6))
    np.testing.assert_array_equal(
        tatt.sdpa_raw(q, k, v, m.float()).numpy(),
        tatt.sdpa_raw(q, k, v, m).numpy())


def test_unmasked_route_is_the_flash_function(monkeypatch):
    """Unmasked, equal heads, Tq = Tk or not causal, H <= 256:
    ``flash_attention_raw`` on (B, N, T, H) contiguous tensors; masked,
    grouped, causal at Tq != Tk or H > 256: never (the reference's
    rule)."""
    seen = []

    def spy(q, k, v, causal=False, scale=None):
        seen.append((tuple(q.shape), q.is_contiguous(), causal))
        return tfa.flash_attention_raw(q, k, v, causal, scale)

    monkeypatch.setattr(tatt, "flash_attention_raw", spy)
    q = torch.from_numpy(_rand((2, 7, 3, 16), 1))
    tatt.sdpa_raw(q, q, q, causal=True)
    assert seen == [((2, 3, 7, 16), True, True)]
    tatt.sdpa_raw(q, q, q, torch.ones(2, 1, 7, 7, dtype=torch.bool))
    tatt.sdpa_raw(q, q[:, :, :1], q[:, :, :1])
    assert len(seen) == 1
    kv = torch.from_numpy(_rand((2, 9, 3, 16), 2))
    tatt.sdpa_raw(q, kv, kv, causal=True)  # top-left in the reference
    assert len(seen) == 1
    tatt.sdpa_raw(q, kv, kv)  # no mask to align: the same function
    assert seen[1] == ((2, 3, 7, 16), True, False)
    wide = torch.from_numpy(_rand((1, 4, 2, 320), 3))
    tatt.sdpa_raw(wide, wide, wide, causal=True)
    assert len(seen) == 2
    tatt.sdpa_raw(wide[..., :256], wide[..., :256], wide[..., :256])
    assert seen[2] == ((1, 2, 4, 256), True, False)


# Where the port's route differed from the reference's before (causal at
# Tq != Tk: the flash kernels' bottom-right mask against jax.nn's top-left
# one, 2.07 apart; H > 256): the forward within 1e-5 of ``jatt.sdpa_raw``
# (f32 on both sides, scores of magnitude about 4, other summation orders).
@pytest.mark.parametrize("tq,tk,h", [(4, 6, 16), (6, 4, 16), (8, 8, 320),
                                     (4, 6, 320)])
def test_sdpa_raw_causal_matches_the_reference(tq, tk, h):
    b, n = 1, 2
    q, k, v = _rand((b, tq, n, h), 61), _rand((b, tk, n, h), 62), \
        _rand((b, tk, n, h), 63)
    ref = np.asarray(jatt.sdpa_raw(*(jmx.nd.array(a)._data
                                     for a in (q, k, v)), causal=True))
    got = tatt.sdpa_raw(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=True)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.fixture
def pallas_fwd(monkeypatch):
    """Route the JAX package's unmasked attention through its
    interpret-mode Pallas flash kernels, forward and backward."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(kind, fn):
        def run(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(jfa, "_on_tpu", lambda: True)
    monkeypatch.setattr(jfa, "_fa_forward_pallas", counted(
        "fwd", functools.partial(jfa._fa_forward_pallas, interpret=True)))
    monkeypatch.setattr(jfa, "_fa_backward_pallas", counted(
        "bwd", functools.partial(jfa._fa_backward_pallas, interpret=True)))
    return calls


def test_bert_shape_against_the_pallas_kernel(pallas_fwd):
    """BERT's head dim and length (T = 128, D = 64, non-causal) at a
    small batch: the JAX side runs the interpret-mode Pallas kernels."""
    b, t, n, h = 1, 128, 2, 64
    arrays = [_rand((b, t, n, h), s) for s in (11, 12, 13)]

    def make(pkg):
        return lambda q, k, v: pkg.nd.dot_product_attention(q, k, v)

    ref, got = _both(arrays, make, _rand((b, t, n, h), 14))
    assert pallas_fwd["fwd"] == 1 and pallas_fwd["bwd"] == 1
    _close(got, ref)


def test_masked_route_bf16():
    b, t, n, h = 2, 16, 2, 32
    q, k, v = (_rand((b, t, n, h), s) for s in (21, 22, 23))
    m = _mask(b, t, t, 24)
    jq, jk, jv = (jmx.nd.array(a).astype("bfloat16")._data
                  for a in (q, k, v))
    ref = np.asarray(jatt.sdpa_raw(jq, jk, jv, jmx.nd.array(
        m, dtype="bool")._data).astype(np.float32))
    tq_, tk_, tv_ = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = tatt.sdpa_raw(tq_, tk_, tv_, torch.from_numpy(m))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= BF16_TOL * np.abs(ref).max()


def test_div_sqrt_dim():
    x = _rand((3, 4, 10), 30)

    def make(pkg):
        return lambda a: pkg.nd.div_sqrt_dim(a)

    ref, got = _both([x], make, _rand((3, 4, 10), 31))
    _close(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interleaved_selfatt_ops(dtype):
    """qk then valatt (over the qk scores' softmax) in both packages,
    forward and the gradient of the interleaved input; bf16 held to two
    bf16 steps of each tensor's largest value."""
    t, b, e, heads = 6, 2, 8, 2
    qkv = _rand((t, b, 3 * e), 40)
    g = _rand((t, b, e), 41)

    def make(pkg):
        def fn(x):
            x = x.astype(dtype)
            scores = pkg.nd.interleaved_matmul_selfatt_qk(x, heads=heads)
            att = pkg.nd.softmax(scores, axis=-1)
            return pkg.nd.interleaved_matmul_selfatt_valatt(
                x, att, heads=heads).astype("float32")
        return fn

    ref, got = _both([qkv], make, g)
    if dtype == "float32":
        _close(got, ref)
        return
    for a, r in zip([got[0]] + got[1], [ref[0]] + ref[1]):
        assert np.abs(a - r).max() <= BF16_TOL * np.abs(r).max()


def test_interleaved_shapes():
    t, b, e, heads = 3, 2, 8, 2
    x = tmx.nd.array(_rand((t, b, 3 * e), 50), ctx=CPU)
    scores = tmx.nd.interleaved_matmul_selfatt_qk(x, heads=heads)
    assert scores.shape == (b * heads, t, t)
    out = tmx.nd.interleaved_matmul_selfatt_valatt(
        x, tmx.nd.softmax(scores, axis=-1), heads=heads)
    assert out.shape == (t, b, e)

"""LayerNorm, the LeakyReLU family (GELU among them) and Dropout of the
PyTorch/CUDA port against the JAX package, on the CPU.

Tolerances: f32 on both sides, other summation orders: 1e-5 absolute on
values of magnitude about 1 (LayerNorm's gradients sum over 64 rows).
bf16: both sides compute LayerNorm's statistics and its backward in f32
and round each result to bf16 once, so a value differs by at most one
bf16 step of itself (2^-8) plus the f32 difference: held to 2^-7 of the
tensor's largest value.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch.gluon import nn as tnn

CPU = tmx.cpu()
TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale +
            shift).astype(np.float32)


def _grads(pkg, autograd, arrays, fn, grad_out, dtype, ctx=None):
    kw = {"ctx": ctx} if ctx is not None else {}
    nds = [pkg.nd.array(a, **kw).astype(dt) for a, dt in zip(arrays, dtype)]
    for x in nds:
        x.attach_grad()
    with autograd.record():
        out = fn(*nds)
    out.backward(pkg.nd.array(grad_out, **kw).astype(dtype[0]))
    return [out.astype("float32").asnumpy()] + \
        [x.grad.astype("float32").asnumpy() for x in nds], \
        [str(out.dtype)] + [str(x.grad.dtype) for x in nds]


@pytest.mark.parametrize("dtype,pdtype", [("float32", "float32"),
                                          ("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16")])
def test_layer_norm_forward_and_three_gradients(dtype, pdtype):
    """y, dx, dgamma and dbeta against the reference's ``_ln_train``
    (through ``nd.layer_norm``); each in its operand's dtype, as the
    reference's are."""
    x = _rand((4, 16, 64), 0, scale=3.0, shift=1.5)
    g = _rand((64,), 1, scale=0.5, shift=1.0)
    b = _rand((64,), 2)
    dy = _rand((4, 16, 64), 3)
    dts = (dtype, pdtype, pdtype)

    def make(pkg):
        return lambda a, gg, bb: pkg.nd.layer_norm(a, gg, bb, axis=-1,
                                                    eps=1e-5)

    ref, ref_dt = _grads(jmx, jautograd, [x, g, b], make(jmx), dy, dts)
    got, got_dt = _grads(tmx, tautograd, [x, g, b], make(tmx), dy, dts,
                         ctx=CPU)
    assert [d.split(".")[-1] for d in got_dt] == \
        [dtype, dtype, pdtype, pdtype]
    assert [d.split(".")[-1] for d in ref_dt] == \
        [d.split(".")[-1] for d in got_dt]
    for a, r in zip(got, ref):
        assert np.isfinite(a).all()
        if dtype == "float32":
            np.testing.assert_allclose(a, r, atol=TOL, rtol=0)
        else:
            assert np.abs(a - r).max() <= BF16_TOL * np.abs(r).max()


def test_layer_norm_layer_over_axis_1():
    """The Gluon layer, deferred channels, over a non-last axis."""
    x = _rand((3, 5, 7), 4)
    jl = jmx.gluon.nn.LayerNorm(axis=1)
    jl.initialize()
    ref = jl(jmx.nd.array(x)).asnumpy()
    tl = tnn.LayerNorm(axis=1)
    tl.initialize(ctx=CPU)
    got = tl(tmx.nd.array(x, ctx=CPU)).asnumpy()
    assert tl.gamma.shape == (5,)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


ACTS = [("leaky", dict(slope=0.1)), ("elu", dict(slope=0.7)),
        ("selu", {}), ("gelu", {}), ("prelu", {})]


@pytest.mark.parametrize("act,kw", ACTS, ids=[a for a, _ in ACTS])
def test_leaky_relu_act_types(act, kw):
    x = _rand((4, 6), 5, scale=2.0)
    dy = _rand((4, 6), 6)
    arrays = [x] + ([_rand((6,), 7, scale=0.2, shift=0.25)]
                    if act == "prelu" else [])

    def make(pkg):
        def fn(a, *g):
            return pkg.nd.leaky_relu(a, gamma=g[0] if g else None,
                                     act_type=act, **kw)
        return fn

    dts = ["float32"] * len(arrays)
    ref, _ = _grads(jmx, jautograd, arrays, make(jmx), dy, dts)
    got, _ = _grads(tmx, tautograd, arrays, make(tmx), dy, dts, ctx=CPU)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, r, atol=TOL, rtol=1e-6)


@pytest.mark.parametrize("name,kw", [("GELU", {}), ("ELU", {"alpha": 0.5}),
                                     ("SELU", {}), ("Swish", {"beta": 1.5}),
                                     ("LeakyReLU", {"alpha": 0.2}),
                                     ("PReLU", {"in_channels": 8})])
def test_activation_layers(name, kw):
    """Each layer in both packages (PReLU's alpha: both initialize it to
    0.25)."""
    x = _rand((3, 8), 8, scale=2.0)
    jl, tl = getattr(jmx.gluon.nn, name)(**kw), getattr(tnn, name)(**kw)
    if name == "PReLU":
        jl.initialize()
        tl.initialize(ctx=CPU)
    ref = jl(jmx.nd.array(x)).asnumpy()
    got = tl(tmx.nd.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=1e-6)


def test_gelu_is_the_erf_form():
    x = torch.linspace(-4, 4, 101)
    got = tnn.GELU()(tmx.nd.array(x, ctx=CPU))._data
    want = 0.5 * x * (1 + torch.erf(x / np.sqrt(2.0)))
    assert torch.allclose(got, want, atol=1e-6)


def test_dropout_is_the_identity_at_rate_0_and_outside_training():
    x = _rand((8, 16), 9)
    xt = tmx.nd.array(x, ctx=CPU)
    layer = tnn.Dropout(0.5)
    np.testing.assert_array_equal(layer(xt).asnumpy(), x)  # not training
    with tautograd.record():
        np.testing.assert_array_equal(tnn.Dropout(0.0)(xt).asnumpy(), x)
    with tautograd.predict_mode():
        np.testing.assert_array_equal(tmx.nd.dropout(xt, p=0.5).asnumpy(),
                                      x)
    jx = jmx.nd.array(x)
    np.testing.assert_array_equal(jmx.gluon.nn.Dropout(0.5)(jx).asnumpy(),
                                  x)


def test_dropout_keeps_1_minus_p_and_scales_by_its_inverse():
    """p = 0.1 over 2^20 elements: the kept share within 5 standard
    deviations of 0.9 (sd = sqrt(0.09 / 2^20) = 2.9e-4), every kept value
    x / 0.9 exactly as torch divides it, the dropped ones 0."""
    n = 1 << 20
    x = torch.rand(n) + 0.5
    tmx.random.seed(3)
    with tautograd.train_mode():
        y = tmx.nd.dropout(tmx.nd.array(x, ctx=CPU), p=0.1)._data
    kept = y != 0
    share = kept.float().mean().item()
    assert abs(share - 0.9) <= 5 * np.sqrt(0.09 / n)
    assert torch.equal(y[kept], x[kept] / 0.9)
    # mode="always" drops outside training too
    z = tmx.nd.dropout(tmx.nd.array(x, ctx=CPU), p=0.1, mode="always")
    assert (z._data == 0).any()


def test_dropout_axes_share_one_draw_and_the_seed_repeats_it():
    x = torch.ones(64, 8, 32)

    def draw(seed):
        tmx.random.seed(seed)
        with tautograd.train_mode():
            return tnn.Dropout(0.5, axes=(1,))(
                tmx.nd.array(x, ctx=CPU))._data

    y = draw(5)
    assert torch.equal(y, y[:, :1, :].expand_as(y))  # one draw along 1
    assert 0 < (y == 0).float().mean().item() < 1
    assert torch.equal(draw(5), y) and not torch.equal(draw(6), y)


def test_dropout_draws_from_the_package_generator_not_the_global_one():
    x = tmx.nd.array(torch.ones(1000), ctx=CPU)
    tmx.random.seed(11)
    torch.manual_seed(0)
    with tautograd.train_mode():
        a = tmx.nd.dropout(x, p=0.5)._data
    tmx.random.seed(11)
    torch.manual_seed(1)
    with tautograd.train_mode():
        b = tmx.nd.dropout(x, p=0.5)._data
    assert torch.equal(a, b)


def test_dropout_gradient_is_the_mask_over_1_minus_p():
    x = tmx.nd.array(torch.rand(4096) + 1.0, ctx=CPU)
    x.attach_grad()
    with tautograd.record():
        y = tmx.nd.dropout(x, p=0.25)
    y.backward(tmx.nd.ones((4096,), ctx=CPU))
    expect = (y._data != 0).float() / 0.75
    assert torch.equal(x.grad._data, expect)

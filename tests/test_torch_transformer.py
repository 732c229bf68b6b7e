"""The Transformer blocks of the PyTorch/CUDA port against the JAX
package: ``MultiHeadAttention`` (unmasked and masked), the encoder cell,
and the encoder-decoder ``Transformer`` forward and backward on a tiny
config, with the JAX package's weights carried over by structural name
(``convert.load_numpy_params``).  Dropout is 0, so both are
deterministic.  Everything runs on the CPU.

Tolerance: f32 on both sides, other summation orders through two layers
and a LayerNorm each sublayer: 1e-4 absolute on outputs and gradients
of magnitude about 1.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.models import transformer as jtr

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models import transformer as ttr

CPU = tmx.cpu()
TOL = 1e-4


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(make, *init_args):
    """(JAX block, the port's block with its weights)."""
    jnet = make(jtr)
    jnet.initialize(jmx.init.Xavier())
    jnet(*(jmx.nd.array(a) for a in init_args))
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    tnet = make(ttr)
    load_numpy_params(tnet, arrays, ctx=CPU)
    assert list(tnet._collect_params_with_prefix()) == list(arrays)
    return jnet, tnet


def _fwd_bwd(pkg, autograd, net, arrays, grad_out, ctx=None, dtypes=None):
    """Output, the input gradients of the float inputs, and every
    parameter's gradient by structural name."""
    kw = {"ctx": ctx} if ctx is not None else {}
    dtypes = dtypes or ["float32"] * len(arrays)
    nds = [pkg.nd.array(a, dtype=dt, **kw) for a, dt in zip(arrays, dtypes)]
    live = [x for x, dt in zip(nds, dtypes) if dt == "float32"]
    for x in live:
        x.attach_grad()
    with autograd.record():
        out = net(*nds)
    out.backward(pkg.nd.array(grad_out, **kw))
    params = {k: p.grad().asnumpy() for k, p in
              net._collect_params_with_prefix().items()}
    return out.asnumpy(), [x.grad.asnumpy() for x in live], params


def _close(got, ref):
    (o, gs, ps), (o_r, gs_r, ps_r) = got, ref
    assert o.shape == o_r.shape and np.isfinite(o).all()
    np.testing.assert_allclose(o, o_r, atol=TOL, rtol=0)
    for g, g_r in zip(gs, gs_r):
        np.testing.assert_allclose(g, g_r, atol=TOL, rtol=0)
    assert set(ps) == set(ps_r)
    for k in ps:
        np.testing.assert_allclose(ps[k], ps_r[k], atol=TOL, rtol=0,
                                   err_msg=k)


def test_positional_encoding_matches():
    ref = jtr.positional_encoding(20, 9).asnumpy()
    got = ttr.positional_encoding(20, 9, ctx=CPU).asnumpy()
    assert got.shape == (1, 20, 9)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention(masked):
    b, tq, tk, units, heads = 2, 5, 7, 16, 4
    q, kv = _rand((b, tq, units), 0), _rand((b, tk, units), 1)
    jnet, tnet = _pair(lambda m: m.MultiHeadAttention(units, heads),
                       q, kv, kv)
    arrays = [q, kv, kv]
    dtypes = ["float32"] * 3
    if masked:
        m = np.random.RandomState(2).rand(b, 1, tq, tk) < 0.6
        m[1, 0, 2, :] = False  # a query that sees no key
        arrays.append(m)
        dtypes.append("bool")

    g = _rand((b, tq, units), 3)
    ref = _fwd_bwd(jmx, jautograd, jnet, arrays, g, dtypes=dtypes)
    got = _fwd_bwd(tmx, tautograd, tnet, arrays, g, ctx=CPU, dtypes=dtypes)
    _close(got, ref)


def test_encoder_cell():
    b, t, units = 2, 6, 16
    x = _rand((b, t, units), 4)
    jnet, tnet = _pair(lambda m: m.TransformerEncoderCell(units, 32, 2), x)
    g = _rand((b, t, units), 5)
    _close(_fwd_bwd(tmx, tautograd, tnet, [x], g, ctx=CPU),
           _fwd_bwd(jmx, jautograd, jnet, [x], g))


def _mt(m):
    return m.Transformer(src_vocab_size=50, tgt_vocab_size=60,
                         num_layers=2, units=16, hidden_size=32,
                         num_heads=2, max_length=32, dropout=0.0)


def test_transformer_mt_forward_and_backward():
    rng = np.random.RandomState(6)
    src = rng.randint(0, 50, (2, 6)).astype(np.int32)
    tgt = rng.randint(0, 60, (2, 5)).astype(np.int32)
    jnet, tnet = _pair(_mt, src, tgt)
    g = _rand((2, 5, 60), 7)
    dts = ["int32", "int32"]
    got = _fwd_bwd(tmx, tautograd, tnet, [src, tgt], g, ctx=CPU, dtypes=dts)
    ref = _fwd_bwd(jmx, jautograd, jnet, [src, tgt], g, dtypes=dts)
    assert got[0].shape == (2, 5, 60)
    assert np.abs(got[2]["src_embed.weight"]).sum() > 0
    _close(got, ref)


def test_decoder_causal_mask_takes_the_masked_route(monkeypatch):
    """The decoder's self-attention gets a boolean tril mask (not
    ``causal=True``), so it runs the plain masked route; the encoder's
    and the cross attention, unmasked, run the flash function."""
    from mxnet_tpu_torch.ops import attention as tatt

    rng = np.random.RandomState(8)
    src = rng.randint(0, 50, (1, 4)).astype(np.int32)
    tgt = rng.randint(0, 60, (1, 3)).astype(np.int32)
    _, tnet = _pair(_mt, src, tgt)
    routes = []
    flash, plain = tatt.flash_attention_raw, tatt._sdpa_plain
    monkeypatch.setattr(tatt, "flash_attention_raw", lambda *a, **k: (
        routes.append("flash"), flash(*a, **k))[1])
    monkeypatch.setattr(tatt, "_sdpa_plain", lambda *a, **k: (
        routes.append("masked"), plain(*a, **k))[1])
    tnet(tmx.nd.array(src, ctx=CPU, dtype="int32"),
         tmx.nd.array(tgt, ctx=CPU, dtype="int32"))
    # 2 encoder layers (self), then 2 decoder layers (self, cross)
    assert routes == ["flash", "flash", "masked", "flash", "masked",
                      "flash"]


def test_later_target_tokens_do_not_change_earlier_logits():
    rng = np.random.RandomState(9)
    src = rng.randint(0, 50, (1, 3)).astype(np.int32)
    _, tnet = _pair(_mt, src, src)
    t1 = np.array([[4, 5, 6]], np.int32)
    t2 = np.array([[4, 5, 9]], np.int32)

    def run(t):
        return tnet(tmx.nd.array(src, ctx=CPU, dtype="int32"),
                    tmx.nd.array(t, ctx=CPU, dtype="int32")).asnumpy()

    o1, o2 = run(t1), run(t2)
    np.testing.assert_allclose(o1[0, :2], o2[0, :2], atol=1e-6)
    assert not np.allclose(o1[0, 2], o2[0, 2])
    assert torch.is_tensor(ttr._causal_mask(3, 2, torch.device("cpu"))._data)

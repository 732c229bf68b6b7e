"""A Llama decoder at head dim 256 of the PyTorch/CUDA port against the
JAX package, at a small size.

Head dim 256 is Gemma-2B's (hidden 2048 over 8 heads), which
``chip_smoke.py`` runs at full width on the card.  Here: hidden 512, 2
query heads and 1 key/value head (D = 256), 2 layers, intermediate 1024,
vocab 256, tied embeddings, RMSNorm eps 1e-6 and RoPE theta 10000 (as
Gemma-2B's config), B=2, T=128, f32.  Both packages get the same numpy
weights (``convert.load_numpy_params``).  The JAX side runs its
interpret-mode Pallas flash kernels forward and backward (they take
D = 256 as the whole block width), through the ``pallas_calls`` fixture,
which counts them; the port runs on the CPU, where the flash wrappers
hand D = 256, their instance, to the plain versions.  The tolerances are
``test_torch_llama_train.py``'s.
"""
import functools

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.models import llama as jllama
from mxnet_tpu.ops import flash_attention as jfa

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models import llama as tllama
from mxnet_tpu_torch.ops import flash_attention as tfa

CPU = tmx.cpu()
B, T, V = 2, 128, 256
CONFIG = dict(hidden_size=512, intermediate_size=1024, num_layers=2,
              num_heads=2, num_kv_heads=1, vocab_size=V, max_seq_len=T,
              rope_theta=10000.0, rms_eps=1e-6, tie_embeddings=True)


@pytest.fixture(scope="module")
def arrays():
    """Xavier-initialized weights of the D = 256 decoder, as numpy
    arrays."""
    jnet = jllama.LlamaForCausalLM(jllama.LlamaConfig(**CONFIG))
    jnet.initialize(jmx.init.Xavier())
    return {k: p.data().asnumpy() for k, p in
            jnet._collect_params_with_prefix().items()}


@pytest.fixture
def pallas_calls(monkeypatch):
    """Route the JAX flash attention through the interpret-mode Pallas
    kernels, forward and backward, and count the calls; record the head
    dim of each call of the port's plain forward."""
    calls = {"fwd": 0, "bwd": 0, "port_d": []}

    def counted(kind, fn):
        def run(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return run

    plain = tfa._fa_forward_plain

    def recorded(q, *a, **kw):
        calls["port_d"].append(q.shape[-1])
        return plain(q, *a, **kw)

    monkeypatch.setattr(jfa, "_on_tpu", lambda: True)
    monkeypatch.setattr(jfa, "_fa_forward_pallas", counted(
        "fwd", functools.partial(jfa._fa_forward_pallas, interpret=True)))
    monkeypatch.setattr(jfa, "_fa_backward_pallas", counted(
        "bwd", functools.partial(jfa._fa_backward_pallas, interpret=True)))
    monkeypatch.setattr(tfa, "_fa_forward_plain", recorded)
    return calls


def _nets(arrays):
    jnet = jllama.LlamaForCausalLM(jllama.LlamaConfig(**CONFIG))
    jnet.initialize()
    for name, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(arrays[name]))
    tnet = tllama.LlamaForCausalLM(tllama.LlamaConfig(**CONFIG))
    load_numpy_params(tnet, arrays, ctx=CPU)
    assert tnet.config.head_dim == 256
    return jnet, tnet


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (B, T)).astype(np.int32),
            rng.randint(0, V, (B, T)).astype(np.int32))


def _jax_loss(jnet, ids, labels):
    with jautograd.record():
        logits = jnet(jmx.nd.array(ids, dtype="int32"))
        loss = jmx.nd.softmax_cross_entropy(
            logits.reshape((-1, V)),
            jmx.nd.array(labels, dtype="int32").reshape((-1,))) / (B * T)
    loss.backward()
    return float(loss.asscalar())


def _port_loss(tnet, ids, labels):
    with tautograd.record():
        logits = tnet(tmx.nd.array(ids, ctx=CPU, dtype="int32"))
        loss = tmx.nd.softmax_cross_entropy(
            logits.reshape((-1, V)),
            tmx.nd.array(labels, ctx=CPU, dtype="int32").reshape((-1,))) / \
            (B * T)
    loss.backward()
    return float(loss.asscalar())


def _grads(net):
    return {k: p.grad().asnumpy() for k, p in
            net._collect_params_with_prefix().items()}


def test_logits_match_through_pallas_kernels(arrays, pallas_calls):
    """The forward at D = 256: one interpret-mode Pallas call a layer on
    the JAX side, the port's plain forward at its D = 256 instance; the
    logits within 1e-4 (f32, other summation orders)."""
    jnet, tnet = _nets(arrays)
    ids, _ = _batch(1)
    ref = jnet(jmx.nd.array(ids, dtype="int32")).asnumpy()
    assert pallas_calls["fwd"] == 2
    got = tnet(tmx.nd.array(ids, ctx=CPU, dtype="int32")).asnumpy()
    assert pallas_calls["port_d"] == [256, 256]
    assert got.shape == ref.shape == (B, T, V)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4


def test_gradients_match_through_pallas_kernels(arrays, pallas_calls):
    """One record/backward: the loss within 1e-5 and every parameter
    gradient within 1e-4 of the largest gradient of the same tensor."""
    jnet, tnet = _nets(arrays)
    ids, labels = _batch(2)
    ref = _jax_loss(jnet, ids, labels)
    assert (pallas_calls["fwd"], pallas_calls["bwd"]) == (2, 2)
    got = _port_loss(tnet, ids, labels)
    assert abs(got - ref) <= 1e-5
    jg, tg = _grads(jnet), _grads(tnet)
    # 9 a layer, the embedding, the norm and the LM head, which both
    # packages keep as a Parameter; tied, the head is the embedding and
    # the Parameter gets no gradient
    assert len(tg) == 2 * 9 + 3 and tg.keys() == jg.keys()
    assert not tg["lm_head.weight"].any() and not jg["lm_head.weight"].any()
    for name in jg:
        scale = max(np.abs(jg[name]).max(), 1e-6)
        assert np.abs(tg[name] - jg[name]).max() <= 1e-4 * scale, name


def test_three_sgd_steps_match(arrays, pallas_calls):
    """Three ``Trainer.step``s (SGD, momentum 0.9) on one batch: the loss
    at each step within 2e-5 and the final parameters within 2e-5."""
    jnet, tnet = _nets(arrays)
    hp = {"learning_rate": 0.1, "momentum": 0.9}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(hp))
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "sgd", dict(hp))
    ids, labels = _batch(3)
    losses = []
    for _ in range(3):
        ref = _jax_loss(jnet, ids, labels)
        jtr.step(1)
        got = _port_loss(tnet, ids, labels)
        ttr.step(1)
        losses.append(got)
        assert abs(got - ref) <= 2e-5
    assert losses[-1] < losses[0]
    assert (pallas_calls["fwd"], pallas_calls["bwd"]) == (6, 6)
    jp = {k: p.data().asnumpy() for k, p in
          jnet._collect_params_with_prefix().items()}
    for name, p in tnet._collect_params_with_prefix().items():
        assert np.abs(p.data().asnumpy() - jp[name]).max() <= 2e-5, name

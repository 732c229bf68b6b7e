"""Llama training of the PyTorch/CUDA port against the JAX package.

``llama_tiny`` (B=2, T=128: the flash route in the JAX package) is built
in both packages with the same weights, carried across as numpy arrays by
structural name (``convert.load_numpy_params``).  The JAX side is forced
through the interpret-mode Pallas kernels in both directions, the way
``tests/test_llama.py`` does it (``_interp_kernels``); the port runs on
the CPU, where the flash forward and backward take their plain PyTorch
versions.  Everything is f32.
"""
import functools

import numpy as np
import pytest
import torch

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


@pytest.fixture(scope="module")
def arrays():
    """Xavier-initialized llama_tiny weights, as numpy arrays."""
    jnet = jllama.llama_tiny()
    jnet.initialize(jmx.init.Xavier())
    return {k: p.data().asnumpy() for k, p in
            jnet._collect_params_with_prefix().items()}


@pytest.fixture
def pallas_calls(monkeypatch):
    """Route the JAX flash attention through the interpret-mode Pallas
    kernels, forward and backward, and count the calls."""
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


def _nets(arrays):
    jnet = jllama.llama_tiny()
    jnet.initialize()
    for name, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(arrays[name]))
    tnet = tllama.llama_tiny()
    load_numpy_params(tnet, arrays, ctx=CPU)
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


def test_gradients_match_through_pallas_kernels(arrays, pallas_calls):
    """One record/backward: the loss within 1e-5 and all 21 parameter
    gradients within 1e-4 of the largest gradient of the same tensor (f32
    on both sides; the attention backward sums in another order)."""
    jnet, tnet = _nets(arrays)
    ids, labels = _batch(1)
    ref = _jax_loss(jnet, ids, labels)
    assert pallas_calls == {"fwd": 2, "bwd": 2}
    got = _port_loss(tnet, ids, labels)
    assert abs(got - ref) <= 1e-5
    jg, tg = _grads(jnet), _grads(tnet)
    assert len(tg) == 21 and tg.keys() == jg.keys()
    for name in jg:
        scale = max(np.abs(jg[name]).max(), 1e-6)
        assert tg[name].dtype == np.float32
        assert np.abs(tg[name] - jg[name]).max() <= 1e-4 * scale, name


# Adam's m/(sqrt(v) + eps) makes every element's step about lr, however
# small its gradient: with the default eps = 1e-8 a gradient of ~1e-7,
# whose f32 last bits differ between the two packages, moves its weight
# by a step whose size those bits decide.  eps = 1e-4 keeps such steps
# small while still testing where eps enters (the uncorrected sqrt(v)).
@pytest.mark.parametrize("opt,hp", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 3e-3, "epsilon": 1e-4}),
])
def test_three_trainer_steps_match(arrays, pallas_calls, opt, hp):
    """Three ``Trainer.step``s on one batch: the loss at each step within
    2e-5 and the final parameters within 2e-5 (f32; differences in the
    gradients' last bits carry through the updates)."""
    jnet, tnet = _nets(arrays)
    jtr = jgluon.Trainer(jnet.collect_params(), opt, dict(hp))
    ttr = tmx.gluon.Trainer(tnet.collect_params(), opt, dict(hp))
    ids, labels = _batch(2)
    losses = []
    for _ in range(3):
        ref = _jax_loss(jnet, ids, labels)
        jtr.step(1)
        got = _port_loss(tnet, ids, labels)
        ttr.step(1)
        losses.append(got)
        assert abs(got - ref) <= 2e-5
    assert losses[-1] < losses[0]
    assert pallas_calls == {"fwd": 6, "bwd": 6}
    jp = {k: p.data().asnumpy() for k, p in
          jnet._collect_params_with_prefix().items()}
    for name, p in tnet._collect_params_with_prefix().items():
        assert np.abs(p.data().asnumpy() - jp[name]).max() <= 2e-5, name


def test_sdpa_mode_gradients_match(arrays, monkeypatch):
    """``attn_mode="sdpa"`` (dense attention under torch autograd) gives
    the JAX package's gradients too."""
    jnet, tnet = _nets(arrays)
    for cfg in (jnet.config, tnet.config):
        monkeypatch.setattr(cfg, "attn_mode", "sdpa")
    ids, labels = _batch(3)
    assert abs(_port_loss(tnet, ids, labels) -
               _jax_loss(jnet, ids, labels)) <= 1e-5
    jg, tg = _grads(jnet), _grads(tnet)
    for name in jg:
        scale = max(np.abs(jg[name]).max(), 1e-6)
        assert np.abs(tg[name] - jg[name]).max() <= 1e-4 * scale, name


def test_flash_route_runs_the_autograd_function(arrays):
    """The flash forward under record() is the autograd Function: its
    backward takes the plain backward on the CPU and launches no
    kernel."""
    _, tnet = _nets(arrays)
    ids, labels = _batch(4)
    with tautograd.record():
        logits = tnet(tmx.nd.array(ids, ctx=CPU, dtype="int32"))
        loss = logits.sum()
    node = logits._data.grad_fn
    seen, stack, names = set(), [node], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(n for n, _ in fn.next_functions)
    assert "_FlashAttentionBackward" in names
    counts = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    loss.backward()
    assert counts == (tfa.flash_attention_fwd.launches,
                      tfa.flash_attention_bwd_dq.launches,
                      tfa.flash_attention_bwd_dkv.launches) == (0, 0, 0)
    grad = tnet.model.layers[0].self_attn.q_proj.weight.grad().asnumpy()
    assert np.isfinite(grad).all() and np.abs(grad).max() > 0


def test_training_refusals_name_the_roadmap(arrays):
    _, tnet = _nets(arrays)
    for fn in (lambda: tnet.hybridize(remat=True),
               lambda: tnet.set_remat(True)):
        with pytest.raises(tmx.MXNetError, match="ROADMAP"):
            fn()
    tnet.hybridize(static_alloc=True)  # accepted; on the CPU, eager
    params = tnet.collect_params()
    with pytest.raises(tmx.MXNetError, match="ROADMAP"):
        tmx.gluon.Trainer(params, "sgd", offload="host").step(1)
    # ported in slice 12: one process agrees with itself
    assert tmx.gluon.trainer.drain_consensus() is False
    assert isinstance(tmx.optimizer.create("lamb"), tmx.optimizer.LAMB)
    assert torch.is_grad_enabled()  # the port never flips global state

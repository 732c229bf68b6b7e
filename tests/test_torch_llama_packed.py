"""Packed Llama pretraining of the PyTorch/CUDA port against the JAX
package: ``segment_ids`` through the model, the segment-causal mask and
``packed_lm_loss``.

``llama_tiny`` is built in the JAX package (Xavier, float32); its weights
cross as numpy arrays, and the same packed batch (``data.SequencePacker``
of the JAX package over seeded documents) goes through both.  The packed
route is dense in both packages (no Pallas kernel, no flash kernel).
Everything here runs on the CPU.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import data as jdata
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.models import llama as jllama

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import data as tdata
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models import llama as tllama

CPU = tmx.cpu()
B, T, V = 2, 64, 256


@pytest.fixture(scope="module")
def arrays():
    jnet = jllama.llama_tiny()
    jnet.initialize(jmx.init.Xavier())
    return {k: p.data().asnumpy() for k, p in
            jnet._collect_params_with_prefix().items()}


def _nets(arrays):
    jnet = jllama.llama_tiny()
    jnet.initialize()
    for name, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(arrays[name]))
    tnet = tllama.llama_tiny()
    load_numpy_params(tnet, arrays, ctx=CPU)
    return jnet, tnet


def _packed(seed):
    """A packed (B, T) batch of seeded documents of 3..40 tokens, with
    padding at the end of a row."""
    rng = np.random.RandomState(seed)
    docs = [rng.randint(1, V, rng.randint(3, 41)).astype(np.int32)
            for _ in range(5)]
    batch, _ = jdata.pack_documents(docs, B, T)
    assert (batch.segment_ids == 0).any() and batch.segment_ids.max() > 1
    return batch


def _jax_loss(jnet, pb):
    with jautograd.record():
        logits = jnet(jmx.nd.array(pb.tokens, dtype="int32"),
                      jmx.nd.array(pb.segment_ids, dtype="int32"))
        loss = jllama.packed_lm_loss(
            logits, jmx.nd.array(pb.labels, dtype="int32"),
            jmx.nd.array(pb.loss_mask))
    loss.backward()
    return logits.asnumpy(), float(loss.asscalar())


def _port_loss(tnet, pb):
    with tautograd.record():
        logits = tnet(tmx.nd.array(pb.tokens, ctx=CPU, dtype="int32"),
                      tmx.nd.array(pb.segment_ids, ctx=CPU, dtype="int32"))
        loss = tllama.packed_lm_loss(
            logits, tmx.nd.array(pb.labels, ctx=CPU, dtype="int32"),
            tmx.nd.array(pb.loss_mask, ctx=CPU))
    loss.backward()
    return logits.asnumpy(), float(loss.asscalar())


def _grads(net):
    return {k: p.grad().asnumpy() for k, p in
            net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("attn_mode", ["flash", "sdpa"])
def test_packed_forward_matches(arrays, attn_mode):
    """The packed forward's logits within 1e-4 of the largest, in both
    attention modes (the packed route is the same dense one)."""
    jnet, _ = _nets(arrays)
    tnet = tllama.llama_tiny(attn_mode=attn_mode)
    load_numpy_params(tnet, arrays, ctx=CPU)
    pb = _packed(0)
    ref = jnet(jmx.nd.array(pb.tokens, dtype="int32"),
               jmx.nd.array(pb.segment_ids, dtype="int32")).asnumpy()
    got = tnet(tmx.nd.array(pb.tokens, ctx=CPU, dtype="int32"),
               tmx.nd.array(pb.segment_ids, ctx=CPU,
                            dtype="int32")).asnumpy()
    assert got.shape == (B, T, V) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_packed_route_takes_no_flash_kernel(arrays, monkeypatch):
    _, tnet = _nets(arrays)
    monkeypatch.setattr(tllama, "flash_attention_raw",
                        lambda *a: pytest.fail("flash route taken"))
    pb = _packed(1)
    tnet(tmx.nd.array(pb.tokens, ctx=CPU, dtype="int32"),
         tmx.nd.array(pb.segment_ids, ctx=CPU, dtype="int32"))


def test_documents_do_not_see_each_other(arrays):
    """A document's logits do not depend on the documents packed before
    it: the same document alone at the start of a row gives the same
    logits (within f32 rounding)."""
    _, tnet = _nets(arrays)
    rng = np.random.RandomState(5)
    a = rng.randint(1, V, 20).astype(np.int32)
    b = rng.randint(1, V, 30).astype(np.int32)
    both, _ = tdata.pack_documents([a, b], 1, T)
    alone, _ = tdata.pack_documents([b], 1, T)

    def run(pb):
        return tnet(tmx.nd.array(pb.tokens, ctx=CPU, dtype="int32"),
                    tmx.nd.array(pb.segment_ids, ctx=CPU,
                                 dtype="int32")).asnumpy()

    np.testing.assert_allclose(run(both)[0, 20:50], run(alone)[0, :30],
                               atol=1e-4)


def test_segment_causal_mask_keeps_the_diagonal():
    seg = torch.tensor([[1, 1, 2, 2, 0, 0]])
    m = tllama._segment_causal_mask(seg)[0, 0]
    assert m.shape == (6, 6) and bool(m.diagonal().all())
    assert not bool(m[2, 1]) and bool(m[3, 2]) and not bool(m[1, 2])
    assert bool(m[5, 4]) and not bool(m[4, 3])  # padding sees padding


def test_packed_loss_and_gradients_match(arrays):
    """``packed_lm_loss`` within 1e-5 and every parameter gradient within
    1e-4 of the largest gradient of the same tensor."""
    jnet, tnet = _nets(arrays)
    pb = _packed(2)
    _, ref = _jax_loss(jnet, pb)
    _, got = _port_loss(tnet, pb)
    assert abs(got - ref) <= 1e-5 * max(1.0, abs(ref))
    jg, tg = _grads(jnet), _grads(tnet)
    assert tg.keys() == jg.keys() and len(tg) == 21
    for name in jg:
        scale = max(np.abs(jg[name]).max(), 1e-6)
        assert np.abs(tg[name] - jg[name]).max() <= 1e-4 * scale, name


def test_packed_lm_loss_matches_on_random_logits():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 8, 11).astype(np.float32) * 3
    labels = rng.randint(0, 11, (2, 8)).astype(np.int32)
    mask = (rng.rand(2, 8) > 0.3).astype(np.float32)
    ref = jllama.packed_lm_loss(jmx.nd.array(logits),
                                jmx.nd.array(labels, dtype="int32"),
                                jmx.nd.array(mask)).asscalar()
    got = tllama.packed_lm_loss(tmx.nd.array(logits, ctx=CPU),
                                tmx.nd.array(labels, ctx=CPU,
                                             dtype="int32"),
                                tmx.nd.array(mask, ctx=CPU)).asscalar()
    assert abs(float(got) - float(ref)) <= 1e-6 * max(1.0, abs(float(ref)))
    zero = tllama.packed_lm_loss(tmx.nd.array(logits, ctx=CPU),
                                 tmx.nd.array(labels, ctx=CPU,
                                              dtype="int32"),
                                 tmx.nd.zeros((2, 8), ctx=CPU))
    assert float(zero.asscalar()) == 0.0  # no target: 0, not NaN


def test_three_packed_trainer_steps_match(arrays):
    """Three SGD ``Trainer.step``s on packed batches: each loss within
    2e-5 and the final parameters within 2e-5."""
    jnet, tnet = _nets(arrays)
    hp = {"learning_rate": 0.1, "momentum": 0.9}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(hp))
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "sgd", dict(hp))
    losses = []
    for step in range(3):
        pb = _packed(10 + step)
        _, ref = _jax_loss(jnet, pb)
        jtr.step(1)
        _, got = _port_loss(tnet, pb)
        ttr.step(1)
        losses.append(got)
        assert abs(got - ref) <= 2e-5 * max(1.0, abs(ref))
    jp = {k: p.data().asnumpy() for k, p in
          jnet._collect_params_with_prefix().items()}
    for name, p in tnet._collect_params_with_prefix().items():
        assert np.abs(p.data().asnumpy() - jp[name]).max() <= 2e-5, name

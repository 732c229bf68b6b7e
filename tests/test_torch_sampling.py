"""Sampling of the PyTorch/CUDA port's ``generate``.

JAX's PRNG is not torch's, so the draws cannot match the reference's.
What is held: the filters (temperature, top-k, nucleus) against the
reference's arithmetic (its ``LlamaDecoder._pick``, written out here in
numpy) on the same logits; ``top_k=1`` against greedy decoding (the JAX
package's, on the same weights); every draw inside the filtered support;
and one ``seed`` (or one ``mx.random.seed``) giving the same tokens
twice.  Everything runs on the CPU.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models import llama as jllama

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models import llama as tllama

CPU = tmx.cpu()


def _np_filter(logits, temperature, top_k, top_p):
    """The reference's ``_pick`` filters in numpy (f32)."""
    lg = logits.astype(np.float32) / np.float32(max(temperature, 1e-6))
    if top_k and top_k < lg.shape[-1]:
        kth = np.sort(lg, axis=-1)[:, -top_k][:, None]
        lg = np.where(lg < kth, -np.inf, lg).astype(np.float32)
    if top_p < 1.0:
        srt = np.sort(lg, axis=-1)[:, ::-1]
        e = np.exp(srt - srt[:, :1])
        probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
        cum = np.cumsum(probs, axis=-1, dtype=np.float32) - probs
        count = np.maximum((cum < top_p).sum(-1), 1)
        thresh = np.take_along_axis(srt, (count - 1)[:, None], axis=1)
        lg = np.where(lg < thresh, -np.inf, lg).astype(np.float32)
    return lg


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (0.5, 20, 1.0),
    (1.0, 0, 0.9), (1.3, 0, 0.5), (0.8, 40, 0.8), (1e-9, 0, 1.0),
    (1.0, 300, 1.0)])
def test_filters_match_the_reference_arithmetic(temperature, top_k,
                                                top_p):
    logits = np.random.RandomState(3).normal(size=(6, 256)) \
        .astype(np.float32) * 3
    got = tllama._filter_logits(torch.from_numpy(logits), temperature,
                                top_k, top_p).numpy()
    ref = _np_filter(logits, temperature, top_k, top_p)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6)
    kept = fin.sum(-1)
    assert (kept >= 1).all()
    if top_k and top_k < 256 and top_p == 1.0:
        assert (kept == top_k).all()


@pytest.fixture(scope="module")
def pair():
    jnet = jllama.llama_tiny()
    jnet.initialize()
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    tnet = tllama.llama_tiny()
    load_numpy_params(tnet, arrays, ctx=CPU)
    ids = np.random.RandomState(9).randint(1, 250, (2, 11)).astype(np.int32)
    return jnet, tnet, ids


def _gen(tnet, ids, n=10, **kw):
    return tnet.generate(tmx.nd.array(ids, ctx=CPU, dtype="int32"), n,
                         **kw).asnumpy()


def test_top_k_1_is_greedy(pair):
    jnet, tnet, ids = pair
    greedy = jnet.generate(jmx.nd.array(ids, dtype="int32"), 10).asnumpy()
    np.testing.assert_array_equal(
        _gen(tnet, ids, do_sample=True, top_k=1, seed=5), greedy)
    np.testing.assert_array_equal(_gen(tnet, ids), greedy)


def test_one_seed_gives_the_same_tokens(pair):
    _, tnet, ids = pair
    kw = dict(do_sample=True, temperature=1.5, top_p=0.95)
    a = _gen(tnet, ids, seed=11, **kw)
    np.testing.assert_array_equal(a, _gen(tnet, ids, seed=11, **kw))
    assert not np.array_equal(a, _gen(tnet, ids, seed=12, **kw))
    # without a seed: the package's generator of the device
    tmx.random.seed(4)
    b = _gen(tnet, ids, **kw)
    tmx.random.seed(4)
    np.testing.assert_array_equal(b, _gen(tnet, ids, **kw))


@pytest.mark.parametrize("top_k,top_p", [(4, 1.0), (0, 0.6)])
def test_draws_lie_in_the_filtered_support(pair, top_k, top_p):
    """Teacher-forced logits of the sampled sequence: every generated
    token is one the filters keep at its position."""
    _, tnet, ids = pair
    out = _gen(tnet, ids, n=12, do_sample=True, temperature=2.0,
               top_k=top_k, top_p=top_p, seed=1)
    t0 = ids.shape[1]
    logits = tllama.LlamaDecoder(tnet, 64).logits_at(out)
    for pos in range(t0, out.shape[1]):
        kept = np.isfinite(_np_filter(logits[:, pos - 1], 2.0, top_k,
                                      top_p))
        assert kept[np.arange(2), out[:, pos]].all()

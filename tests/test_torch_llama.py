"""Llama inference of the PyTorch/CUDA port against the JAX package.

``llama_tiny`` is built in the JAX package (float32), its weights cross
as numpy arrays keyed by structural name (``convert.load_numpy_params``),
and the same seeded ids go through both.  The JAX forward is forced
through the interpret-mode Pallas flash kernel, the way the JAX
package's own tests force it on the CPU.  Everything here runs on the
CPU (``mx.cpu()``).
"""
import functools

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models import llama as jllama
from mxnet_tpu.ops import flash_attention as jfa

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models import llama as tllama
from mxnet_tpu_torch.ops import flash_attention as tfa

CPU = tmx.cpu()


def _ids(b, t, seed=0, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    """(JAX llama_tiny, its numpy weights, the port's llama_tiny)."""
    jnet = jllama.llama_tiny()
    jnet.initialize()
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    assert all(a.dtype == np.float32 for a in arrays.values())
    tnet = tllama.llama_tiny()
    load_numpy_params(tnet, arrays, ctx=CPU)
    return jnet, arrays, tnet


def _jax_logits(jnet, ids):
    return jnet(jmx.nd.array(ids, dtype="int32")).asnumpy()


def _port_logits(tnet, ids):
    return tnet(tmx.nd.array(ids, ctx=CPU, dtype="int32")).asnumpy()


def test_structural_names_match(pair):
    jnet, arrays, tnet = pair
    names = list(tnet._collect_params_with_prefix())
    assert names == list(jnet._collect_params_with_prefix())
    assert len(names) == 21
    assert names[:3] == ["model.embed_tokens.weight",
                         "model.layers.0.input_layernorm.weight",
                         "model.layers.0.self_attn.q_proj.weight"]
    for name, p in tnet._collect_params_with_prefix().items():
        assert p.shape == arrays[name].shape
        assert p.data()._data.device.type == "cpu"
        assert p.data().dtype == torch.float32


def test_forward_matches_through_pallas_kernel(pair, monkeypatch):
    """B=2, T=128: the JAX side runs the interpret-mode Pallas kernel once
    per layer; logits agree within 1e-4 (f32 on both sides, different
    summation orders)."""
    jnet, _, tnet = pair
    calls = []
    kernel = functools.partial(jfa._fa_forward_pallas, interpret=True)

    def counted(*a, **kw):
        calls.append(1)
        return kernel(*a, **kw)

    monkeypatch.setattr(jfa, "_on_tpu", lambda: True)
    monkeypatch.setattr(jfa, "_fa_forward_pallas", counted)
    ids = _ids(2, 128, seed=1)
    ref = _jax_logits(jnet, ids)
    assert len(calls) == 2
    got = _port_logits(tnet, ids)
    assert got.shape == ref.shape == (2, 128, 256)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4


@pytest.mark.parametrize("tie", [False, True])
def test_sdpa_mode_forward_matches(pair, tie, monkeypatch):
    """Dense attention, and the tied LM head (the embedding matrix): the
    same nets with their configs switched for this test."""
    jnet, _, tnet = pair
    for cfg in (jnet.config, tnet.config):
        monkeypatch.setattr(cfg, "attn_mode", "sdpa")
        monkeypatch.setattr(cfg, "tie_embeddings", tie)
    ids = _ids(2, 48, seed=2)
    assert np.abs(_port_logits(tnet, ids) -
                  _jax_logits(jnet, ids)).max() <= 1e-4


@pytest.mark.parametrize("t0", [13, 40])
def test_generate_matches(pair, t0):
    """Greedy tokens from the KV-cached decoder are equal, B=2."""
    jnet, _, tnet = pair
    ids = _ids(2, t0, seed=t0)
    ref = jnet.generate(jmx.nd.array(ids, dtype="int32"),
                        max_new_tokens=8).asnumpy()
    got = tnet.generate(tmx.nd.array(ids, ctx=CPU, dtype="int32"),
                        max_new_tokens=8)
    assert got.dtype == torch.int32 and got.shape == (2, t0 + 8)
    np.testing.assert_array_equal(got.asnumpy(), ref)
    assert 64 in tnet._kv_decoders  # the reference's max_len bucket


def test_decoder_logits_at_matches(pair):
    """Teacher-forced single-token steps (the decode step path)."""
    jnet, _, tnet = pair
    ids = _ids(2, 12, seed=3)
    ref = jllama.LlamaDecoder(jnet, max_len=64).logits_at(ids)
    got = tllama.LlamaDecoder(tnet, max_len=64).logits_at(ids)
    assert got.shape == ref.shape == (2, 12, 256)
    assert np.abs(got - ref).max() <= 1e-4


def test_decoder_prefill_matches_forward(pair):
    """The decoder's dense prefill against the flash forward, in the
    port alone (the JAX package pins cached against uncached)."""
    _, _, tnet = pair
    ids = _ids(2, 40, seed=4)
    dec = tllama.LlamaDecoder(tnet, max_len=64)
    with torch.no_grad():
        _, logits = dec._prefill_impl(dec._weights(),
                                      torch.from_numpy(ids), 40)
    full = _port_logits(tnet, ids)[:, -1]
    assert np.abs(logits.numpy() - full).max() <= 1e-4


def test_generate_oracle_path_matches_cached(pair):
    _, _, tnet = pair
    p = tmx.nd.array(_ids(1, 5, seed=5), ctx=CPU, dtype="int32")
    slow = tnet.generate(p, max_new_tokens=4, use_cache=False)
    fast = tnet.generate(p, max_new_tokens=4)
    np.testing.assert_array_equal(slow.asnumpy(), fast.asnumpy())


def test_layers_match_reference():
    """Dense, Embedding and RMSNorm alone, same weights and inputs."""
    rng = np.random.RandomState(7)
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    w = rng.normal(size=(6, 8)).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    table = rng.normal(size=(10, 4)).astype(np.float32)
    ids = np.array([[0, 3, 9], [11, 2, -1]], np.int32)  # clipped ends
    g = rng.normal(size=(8,)).astype(np.float32)

    def both(jblock, tblock, inp, arrays):
        jblock.initialize()
        for name, p in jblock._collect_params_with_prefix().items():
            p.set_data(jmx.nd.array(arrays[name]))
        load_numpy_params(tblock, arrays, ctx=CPU)
        dt = "int32" if inp.dtype == np.int32 else "float32"
        return (jblock(jmx.nd.array(inp, dtype=dt)).asnumpy(),
                tblock(tmx.nd.array(inp, ctx=CPU, dtype=dt)).asnumpy())

    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn as tnn

    for flatten in (False, True):
        ref, got = both(jnn.Dense(6, flatten=flatten, in_units=8 if not
                                  flatten else 40),
                        tnn.Dense(6, flatten=flatten, in_units=8 if not
                                  flatten else 40),
                        x, {"weight": w if not flatten else
                            rng.normal(size=(6, 40)).astype(np.float32),
                            "bias": bias})
        assert np.abs(got - ref).max() <= 1e-5
    ref, got = both(jnn.Embedding(10, 4), tnn.Embedding(10, 4), ids,
                    {"weight": table})
    np.testing.assert_array_equal(got, ref)
    ref, got = both(jllama.RMSNorm(8), tllama.RMSNorm(8), x, {"weight": g})
    assert np.abs(got - ref).max() <= 1e-5


def test_rope_and_gqa_layouts_match_reference():
    """Interleaved-pair RoPE from float64 tables; GQA repeats each KV head
    ``rep`` times in place (repeat_interleave), not tiled."""
    import jax.numpy as jnp

    cos, sin = tllama._rope_tables(16, 8, 500000.0)
    jcos, jsin = jllama._rope_tables(16, 8, 500000.0)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    x = np.random.RandomState(8).normal(size=(1, 2, 16, 8)).astype("f")
    ref = np.asarray(jllama._apply_rope(jnp.asarray(x), jcos, jsin))
    got = tllama._apply_rope(torch.from_numpy(x), torch.from_numpy(cos),
                             torch.from_numpy(sin)).numpy()
    assert np.abs(got - ref).max() <= 1e-6
    kv = torch.arange(2.0).reshape(1, 2, 1, 1)
    assert kv.repeat_interleave(2, dim=1).flatten().tolist() == \
        np.repeat(np.arange(2.0), 2).tolist() == [0.0, 0.0, 1.0, 1.0]


def test_load_numpy_params_rejects_bad_names(pair):
    _, arrays, _ = pair
    missing = dict(arrays)
    missing.pop("model.norm.weight")
    with pytest.raises(tmx.MXNetError, match="missing"):
        load_numpy_params(tllama.llama_tiny(), missing, ctx=CPU)
    extra = dict(arrays, **{"model.extra.weight": np.zeros(3, "f")})
    with pytest.raises(tmx.MXNetError, match="extra"):
        load_numpy_params(tllama.llama_tiny(), extra, ctx=CPU)
    bad = dict(arrays)
    bad["lm_head.weight"] = np.zeros((256, 63), "f")
    fresh = tllama.llama_tiny()
    with pytest.raises(tmx.MXNetError, match="lm_head.weight"):
        load_numpy_params(fresh, bad, ctx=CPU)
    # nothing was written before the check failed
    assert all(p._data is None for p in
               fresh._collect_params_with_prefix().values())


def test_unported_features_raise_naming_the_roadmap(pair):
    # scan_layers and set_remat are ported in slice 21
    # (tests/test_torch_remat.py)
    assert tllama.llama_tiny(scan_layers=True).config.scan_layers is True
    # MoE ported in slice 13 (test_torch_moe)
    assert tllama.llama_tiny(num_experts=4).config.num_experts == 4
    # ring/ulysses attention ported in slice 11 (test_torch_llama_parallel)
    assert tllama.llama_tiny(attn_mode="ring").config.attn_mode == "ring"
    _, _, tnet = pair
    ids = tmx.nd.array(_ids(1, 4), ctx=CPU, dtype="int32")
    with pytest.raises(tmx.MXNetError, match="KV-cache path"):
        tnet.generate(ids, max_new_tokens=2, use_cache=False,
                      do_sample=True)
    with pytest.raises(tmx.MXNetError, match="max_seq_len"):
        tnet.generate(ids, max_new_tokens=200)
    for fn, experts in ((tllama.mixtral_8x7b, 8), (tllama.mixtral_tiny, 4)):
        assert fn(num_layers=1).config.num_experts == experts
    for fn in (tllama.llama_pipeline_forward,
               tllama.llama_pipeline_train_step):
        # ported in slice 12 (test_torch_llama_pipeline): without a mesh
        # they raise the reference's error
        with pytest.raises(tmx.MXNetError, match="no active mesh"):
            fn(tnet, ids, ids, 1) if fn is \
                tllama.llama_pipeline_train_step else fn(tnet, ids, 1)
    assert tnet.set_remat("dots") is tnet and tnet.model._remat == "dots"
    with pytest.raises(ValueError, match="unknown remat tier"):
        tnet.set_remat("everything")
    tnet.set_remat("layer")


def test_gradient_through_flash_matches_sdpa(pair, monkeypatch):
    """Under autograd.record() the flash forward is differentiable: the
    same loss through ``attn_mode="flash"`` and ``"sdpa"`` gives the same
    parameter gradients (f32, 1e-4 of the largest); outside record() no
    graph is built."""
    _, _, tnet = pair
    ids = tmx.nd.array(_ids(2, 40, seed=9), ctx=CPU, dtype="int32")
    grads = []
    for mode in ("flash", "sdpa"):
        monkeypatch.setattr(tnet.config, "attn_mode", mode)
        with tautograd.record():
            loss = (tnet(ids) * tnet(ids)).mean()
        loss.backward()
        grads.append({k: p.grad().asnumpy().copy() for k, p in
                      tnet._collect_params_with_prefix().items()})
    for name, ref in grads[1].items():
        scale = max(np.abs(ref).max(), 1e-6)
        assert np.abs(grads[0][name] - ref).max() <= 1e-4 * scale, name
    assert tnet(ids)._data.grad_fn is None


def test_head_dim_24_runs_the_padding_route_and_matches_jax(monkeypatch):
    """``llama_tiny(hidden_size=96)`` has head dim 24, between the kernel
    instances: the flash wrapper pads it to 32 (on the CPU as on the
    card, here into the plain version) and the logits match the JAX
    package's on the same weights."""
    jnet = jllama.llama_tiny(hidden_size=96)
    jnet.initialize()
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    tnet = tllama.llama_tiny(hidden_size=96)
    load_numpy_params(tnet, arrays, ctx=CPU)
    assert tnet.config.head_dim == 24
    seen = []
    plain = tfa._fa_forward_plain

    def recorded(q, *a, **kw):
        seen.append(q.shape[-1])
        return plain(q, *a, **kw)

    monkeypatch.setattr(tfa, "_fa_forward_plain", recorded)
    ids = _ids(2, 40, seed=5)
    got = _port_logits(tnet, ids)
    assert seen == [32, 32]   # once a layer, at the padded instance
    ref = _jax_logits(jnet, ids)
    assert got.shape == ref.shape == (2, 40, 256)
    assert np.abs(got - ref).max() <= 1e-4

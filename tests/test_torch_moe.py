"""The Mixture-of-Experts layer and Mixtral of the port against the JAX
package.

Weights are made in the reference (Xavier, f32) and cross as numpy
arrays keyed by structural name (``convert.load_numpy_params``); inputs
are numpy-seeded.  Everything on the port's side runs on the CPU.  The
reference's Mixtral forward runs its flash attention through the
interpret-mode Pallas kernels, forward and backward (the ``pallas_calls``
fixture of ``test_torch_llama_train``).

Tolerances (f32 on both sides, other summation orders): outputs and the
aux loss within 1e-5 of the tensor's largest value, gradients within
1e-4 of the largest gradient of the same tensor, Trainer steps' losses
within 1e-5 and weights within 1e-5 (rtol) and 1e-6 (atol); greedy
tokens exactly equal.
"""
import functools

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.models import llama as jllama
from mxnet_tpu.models import moe as jmoe
from mxnet_tpu.ops import flash_attention as jfa

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models import llama as tllama
from mxnet_tpu_torch.models import moe as tmoe

CPU = tmx.cpu()
H, I, E = 16, 32, 4


@pytest.fixture
def pallas_calls(monkeypatch):
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


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-6)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * scale


def _blocks(router, cf, k=2, e=E, seed=0):
    """(reference MoEMLP, the port's, the numpy weights)."""
    jmx.random.seed(seed)
    jb = jmoe.MoEMLP(H, I, e, k, cf, router)
    jb.initialize(jmx.init.Xavier())
    jb(jmx.nd.ones((1, 2, H)))
    w = {n: p.data().asnumpy() for n, p in
         jb._collect_params_with_prefix().items()}
    tb = tmoe.MoEMLP(H, I, e, k, cf, router)
    load_numpy_params(tb, w, ctx=CPU)
    return jb, tb, w


def _run(mx, ag, blk, x, head, aux_w, collect):
    """y, aux and the gradients of x and every parameter, of
    (y·head).sum() + aux_w·aux."""
    xn = mx.nd.array(x, **({"ctx": CPU} if mx is tmx else {}))
    xn.attach_grad()
    with collect() as aux:
        with ag.record():
            y = blk(xn)
            loss = (y * mx.nd.array(
                head, **({"ctx": CPU} if mx is tmx else {}))).sum() \
                + aux_w * aux[0]
        loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in
             blk._collect_params_with_prefix().items()}
    return y.asnumpy(), float(aux[0].asscalar()), xn.grad.asnumpy(), grads


@pytest.mark.parametrize("router,cf", [("topk", 1.25), ("topk", 0.5),
                                       ("expert_choice", 1.0)])
def test_moe_forward_and_gradients_match_the_reference(router, cf):
    """B=2, T=8 (16 tokens), 4 experts, top 2: at cf 1.25 and 0.5 some
    tokens overflow their experts and are dropped in both packages."""
    jb, tb, _ = _blocks(router, cf)
    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, H).astype(np.float32)
    head = rs.randn(2, 8, H).astype(np.float32)
    ref = _run(jmx, jag, jb, x, head, 0.3, jmoe.collect_aux)
    got = _run(tmx, tag, tb, x, head, 0.3, tmoe.collect_aux)
    _close(got[0], ref[0], 1e-5)
    assert abs(got[1] - ref[1]) <= 1e-5 * max(abs(ref[1]), 1.0)
    _close(got[2], ref[2], 1e-4)
    assert got[3].keys() == ref[3].keys() and len(got[3]) == 4
    for name in ref[3]:
        _close(got[3][name], ref[3][name], 1e-4)
    if router == "topk":
        assert np.abs(got[3]["router_weight"]).sum() > 0


def test_capacity_drops_overflow_tokens():
    """cf tiny: capacity 1 an expert, so at most E tokens get an expert
    output (the rest are 0), as in the reference."""
    jb, tb, _ = _blocks("topk", 0.01, k=1, e=2)
    x = np.random.RandomState(4).randn(1, 16, H).astype(np.float32)
    ref = jb(jmx.nd.array(x)).asnumpy()
    got = tb(tmx.nd.array(x, ctx=CPU)).asnumpy()
    _close(got, ref, 1e-5)
    assert tmoe.capacity(16, 1, 0.01, 2) == 1
    assert tmoe.capacity(16, 2, 8.0, 4) == 16  # never more than n
    assert (np.abs(got[0]).sum(-1) > 1e-7).sum() <= 2


def test_identical_experts_equal_the_dense_mlp():
    """Every expert with the same weights and room for every token: the
    renormalised top-2 combine is one dense SwiGLU MLP."""
    _, tb, _ = _blocks("topk", 16.0)
    rs = np.random.RandomState(1)
    gw, uw = (rs.randn(I, H).astype(np.float32) * 0.3 for _ in range(2))
    dw = rs.randn(H, I).astype(np.float32) * 0.3
    for p, m in ((tb.gate_weight, gw), (tb.up_weight, uw),
                 (tb.down_weight, dw)):
        p.set_data(tmx.nd.array(np.tile(m, (E, 1, 1)), ctx=CPU))
    x = rs.randn(2, 5, H).astype(np.float32)
    g = x @ gw.T
    dense = (g / (1 + np.exp(-g)) * (x @ uw.T)) @ dw.T
    np.testing.assert_allclose(tb(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                               dense, rtol=1e-4, atol=1e-5)


def test_aux_loss_is_the_switch_balance_term():
    """aux = E · Σ_e frac_e · mean(probs)_e, frac from each token's first
    choice; expert_choice gives 0."""
    _, tb, w = _blocks("topk", 1.25)
    x = np.random.RandomState(2).randn(2, 8, H).astype(np.float32)
    with tmoe.collect_aux() as aux:
        tb(tmx.nd.array(x, ctx=CPU))
    logits = x.reshape(-1, H) @ w["router_weight"].T
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    frac = np.bincount(probs.argmax(-1), minlength=E) / len(probs)
    want = E * (frac * probs.mean(0)).sum()
    assert len(aux) == 1
    assert abs(float(aux[0].asscalar()) - want) <= 1e-5
    _, ec, _ = _blocks("expert_choice", 1.0)
    with tmoe.collect_aux() as aux:
        ec(tmx.nd.array(x, ctx=CPU))
    assert float(aux[0].asscalar()) == 0.0
    assert tmoe._sink() is None  # the sink ends with its block


@pytest.fixture(scope="module")
def mixtral_weights():
    jmx.random.seed(3)
    net = jllama.mixtral_tiny()
    net.initialize(jmx.init.Xavier())
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _mixtral_pair(w, **kw):
    jnet = jllama.mixtral_tiny(**kw)
    jnet.initialize()
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(w[k]))
    tnet = tllama.mixtral_tiny(**kw)
    load_numpy_params(tnet, w, ctx=CPU)
    return jnet, tnet


IDS = np.random.RandomState(0).randint(0, 256, (2, 16)).astype(np.int32)
LAB = np.random.RandomState(1).randint(0, 256, (2, 16)).astype(np.float32)
# the reference takes its Pallas kernels at T = 128 (a multiple of 128)
IDS128 = np.random.RandomState(2).randint(0, 256, (1, 128)).astype(np.int32)
LAB128 = np.random.RandomState(3).randint(0, 256, (1, 128)).astype(
    np.float32)


def test_mixtral_tiny_names_logits_and_gradients(mixtral_weights,
                                                 pallas_calls):
    w = mixtral_weights
    jnet, tnet = _mixtral_pair(w)
    names = list(tnet._collect_params_with_prefix())
    assert names == list(jnet._collect_params_with_prefix())
    assert "model.layers.1.mlp.router_weight" in names
    assert w["model.layers.0.mlp.gate_weight"].shape == (4, 176, 64)
    assert w["model.layers.0.mlp.down_weight"].shape == (4, 64, 176)

    def loss_of(mx, ag, net):
        kw = {"ctx": CPU} if mx is tmx else {}
        ids = mx.nd.array(IDS128, dtype="int32", **kw)
        lab = mx.nd.array(LAB128, **kw)
        with ag.record():
            logits = net(ids)
            loss = mx.nd.softmax_cross_entropy(
                logits.reshape((-1, 256)), lab.reshape((-1,))) / IDS128.size
        loss.backward()
        return logits.asnumpy(), float(loss.asscalar()), {
            k: p.grad().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}

    ref = loss_of(jmx, jag, jnet)
    assert pallas_calls == {"fwd": 2, "bwd": 2}
    got = loss_of(tmx, tag, tnet)
    _close(got[0], ref[0], 1e-5)
    assert abs(got[1] - ref[1]) <= 1e-5
    assert got[2].keys() == ref[2].keys() and len(got[2]) == 23
    for k in ref[2]:
        _close(got[2][k], ref[2][k], 1e-4)


def test_mixtral_tiny_trainer_steps_with_collect_aux(mixtral_weights):
    """Three SGD-momentum steps of loss + 0.01·Σaux: the losses and every
    updated weight match the reference's."""
    def train(mx, ag, moe, net):
        kw = {"ctx": CPU} if mx is tmx else {}
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
        ids = mx.nd.array(IDS, dtype="int32", **kw)
        lab = mx.nd.array(LAB, **kw)
        losses = []
        for _ in range(3):
            with moe.collect_aux() as aux:
                with ag.record():
                    logits = net(ids)
                    loss = mx.nd.softmax_cross_entropy(
                        logits.reshape((-1, 256)),
                        lab.reshape((-1,))) / IDS.size \
                        + 0.01 * sum(aux)
            assert len(aux) == 2
            loss.backward()
            tr.step(1)
            losses.append(float(loss.asscalar()))
        return losses, {k: p.data().asnumpy() for k, p in
                        net._collect_params_with_prefix().items()}

    jnet, tnet = _mixtral_pair(mixtral_weights, attn_mode="sdpa")
    ref = train(jmx, jag, jmoe, jnet)
    got = train(tmx, tag, tmoe, tnet)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    assert got[0][-1] < got[0][0]
    for k, v in ref[1].items():
        np.testing.assert_allclose(got[1][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_mixtral_tiny_generate_takes_the_oracle_route(mixtral_weights):
    """Greedy tokens equal the reference's, with use_cache on or off (an
    MoE net never builds a KV-cached decoder)."""
    jnet, tnet = _mixtral_pair(mixtral_weights, attn_mode="sdpa")
    ids = IDS[:, :6]
    ref = jnet.generate(jmx.nd.array(ids, dtype="int32"),
                        max_new_tokens=3).asnumpy()
    for use_cache in (True, False):
        got = tnet.generate(tmx.nd.array(ids, ctx=CPU, dtype="int32"),
                            max_new_tokens=3, use_cache=use_cache)
        np.testing.assert_array_equal(got.asnumpy(), ref)
    assert not tnet.__dict__.get("_kv_decoders")


def test_moe_refusals_are_the_reference_s(mixtral_weights):
    _, tnet = _mixtral_pair(mixtral_weights, attn_mode="sdpa")
    with pytest.raises(tmx.MXNetError, match="dense MLP configs"):
        tllama.LlamaDecoder(tnet, max_len=64)
    from mxnet_tpu_torch import serving

    with pytest.raises(tmx.MXNetError, match="dense MLP configs"):
        serving.GenerativeServer(tnet)
    ids = tmx.nd.array(IDS[:, :4], ctx=CPU, dtype="int32")
    with pytest.raises(tmx.MXNetError, match="dense MLP config"):
        tnet.generate(ids, max_new_tokens=2, do_sample=True)
    _, tb, _ = _blocks("topk", 1.25)
    x = tmx.nd.array(np.ones((1, 4, H), np.float32), ctx=CPU)
    tb(x)
    tb.hybridize()
    tb(x)  # no sink: a hybridized call runs
    with tmoe.collect_aux():
        with pytest.raises(tmx.MXNetError, match="hybridize"):
            tb(x)
    with pytest.raises(tmx.MXNetError, match="unknown MoE router"):
        tmoe.MoEMLP(H, I, E, router="sinkhorn")
    with pytest.raises(tmx.MXNetError, match="<= num_experts"):
        tmoe.MoEMLP(H, I, 2, num_experts_per_tok=3)


def test_params_file_is_the_reference_s(mixtral_weights, tmp_path):
    """A Mixtral ``.params`` file is byte for byte the reference's, the
    router and the stacked banks included."""
    jnet, tnet = _mixtral_pair(mixtral_weights, attn_mode="sdpa")
    jnet.save_parameters(str(tmp_path / "j.params"))
    tnet.save_parameters(str(tmp_path / "t.params"))
    assert (tmp_path / "j.params").read_bytes() == \
        (tmp_path / "t.params").read_bytes()
    back = tllama.mixtral_tiny(attn_mode="sdpa")
    back.load_parameters(str(tmp_path / "j.params"), ctx=CPU)
    ids = tmx.nd.array(IDS, ctx=CPU, dtype="int32")
    np.testing.assert_array_equal(back(ids).asnumpy(), tnet(ids).asnumpy())

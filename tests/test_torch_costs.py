"""The cost registry of the PyTorch/CUDA port (``mxnet_tpu_torch.
telemetry.costs``), trap 8 on the CPU: costs without XLA.

The hand-written kernels are invisible to ``torch.utils.flop_counter``
(``ctypes`` launches and custom ops), so each wrapper reports its work by
the formula its bound uses in ``chip_smoke.py``, on its plain route here
as on the card, and the plain route's own ops are not counted again:
the flash forward (4·D flops a visible pair, causal counted as half), the
flash backward (the dQ and dK/dV kernels: 14·D a pair), the fused 1×1
conv (2·M·N·K) and the multi-tensor update (no products; its bytes).
Counting happens at a signature's first sighting only; replays are dict
hits.  ``mfu`` is null on the CPU (no peak) and follows the table keyed
on the card's name (no TPU rows).  A tiny Llama's recorded training step
counts 6·params·tokens plus the attention kernels' flops, within 5%
(params: the matrix products' weights, the embedding table's gather
counting none).  Flop counts are exact integers; the 5% is the
elementwise work the rule leaves out.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, gluon, nd, telemetry
from mxnet_tpu_torch.models import llama
from mxnet_tpu_torch.ops import conv_bn_relu as cbr
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import multi_tensor as mt
from mxnet_tpu_torch import optimizer as opt
from mxnet_tpu_torch.telemetry import costs
from mxnet_tpu_torch.telemetry.sinks import ListSink

CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _clean():
    telemetry.disable()
    telemetry.reset()
    costs.set_peak_flops(None)
    yield
    telemetry.disable()
    telemetry.reset()
    costs.set_peak_flops(None)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(16, 16), (8, 24), (24, 8)])
def test_flash_kernels_report_their_formula(causal, tq, tk):
    b, h, d = 2, 3, 16
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, h, tq, d, generator=g)
    k = torch.randn(b, h, tk, d, generator=g)
    v = torch.randn(b, h, tk, d, generator=g)
    pairs = sum(min(tk, max(0, i + tk - tq + 1)) for i in range(tq)) \
        if causal else tq * tk
    assert fa.visible_pairs(tq, tk, causal) == pairs
    with costs.counting() as c:
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
    assert c.flops == 4 * d * pairs * b * h
    assert c.bytes == 4 * b * h * d * (2 * tq + 2 * tk) + 4 * b * h * tq
    do = torch.randn_like(o)
    with costs.counting() as c:
        fa.flash_attention_bwd(q, k, v, o, do, lse, causal)
    assert c.flops == 14 * d * pairs * b * h
    assert c.bytes == fa._bwd_cost(q, k, causal)[1]


def test_fused_conv_and_update_report_their_formula():
    x, w = torch.randn(32, 16), torch.randn(16, 8)
    scale, bias = torch.ones(8), torch.zeros(8)
    with costs.counting() as c:
        cbr.fused_matmul_affine_relu(x, w, scale, bias)
    assert c.flops == 2 * 32 * 16 * 8
    assert c.bytes == 4 * (32 * 16 + 16 * 8 + 32 * 8) + 8 * 8
    sgd = opt.SGD(learning_rate=0.1, momentum=0.9)
    items = [mt.UpdateItem(torch.ones(100), torch.ones(100),
                           (torch.zeros(100),), None, 0.1, 0.0, 1)]
    with costs.counting() as c:
        mt.multi_tensor_update(sgd, items)
    assert c.flops == 0
    assert c.bytes == 2 * 400 + 2 * 400 + 400  # w, state; the gradient


def test_counter_counts_products_and_views_move_nothing():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with costs.counting() as c:
        a.view(16, 8)
        a.t()
    assert (c.flops, c.bytes) == (0, 0)
    with costs.counting() as c:
        a @ b
    assert c.flops == 2 * 8 * 16 * 4
    assert c.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)


def test_replays_are_hits_and_counted_once():
    telemetry.enable()
    net = gluon.nn.Dense(4, in_units=8)
    net.initialize(ctx=CPU)
    net.hybridize()
    x = nd.ones((2, 8), ctx=CPU)
    net(x)
    s0 = costs.stats()
    for _ in range(3):
        net(x)
    s1 = costs.stats()
    assert s1["analyzed"] == s0["analyzed"] and s1["hits"] == s0["hits"] + 3
    (art,) = [a for a in costs.snapshot() if a["kind"] == "cachedop"]
    assert art["executions"] == 4 and art["flops"] == 2 * 2 * 8 * 4
    assert telemetry.counters()["cost.model_flops"] == 4 * art["flops"]


def test_peak_flops_table_has_the_card_and_no_tpu(monkeypatch):
    assert costs.peak_flops() is None  # the CPU
    monkeypatch.setattr(costs, "device_kind",
                        lambda: "NVIDIA H100 80GB HBM3")
    assert costs.peak_flops() == 989e12
    monkeypatch.setattr(costs, "device_kind", lambda: "TPU v5 lite")
    assert costs.peak_flops() is None
    monkeypatch.setenv("MXNET_PEAK_FLOPS", "1e15")
    assert costs.peak_flops() == 1e15
    costs.set_peak_flops(2e12)
    assert costs.peak_flops() == 2e12


def test_mfu_null_on_the_cpu():
    telemetry.enable()
    sink = ListSink()
    telemetry.add_sink(sink)
    net = gluon.nn.Dense(4, in_units=8)
    net.initialize(ctx=CPU)
    net.hybridize()
    with telemetry.step():
        net(nd.ones((2, 8), ctx=CPU))
    rec = sink.records[-1]
    assert rec["model_flops"] > 0 and rec["mfu"] is None


def test_llama_step_counts_six_params_tokens_plus_attention():
    """One recorded training step of a hybridized tiny Llama (its first
    sighting, then a replayed one) against 6·params·tokens plus the
    attention kernels' formulas, within 5%."""
    telemetry.enable()
    sink = ListSink()
    telemetry.add_sink(sink)
    net = llama.llama_tiny(num_layers=2)
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net.hybridize()
    cfg = net.config
    b, t = 2, 32
    ids = nd.array(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, t)).astype(np.int32), ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(2):
        with telemetry.step():
            with autograd.record():
                loss = loss_fn(net(ids), ids)
            loss.backward()
            trainer.step(b)
    params = net.collect_params()
    matmul = sum(p.data().size for p in params.values()
                 if len(p.shape) == 2)
    if not cfg.tie_embeddings:  # the table's gather has no products
        matmul -= cfg.vocab_size * cfg.hidden_size
    d = cfg.hidden_size // cfg.num_heads
    pairs = fa.visible_pairs(t, t, True)
    attention = (4 + 14) * d * pairs * b * cfg.num_heads * cfg.num_layers
    want = 6 * matmul * b * t + attention
    for rec in sink.records:
        assert rec["model_flops"] == pytest.approx(want, rel=0.05)
    assert sink.records[0]["model_flops"] == sink.records[1]["model_flops"]

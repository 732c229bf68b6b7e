"""``HybridBlock.hybridize`` of the PyTorch/CUDA port on the CPU: the
per-signature cache counts as the JAX package's ``CachedOp`` does (hits,
misses, signatures), a recorded forward runs eagerly and is counted
apart, and the outputs and gradients are those of the block without
``hybridize()``.  (On a card each signature is a captured CUDA graph;
``tests/test_torch_kernels_cuda.py`` holds its replays to eager.)
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx

CPU = tmx.cpu()


def _arrays():
    rng = np.random.RandomState(0)
    return {"0.weight": rng.normal(0, 0.4, (16, 8)),
            "0.bias": rng.normal(0, 0.1, 16),
            "1.gamma": rng.uniform(0.7, 1.3, 16),
            "1.beta": rng.normal(0, 0.1, 16),
            "1.running_mean": rng.normal(0, 0.1, 16),
            "1.running_var": rng.uniform(0.5, 1.5, 16),
            "2.weight": rng.normal(0, 0.3, (4, 16)),
            "2.bias": rng.normal(0, 0.1, 4)}


def _net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"),
            nn.BatchNorm(in_channels=16), nn.Dense(4, in_units=16))
    arrays = _arrays()
    if pkg is jmx:
        net.initialize()
        for name, p in net._collect_params_with_prefix().items():
            p.set_data(jmx.nd.array(arrays[name].astype(np.float32)))
    else:
        net.initialize(ctx=CPU)
        for name, p in net._collect_params_with_prefix().items():
            p.set_data(arrays[name].astype(np.float32))
    return net


def _x(rows, seed=1):
    return np.random.RandomState(seed).normal(size=(rows, 8)).astype(
        np.float32)


SHAPES = [2, 2, 3, 2, 3, 5]


def test_cache_stats_count_as_the_reference_does():
    jnet, tnet = _net(jmx), _net(tmx)
    jnet.hybridize(static_alloc=True, static_shape=True)
    tnet.hybridize(static_alloc=True, static_shape=True)
    assert tnet.cache_stats() == {"hits": 0, "misses": 0, "signatures": 0,
                                  "recorded": 0}
    for rows in SHAPES:
        jout = jnet(jmx.nd.array(_x(rows))).asnumpy()
        tout = tnet(tmx.nd.array(_x(rows), ctx=CPU)).asnumpy()
        np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    want = jnet._cached_op.cache_stats()
    assert want == {"hits": 3, "misses": 3, "signatures": 3}
    assert tnet.cache_stats() == {**want, "recorded": 0}
    # a child called inside its parent's forward is not counted; called
    # on its own it is
    assert tnet[0].cache_stats()["misses"] == 0
    tnet[0](tmx.nd.array(_x(2), ctx=CPU))
    assert tnet[0].cache_stats()["misses"] == 1


def test_outputs_and_gradients_unchanged_by_hybridize():
    plain, hyb = _net(tmx), _net(tmx)
    hyb.hybridize()
    for rows in SHAPES:
        x = tmx.nd.array(_x(rows, seed=rows), ctx=CPU)
        np.testing.assert_array_equal(hyb(x).asnumpy(), plain(x).asnumpy())
    x = tmx.nd.array(_x(4), ctx=CPU)
    grads = []
    for net in (plain, hyb):
        with tmx.autograd.record():
            loss = (net(x) * net(x)).sum()
        loss.backward()
        grads.append([p.grad().asnumpy() for p in
                      net.collect_params().values() if p.grad_req != "null"])
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a, b)
    stats = hyb.cache_stats()
    assert stats["recorded"] == 2 and stats["misses"] == 3  # two calls


def test_hybridize_off_naive_engine_and_remat():
    net = _net(tmx)
    net.hybridize()
    net.hybridize(active=False)
    net(tmx.nd.array(_x(2), ctx=CPU))
    assert net.cache_stats()["misses"] == 0
    net.hybridize()
    tmx.engine.set_engine_type("NaiveEngine")
    try:
        net(tmx.nd.array(_x(2), ctx=CPU))
    finally:
        tmx.engine.set_engine_type("ThreadedEnginePerDevice")
    assert net.cache_stats()["misses"] == 0
    # remat is ported in slice 21 (tests/test_torch_remat.py): True is the
    # "layer" tier; a spelling of no tier raises
    net.hybridize(remat=True)
    x = tmx.nd.array(_x(2), ctx=CPU)
    with tmx.autograd.record():
        y = net(x).sum()
    y.backward()
    assert net._cached_op._remat_tiers and \
        set(net._cached_op._remat_tiers.values()) == {"layer"}
    with pytest.raises(ValueError, match="unknown remat tier"):
        net.hybridize(remat="everything")


def test_deferred_shapes_resolve_on_the_first_hybridized_call():
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(5), tmx.gluon.nn.Dense(2))
    net.initialize(ctx=CPU)
    net.hybridize()
    out = net(tmx.nd.array(_x(3), ctx=CPU))
    assert out.shape == (3, 2)
    assert net.cache_stats()["misses"] == 1
    assert net[0].weight.shape == (5, 8)

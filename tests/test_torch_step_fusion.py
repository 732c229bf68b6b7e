"""``gluon.FusedTrainStep`` of the PyTorch/CUDA port against the JAX
package's: K steps a call, the same losses, weights, optimizer states and
BatchNorm moving statistics from the same numpy weights and batches.

On the CPU the port runs the K steps unrolled through the fused update's
plain version (on a card it replays a captured CUDA graph; that route is
held to eager steps by ``tests/test_torch_kernels_cuda.py``).
Model: ``tests/test_step_fusion.py``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as topt

CPU = tmx.cpu()
K = 3
BATCH = 8


def _arrays(bn, seed=0):
    rng = np.random.RandomState(seed)
    out = {"0.weight": rng.normal(0, 0.4, (16, 8)),
           "0.bias": rng.normal(0, 0.1, 16)}
    last = "1"
    if bn:
        out.update({"1.gamma": rng.uniform(0.7, 1.3, 16),
                    "1.beta": rng.normal(0, 0.1, 16),
                    "1.running_mean": rng.normal(0, 0.1, 16),
                    "1.running_var": rng.uniform(0.5, 1.5, 16)})
        last = "2"
    out.update({f"{last}.weight": rng.normal(0, 0.3, (4, 16)),
                f"{last}.bias": rng.normal(0, 0.1, 4)})
    return {k: v.astype(np.float32) for k, v in out.items()}


def _net(pkg, bn):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"))
    if bn:
        net.add(nn.BatchNorm(in_channels=16))
    net.add(nn.Dense(4, in_units=16))
    if pkg is jmx:
        net.initialize()
        for name, p in net._collect_params_with_prefix().items():
            p.set_data(jmx.nd.array(_arrays(bn)[name]))
    else:
        net.initialize(ctx=CPU)
        for name, p in net._collect_params_with_prefix().items():
            p.set_data(_arrays(bn)[name])
    return net


def _batch(pkg, stacked, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(K, BATCH, 8)).astype(np.float32)
    y = rng.randint(0, 4, (K, BATCH)).astype(np.float32)
    if not stacked:
        x, y = x[0], y[0]
    if pkg is jmx:
        return jmx.nd.array(x), jmx.nd.array(y)
    return tmx.nd.array(x, ctx=CPU), tmx.nd.array(y, ctx=CPU)


def _fused(pkg, opt, kw, bn=False, stacked=True, calls=1):
    """``calls`` FusedTrainStep calls of K steps → (losses, parameters,
    flat optimizer states, update counts)."""
    net = _net(pkg, bn)
    tr = pkg.gluon.Trainer(net.collect_params(), opt, dict(kw))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    fstep = pkg.gluon.FusedTrainStep(
        net, tr, lambda n, x, y: loss_fn(n(x), y), steps_per_execution=K,
        batch_size=BATCH, stacked_inputs=stacked)
    batch = _batch(pkg, stacked)
    losses = np.concatenate([fstep(*batch).asnumpy() for _ in range(calls)])
    params = [p.data().asnumpy() for p in net.collect_params().values()]
    flat = jopt._flatten_state if pkg is jmx else topt._flatten_state
    states = [np.asarray(s.asnumpy() if pkg is jmx else s.numpy(),
                         np.float32)
              for st in tr._states if st is not None for s in flat(st)]
    return losses, params, states, dict(tr._optimizer._index_update_count)


# f32 both sides; the packages' forward and backward sum in other orders
# (the reference test's own 2e-5 / 2e-6 between its fused and eager routes)
@pytest.mark.parametrize("opt,kw,bn,stacked,calls", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, False, True, 2),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, True, False, 1),
    ("adam", {"learning_rate": 1e-3}, True, True, 1),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}, False,
     False, 2)])
def test_fused_train_step_matches_jax(opt, kw, bn, stacked, calls):
    jl, jp, js, jc = _fused(jmx, opt, kw, bn, stacked, calls)
    tl, tp, ts, tc = _fused(tmx, opt, kw, bn, stacked, calls)
    np.testing.assert_allclose(tl, jl, rtol=2e-5, atol=2e-6)
    assert len(tp) == len(jp)
    for i, (a, b) in enumerate(zip(tp, jp)):  # BN's moving stats included
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6,
                                   err_msg=f"param {i}")
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)
    assert tc == jc and set(tc.values()) == {K * calls}


def test_constant_batch_equals_the_stacked_repeat():
    net_kw = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    stacked, _, _, _ = _fused(tmx, *net_kw, stacked=True)
    x, y = _batch(tmx, stacked=True)
    const = []
    for reps in (True, False):
        net = _net(tmx, False)
        tr = tmx.gluon.Trainer(net.collect_params(), *net_kw)
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        fstep = tmx.gluon.FusedTrainStep(
            net, tr, lambda n, a, b: loss_fn(n(a), b),
            steps_per_execution=K, batch_size=BATCH, stacked_inputs=reps)
        if reps:
            args = (tmx.nd.array(np.repeat(x.asnumpy()[:1], K, 0), ctx=CPU),
                    tmx.nd.array(np.repeat(y.asnumpy()[:1], K, 0), ctx=CPU))
        else:
            args = (x[0], y[0])
        const.append(fstep(*args).asnumpy())
    np.testing.assert_array_equal(const[0], const[1])
    assert stacked[0] == const[0][0]


def test_first_call_failure_restores_state():
    """A failure in the first call leaves the parameters, optimizer
    states and update counts as they were; eager steps then train."""
    net = _net(tmx, True)
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    x, y = _batch(tmx, True)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        loss = loss_fn(net(x[0]), y[0])
    loss.backward()
    tr.step(BATCH)  # a momentum state and counts exist
    before = [p.data().asnumpy() for p in net.collect_params().values()]
    moms = [s.numpy().copy() for st in tr._states if st is not None
            for s in topt._flatten_state(st)]
    counts = dict(tr._optimizer._index_update_count)
    seen = []

    def bad_loss(n, a, b):
        seen.append(1)
        out = loss_fn(n(a), b)  # the forward ran: BN stats moved
        if len(seen) == 2:
            raise ValueError("injected failure in the second step")
        return out

    fstep = tmx.gluon.FusedTrainStep(net, tr, bad_loss,
                                     steps_per_execution=K, batch_size=BATCH,
                                     stacked_inputs=True)
    with pytest.raises(ValueError, match="injected"):
        fstep(x, y)
    for a, b in zip(before, [p.data().asnumpy()
                             for p in net.collect_params().values()]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(moms, [s.numpy() for st in tr._states if st is not None
                           for s in topt._flatten_state(st)]):
        np.testing.assert_array_equal(a, b)
    assert dict(tr._optimizer._index_update_count) == counts
    losses = []
    for k in range(K):
        with tmx.autograd.record():
            loss = loss_fn(net(x[k]), y[k])
        loss.backward()
        tr.step(BATCH)
        losses.append(float(loss.mean().asscalar()))
    assert np.isfinite(losses).all()


def test_update_on_kvstore_and_unfusable_optimizers_are_refused():
    net = _net(tmx, False)
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    tr._kv_initialized = True
    tr._update_on_kvstore = True
    with pytest.raises(tmx.MXNetError, match="update_on_kvstore"):
        tmx.gluon.FusedTrainStep(net, tr, lambda n, x, y: n(x),
                                 steps_per_execution=2, batch_size=BATCH)
    with pytest.raises(tmx.MXNetError):
        tmx.gluon.FusedTrainStep(net, tmx.gluon.Trainer(
            net.collect_params(), "sgd"), lambda n, x, y: n(x),
            steps_per_execution=0)

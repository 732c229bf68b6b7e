"""The optimizers of slice 9 (LAMB, RMSProp plain and centered, AdaGrad,
AdaDelta, Ftrl, Signum, SignSGD, LARS, Test) and ``Updater`` against the
JAX package's, and ``FusedTrainStep`` with an optimizer that has no rule
code of the fused kernel.

Weights and three steps' gradients are drawn with numpy from a seed; each
step goes through ``update_multi_precision`` in both packages, and the
weights and every state tensor are compared after each step (f32:
``rtol=1e-5, atol=1e-6``; bf16 weights with f32 masters: the masters at
f32's tolerance and the bf16 weights within one bf16 ulp, 2^-8 of the
value).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as topt

CPU = tmx.cpu()
COMMON = {"wd": 1e-2, "rescale_grad": 0.5, "clip_gradient": 1.5}

OPTS = [
    ("lamb", {"learning_rate": 0.01}),
    ("lamb", {"learning_rate": 0.01, "bias_correction": False,
              "lower_bound": 0.5, "upper_bound": 3.0}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True,
                 "clip_weights": 0.8}),
    ("adagrad", {"learning_rate": 0.1}),
    ("adadelta", {}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.05}),
    ("signum", {"learning_rate": 0.01, "wd_lh": 0.01}),
    ("signsgd", {"learning_rate": 0.01}),
    ("lars", {"learning_rate": 0.1}),
    ("test", {"learning_rate": 0.1}),
]


def _draws(shape, steps, seed):
    rng = np.random.RandomState(seed)
    w = rng.normal(0, 0.5, shape).astype(np.float32)
    gs = [rng.normal(0, 1.0, shape).astype(np.float32) for _ in range(steps)]
    return w, gs


def _flat(pkg, state):
    flat = jopt._flatten_state if pkg is jmx else topt._flatten_state
    return [np.asarray(s.asnumpy() if pkg is jmx else s.float().numpy(),
                       np.float64) for s in flat(state)]


def _steps(pkg, name, kw, w0, grads, dtype=None, mp=False):
    """Each step's (weight, states) through ``update_multi_precision``."""
    opt = (jopt if pkg is jmx else topt).create(
        name, multi_precision=mp, **COMMON, **kw)
    arr = (lambda a, dt=dtype: jmx.nd.array(a, dtype=dt)) if pkg is jmx \
        else (lambda a, dt=dtype: tmx.nd.array(a, ctx=CPU, dtype=dt))
    w = arr(w0)
    state = opt.create_state_multi_precision(0, w)
    out = []
    for g in grads:
        opt.update_multi_precision(0, w, arr(g), state)
        out.append((np.asarray(w.asnumpy(), np.float64), _flat(pkg, state)))
    return out


@pytest.mark.parametrize("name,kw", OPTS,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(OPTS)])
def test_three_steps_match_the_reference(name, kw):
    w0, grads = _draws((6, 5), 3, seed=len(name))
    ref = _steps(jmx, name, kw, w0, grads)
    got = _steps(tmx, name, kw, w0, grads)
    for (gw, gs), (rw, rs) in zip(got, ref):
        np.testing.assert_allclose(gw, rw, rtol=1e-5, atol=1e-6)
        assert len(gs) == len(rs)
        for a, b in zip(gs, rs):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_lamb_bf16_with_f32_masters():
    w0, grads = _draws((4, 8), 3, seed=3)
    ref = _steps(jmx, "lamb", {"learning_rate": 0.01}, w0, grads,
                 "bfloat16", mp=True)
    got = _steps(tmx, "lamb", {"learning_rate": 0.01}, w0, grads,
                 "bfloat16", mp=True)
    for (gw, gs), (rw, rs) in zip(got, ref):
        np.testing.assert_allclose(gw, rw, rtol=2.0 ** -8, atol=1e-6)
        for a, b in zip(gs, rs):  # master, m, v: f32
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_updater_matches_and_round_trips_its_states():
    w0, grads = _draws((5, 3), 3, seed=11)
    outs = []
    for pkg, mod in ((jmx, jopt), (tmx, topt)):
        kw = {} if pkg is jmx else {"ctx": CPU}
        upd = mod.get_updater(mod.create("rmsprop", learning_rate=0.05,
                                         centered=True))
        w = pkg.nd.array(w0, **kw)
        for g in grads:
            upd(2, pkg.nd.array(g, **kw), w)
        outs.append((w.asnumpy(), upd))
    (rw, _), (tw, tupd) = outs
    np.testing.assert_allclose(tw, rw, rtol=1e-5, atol=1e-6)
    blob = tupd.get_states(dump_optimizer=True)
    fresh = topt.get_updater(topt.create("rmsprop", learning_rate=0.05,
                                         centered=True))
    fresh.set_states(blob)
    for a, b in zip(_flat(tmx, fresh.states[2]), _flat(tmx, tupd.states[2])):
        np.testing.assert_array_equal(a, b)
    assert isinstance(tupd, topt.Updater) and tupd.states_synced == {2: True}


def _dense_net(arrays):
    nn = tmx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=6, activation="relu"),
            nn.BatchNorm(in_channels=8), nn.Dense(3, in_units=8))
    net.initialize(ctx=CPU)
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(arrays[k])
    return net


@pytest.mark.parametrize("opt,kw", [
    ("rmsprop", {"learning_rate": 0.01, "gamma1": 0.9, "epsilon": 1.0,
                 "clip_gradient": 2.0}),
    ("lamb", {"learning_rate": 0.01, "wd": 1e-3})])
def test_fused_train_step_takes_an_optimizer_without_a_rule(opt, kw):
    """FusedTrainStep with K=2 and an optimizer the fused kernel has no
    rule code for runs that optimizer's per-tensor rule: its two losses,
    weights and states equal two eager Trainer steps'."""
    rng = np.random.RandomState(5)
    arrays = {"0.weight": rng.normal(0, 0.4, (8, 6)),
              "0.bias": rng.normal(0, 0.1, 8),
              "1.gamma": rng.uniform(0.7, 1.3, 8),
              "1.beta": rng.normal(0, 0.1, 8),
              "1.running_mean": rng.normal(0, 0.1, 8),
              "1.running_var": rng.uniform(0.5, 1.5, 8),
              "2.weight": rng.normal(0, 0.3, (3, 8)),
              "2.bias": rng.normal(0, 0.1, 3)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    x = tmx.nd.array(rng.normal(size=(2, 5, 6)), ctx=CPU, dtype="float32")
    y = tmx.nd.array(rng.randint(0, 3, (2, 5)), ctx=CPU, dtype="float32")
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    results = []
    for fused in (True, False):
        net = _dense_net(arrays)
        tr = tmx.gluon.Trainer(net.collect_params(), opt, dict(kw))
        if fused:
            fstep = tmx.gluon.FusedTrainStep(
                net, tr, lambda n, a, b: loss_fn(n(a), b),
                steps_per_execution=2, batch_size=5, stacked_inputs=True)
            losses = fstep(x, y).asnumpy()
        else:
            losses = []
            for k in range(2):
                with tmx.autograd.record():
                    loss = loss_fn(net(x[k]), y[k])
                loss.backward()
                tr.step(5)
                losses.append(float(loss.sum().asscalar()))
        results.append((np.asarray(losses),
                        [p.data().asnumpy()
                         for p in net.collect_params().values()],
                        [s for st in tr._states if st is not None
                         for s in _flat(tmx, st)],
                        dict(tr._optimizer._index_update_count)))
    (fl, fp, fs, fc), (el, ep, es, ec) = results
    np.testing.assert_allclose(fl, el, rtol=1e-6)
    for a, b in zip(fp, ep):  # BatchNorm's moving statistics included
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert len(fs) == len(es) > 0
    for a, b in zip(fs, es):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert fc == ec and set(fc.values()) == {2}
    assert torch.is_grad_enabled()

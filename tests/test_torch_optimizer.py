"""Optimizers, learning-rate schedulers, the KVStore and the Trainer of
the PyTorch/CUDA port against the JAX package.

The same numpy weights and gradients go through both packages'
optimizers, update by update; everything runs on the CPU.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import optimizer as jopt

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import optimizer as topt

CPU = tmx.cpu()

# rescale, clip and weight decay on, so every branch of the gradient
# preparation runs
_PREP = {"rescale_grad": 0.5, "clip_gradient": 1.5, "wd": 0.01}
CASES = [
    ("sgd", {"learning_rate": 0.1, **_PREP}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, **_PREP}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, **_PREP}),
    ("adam", {"learning_rate": 0.01, **_PREP}),
    ("adamw", {"learning_rate": 0.01, **_PREP}),
]


def _run(pkg, name, hp, w0, grads, dtype, mp=False):
    """Apply ``grads`` one update at a time → (weight, flat states) as
    float32 numpy arrays."""
    opt = (jopt if pkg == "jax" else topt).create(
        name, multi_precision=mp, **hp)
    if pkg == "jax":
        w = jmx.nd.array(w0, dtype=dtype)
        mk = lambda g: jmx.nd.array(g, dtype=dtype)  # noqa: E731
    else:
        w = tmx.nd.array(w0, ctx=CPU, dtype=dtype)
        mk = lambda g: tmx.nd.array(g, ctx=CPU, dtype=dtype)  # noqa: E731
    state = opt.create_state_multi_precision(0, w)
    for g in grads:
        opt.update_multi_precision(0, w, mk(g), state)
    flat = (jopt._flatten_state(state) if pkg == "jax"
            else topt._flatten_state(state))
    to_np = (lambda s: np.asarray(s._data, np.float32)) if pkg == "jax" \
        else (lambda s: s.float().numpy())
    return w.asnumpy().astype(np.float32), [to_np(s) for s in flat]


def _inputs(seed, shape=(6, 9), steps=3):
    rng = np.random.RandomState(seed)
    w0 = rng.normal(size=shape).astype(np.float32)
    grads = [2.0 * rng.normal(size=shape).astype(np.float32)
             for _ in range(steps)]
    return w0, grads


# f32 weights: the same rule in both packages, rounding where the products
# are taken in another order (2e-6).  bf16 weights: the prepared gradient
# (and NAG's momentum) is bf16 in the reference's rule, and XLA may keep
# such a chain in f32 (excess precision) where torch rounds each op to
# bf16, so the two differ by about one bf16 ulp (2^-8 = 0.4%) of what that
# rounding feeds: weights within two ulps of the largest weight, states
# within 1% of the largest state.
@pytest.mark.filterwarnings("ignore:reduced-precision")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,hp", CASES)
def test_update_rules_match_reference(name, hp, dtype):
    w0, grads = _inputs(0)
    jw, js = _run("jax", name, hp, w0, grads, dtype)
    tw, ts = _run("torch", name, hp, w0, grads, dtype)
    tol = 2e-6 if dtype == "float32" else 2 * 2.0 ** -8 * np.abs(jw).max()
    assert np.abs(tw - jw).max() <= tol
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        assert a.shape == b.shape
        tol = 2e-6 if dtype == "float32" else 1e-2 * np.abs(b).max()
        assert np.abs(a - b).max() <= tol
    assert np.abs(tw - w0).max() > 1e-3  # the weights did move


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_bf16_states_are_f32_and_weights_keep_their_tensor(name):
    w = tmx.nd.array(np.ones((4, 4), "f"), ctx=CPU, dtype="bfloat16")
    w._data = torch.nn.Parameter(w._data)
    before = w._data
    opt = topt.create(name, momentum=0.9) if name == "sgd" else \
        topt.create(name, learning_rate=0.1)
    with pytest.warns(UserWarning, match="multi_precision"):
        state = opt.create_state_multi_precision(0, w)
    assert all(t.dtype == torch.float32 for t in topt._flatten_state(state))
    opt.update_multi_precision(0, w, tmx.nd.array(
        np.ones((4, 4), "f"), ctx=CPU, dtype="bfloat16"), state)
    assert w._data is before and w.dtype == torch.bfloat16
    assert float(w._data.detach().float().max()) < 1.0


def test_multi_precision_keeps_an_f32_master():
    w0, grads = _inputs(1)
    hp = {"learning_rate": 0.1, "momentum": 0.9}
    jw, js = _run("jax", "sgd", hp, w0, grads, "bfloat16", mp=True)
    tw, ts = _run("torch", "sgd", hp, w0, grads, "bfloat16", mp=True)
    assert len(ts) == len(js) == 2  # master, momentum
    for a, b in zip(ts, js):
        assert np.abs(a - b).max() <= 1e-5
    assert np.abs(tw - jw).max() <= 2 * 2.0 ** -8 * np.abs(jw).max()


def test_lr_mult_wd_mult_and_update_counts():
    p = tmx.gluon.Parameter("w", shape=(3,), lr_mult=0.5, wd_mult=0.0)
    opt = topt.create("sgd", learning_rate=0.2, wd=0.1,
                      param_dict={0: p})
    assert opt._get_lr(0) == pytest.approx(0.1)
    assert opt._get_wd(0) == 0.0
    for _ in range(3):
        opt._update_count(0)
    opt._update_count(1)
    assert opt.num_update == 3 and opt._index_update_count == {0: 3, 1: 1}
    with pytest.raises(tmx.MXNetError, match="ROADMAP"):
        topt.create("rmsprop")


@pytest.mark.parametrize("make", [
    lambda m: m.FactorScheduler(step=3, factor=0.5, base_lr=1.0,
                                warmup_steps=2, warmup_begin_lr=0.1),
    lambda m: m.MultiFactorScheduler(step=[2, 5, 7], factor=0.3,
                                     base_lr=0.8),
    lambda m: m.PolyScheduler(max_update=12, base_lr=0.5, pwr=2,
                              final_lr=0.01, warmup_steps=3,
                              warmup_mode="constant", warmup_begin_lr=0.2),
    lambda m: m.CosineScheduler(max_update=10, base_lr=0.4, final_lr=0.02,
                                warmup_steps=2),
])
def test_lr_schedulers_match_reference(make):
    ref, got = make(jlrs), make(tlrs)
    for n in range(15):
        assert got(n) == pytest.approx(ref(n), rel=1e-12, abs=0.0)


def test_scheduler_drives_the_optimizer_lr():
    sched = tlrs.FactorScheduler(step=1, factor=0.5, base_lr=1.0)
    opt = topt.create("sgd", learning_rate=0.8, lr_scheduler=sched)
    w = tmx.nd.array(np.zeros(2, "f"), ctx=CPU)
    g = tmx.nd.array(np.ones(2, "f"), ctx=CPU)
    lrs = []
    for _ in range(3):
        opt.update(0, w, g, None)
        lrs.append(opt.learning_rate)
    assert lrs == [0.8, 0.4, 0.2]
    np.testing.assert_allclose(w.asnumpy(), [-1.4, -1.4], rtol=1e-6)
    with pytest.raises(tmx.MXNetError, match="LRScheduler"):
        opt.set_learning_rate(0.1)


def test_kvstore_push_pull_leaves_the_gradient_uncopied():
    kv = tmx.kv.create("device")
    g = tmx.nd.array(np.arange(4, dtype="f"), ctx=CPU)
    raw = g._data
    kv.init(3, g)
    kv.push(3, g)
    kv.pull(3, g)
    assert g._data is raw
    kv.pushpull(3, [g, g], out=g)  # a list is summed, as across devices
    np.testing.assert_array_equal(g.asnumpy(), 2 * np.arange(4))
    assert (kv.rank, kv.num_workers) == (0, 1)
    with pytest.raises(tmx.MXNetError, match="not initialized"):
        kv.push(9, g)
    for name in ("dist_sync", "dist_device_sync", "dist_async",
                 "dist_tpu_sync", "horovod"):
        with pytest.raises(tmx.MXNetError, match="ROADMAP"):
            tmx.kv.create(name)


def test_trainer_step_rescales_by_batch_size_and_matches_reference():
    """A Dense layer, two backward + ``step(4)``: rescale_grad = 1/4, the
    same updates as the JAX Trainer's (f32, 1e-5)."""
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu_torch import autograd as tag

    rng = np.random.RandomState(5)
    w = rng.normal(size=(3, 5)).astype("f")
    x = rng.normal(size=(4, 5)).astype("f")
    out = []
    for mx, ag, gl, kw in ((jmx, jag, jgluon, {}),
                           (tmx, tag, tmx.gluon, {"ctx": CPU})):
        net = gl.nn.Dense(3, in_units=5, use_bias=False)
        net.initialize(**kw)
        net.weight.set_data(mx.nd.array(w, **kw))
        tr = gl.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.5, "momentum": 0.9})
        for _ in range(2):
            with ag.record():
                h = net(mx.nd.array(x, **kw))
                y = (h * h).sum()
            y.backward()
            tr.step(4)
        assert tr.learning_rate == 0.5
        assert tr.optimizer.rescale_grad == 0.25
        out.append(net.weight.data().asnumpy())
    assert np.abs(out[1] - out[0]).max() <= 1e-5
    assert np.abs(out[1] - w).max() > 0.1

"""The Trainer's fused multi-tensor update of the PyTorch/CUDA port against
the JAX package's Trainer (whose fused route traces every rule into one
XLA program).

The same numpy weights and data go through a small net (Dense, BatchNorm,
Dense) in both packages for four steps; on the CPU the port's fused route
runs the kernel's plain version (the per-tensor rule) in one call a step.
Model: ``tests/test_fused_update.py``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import lr_scheduler as jlrs

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch.ops import multi_tensor

CPU = tmx.cpu()
STEPS = 4


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {"0.weight": rng.normal(0, 0.4, (16, 8)),
            "0.bias": rng.normal(0, 0.1, 16),
            "1.gamma": rng.uniform(0.7, 1.3, 16),
            "1.beta": rng.normal(0, 0.1, 16),
            "1.running_mean": rng.normal(0, 0.1, 16),
            "1.running_var": rng.uniform(0.5, 1.5, 16),
            "2.weight": rng.normal(0, 0.3, (4, 16)),
            "2.bias": rng.normal(0, 0.1, 4)}


def _net(pkg, arrays, dtype):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"),
            nn.BatchNorm(in_channels=16), nn.Dense(4, in_units=16))
    if pkg is jmx:
        net.initialize()
        for name, p in net._collect_params_with_prefix().items():
            p.set_data(jmx.nd.array(arrays[name].astype(np.float32)))
    else:
        net.initialize(ctx=CPU)
        for name, p in net._collect_params_with_prefix().items():
            p.set_data(arrays[name].astype(np.float32))
    if dtype != "float32":
        net.cast(dtype)
    return net


def _train(pkg, opt, kw, dtype="float32", schedule=False, seed=0):
    """STEPS steps → (parameters as f64 numpy, the losses)."""
    arrays = _arrays(seed)
    net = _net(pkg, arrays, dtype)
    kw = dict(kw)
    if schedule:
        lrs = jlrs if pkg is jmx else tlrs
        kw["lr_scheduler"] = lrs.FactorScheduler(step=1, factor=0.5,
                                                 base_lr=kw["learning_rate"])
    trainer = pkg.gluon.Trainer(net.collect_params(), opt, kw)
    rng = np.random.RandomState(seed + 1)
    x = rng.uniform(-1, 1, (8, 8)).astype(np.float32)
    y = (np.arange(8) % 4).astype(np.float32)
    ag = jautograd if pkg is jmx else tautograd
    if pkg is jmx:
        xs, ys = jmx.nd.array(x).astype(dtype), jmx.nd.array(y)
    else:
        xs = tmx.nd.array(x, ctx=CPU).astype(dtype)
        ys = tmx.nd.array(y, ctx=CPU)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(STEPS):
        with ag.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        trainer.step(8)
        losses.append(float(loss.mean().asscalar()))
    return [p.data().asnumpy().astype(np.float64)
            for p in net.collect_params().values()], losses


_PREP = {"clip_gradient": 0.5, "rescale_grad": 2.0}
CASES = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4, **_PREP}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, **_PREP}),
    ("adam", {"learning_rate": 1e-2, **_PREP}),
    ("adamw", {"learning_rate": 1e-2, "wd": 1e-2, **_PREP}),
]


# f32: the same rules on the same numbers; the forward and backward sum in
# other orders in the two packages (1e-5 of a value, 1e-6 absolute, the
# reference test's own tolerance between its fused and eager routes).
# Adam and AdamW normalize the step: where a gradient is near 0 (one of
# the first layer's reads 2.8e-6, 1e-6 of the largest, and the packages'
# summation orders differ in it by 0.4%), the step is set by epsilon and
# that noise moves the weight by up to 1e-3 of lr (8.5e-6 at lr = 1e-2)
@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("opt,kw", CASES)
def test_fused_update_matches_jax_trainer(opt, kw, schedule):
    jp, jl = _train(jmx, opt, kw, schedule=schedule)
    tp, tl = _train(tmx, opt, kw, schedule=schedule)
    atol = 1e-3 * kw["learning_rate"] if opt.startswith("adam") else 1e-6
    assert len(jp) == len(tp)
    for i, (a, b) in enumerate(zip(tp, jp)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol,
                                   err_msg=f"param {i}")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


# bf16 weights with f32 masters: the reference test's bf16 storage
# tolerance (1e-2 of a value, 1e-3 absolute).  (Not Adam: its normalized
# step turns the bf16 forward's gradient noise near 0 into steps of +-lr.)
@pytest.mark.filterwarnings("ignore:reduced-precision")
@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, **_PREP})])
def test_fused_multi_precision_bf16_matches_jax(opt, kw):
    kw = {**kw, "multi_precision": True}
    jp, _ = _train(jmx, opt, kw, dtype="bfloat16")
    tp, _ = _train(tmx, opt, kw, dtype="bfloat16")
    for i, (a, b) in enumerate(zip(tp, jp)):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-3,
                                   err_msg=f"param {i}")


def test_fused_route_is_one_call_a_step_and_naive_engine_is_not(
        monkeypatch):
    """Every live tensor goes through one ``multi_tensor_update`` call a
    step; under NaiveEngine the Trainer updates tensor by tensor instead,
    to the same numbers."""
    calls = []
    real = multi_tensor.multi_tensor_update

    def counting(optimizer, items):
        calls.append(len(list(items)))
        return real(optimizer, items)

    monkeypatch.setattr(multi_tensor, "multi_tensor_update", counting)
    kw = {"learning_rate": 0.1, "momentum": 0.9}
    fused, _ = _train(tmx, "sgd", kw)
    assert calls == [6] * STEPS  # 6 live tensors; the moving stats are not
    calls.clear()
    tmx.engine.set_engine_type("NaiveEngine")
    try:
        naive, _ = _train(tmx, "sgd", kw)
    finally:
        tmx.engine.set_engine_type("ThreadedEnginePerDevice")
    assert calls == []
    for a, b in zip(fused, naive):
        np.testing.assert_array_equal(a, b)


def test_engine_surface():
    eng = tmx.engine
    assert eng.engine_type() in ("ThreadedEnginePerDevice", "ThreadedEngine",
                                 "NaiveEngine")
    with pytest.raises(tmx.MXNetError):
        eng.set_engine_type("Bogus")
    with eng.bulk(8):
        assert eng.bulk_size() == 8
    assert eng.flush() == 0
    tmx.nd.waitall()


def test_an_optimizer_that_overrides_the_rule_takes_the_eager_route(
        monkeypatch):
    """A subclass of SGD with its own ``_step``: the kernel would run SGD's
    rule, so the Trainer updates tensor by tensor with the override."""
    calls = []
    real = multi_tensor.multi_tensor_update
    monkeypatch.setattr(multi_tensor, "multi_tensor_update",
                        lambda o, items: calls.append(1) or real(o, items))

    class HalfSGD(tmx.optimizer.SGD):
        def _step(self, w, g, states, lr, wd, t):
            super()._step(w, g, states, 0.5 * lr, wd, t)

    kw = {"learning_rate": 0.1, "momentum": 0.9}
    half, _ = _train(tmx, HalfSGD(**kw), {})
    assert calls == []
    assert tmx.optimizer.SGD(**kw)._kernel_rule()[0] == "sgd_mom"
    full, _ = _train(tmx, "sgd", {**kw, "learning_rate": 0.05})
    for a, b in zip(half, full):
        np.testing.assert_array_equal(a, b)


def test_update_plan_checks_each_set_of_operands_once(monkeypatch):
    """The kernel's table: the operands are checked and laid out once for
    each set of addresses; a later step writes only lr, wd and t, and new
    operands are checked again (a bad one raises)."""
    import torch

    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.base import MXNetError

    checks = []
    check = multi_tensor.UpdatePlan._check
    monkeypatch.setattr(multi_tensor.UpdatePlan, "_check",
                        lambda self, *a: checks.append(a) or
                        check(self, *a))
    opt = topt.create("sgd", momentum=0.9)
    w, g, mom = torch.zeros(5), torch.ones(5), torch.zeros(5)
    item = multi_tensor.UpdateItem(w, g, (mom,), None, 0.1, 0.0, 1)
    plan = multi_tensor.UpdatePlan([5], "cpu")
    first = plan.rows([item], opt)
    later = plan.rows([item._replace(lr=0.25, wd=0.5, t=7)], opt)
    assert len(checks) == 1
    np.testing.assert_array_equal(later[:, :7], first[:, :7])
    assert later[0, 5] == 5 and later[0, 9] == 7
    assert later[0, 7:9].view(np.float64).tolist() == [0.25, 0.5]
    g2 = torch.ones(5)
    moved = plan.rows([item._replace(g=g2)], opt)
    assert len(checks) == 2 and moved[0, 1] == g2.data_ptr()
    with pytest.raises(MXNetError):
        plan.rows([item._replace(g=torch.ones(5, dtype=torch.float64))],
                  opt)

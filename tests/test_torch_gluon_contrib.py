"""``gluon.contrib`` (the layers and the Estimator) and higher-order
gradients of the PyTorch/CUDA port against the JAX package, on the CPU.

The layers run on the same numpy weights and inputs in both packages
(outputs within 1e-6).  ``Estimator.fit`` trains the same ``bert_tiny``
classifier (2 layers, units 128, T = 16, dropout 0) in both packages
from the same numpy weights, 3 batches of 4 through ``DataLoader`` with
Adam (lr 1e-3): the per-batch losses, the per-batch training accuracy
and every final weight within 1e-4, as ``test_torch_bert.py``'s Adam
steps are held (the key projection's bias within 3 lr: its gradient is
rounding noise in both packages, which Adam turns into steps of ±lr).
The handlers (checkpoint, logging, stopping, early stopping and the
fault-tolerant checkpoint's resume) run in the same fit.  The reference's
three higher-order cases (``tests/test_contrib_gluon.py``) hold
``autograd.grad(create_graph=True)`` within 1e-5; through the flash
kernels and the norms it raises (trap 7).
"""
import os
import re

import numpy as onp
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_numpy_params

CPU = tmx.cpu()
TOL = 1e-4
LR = 1e-3
V, T, B = 60, 16, 4


def _kw(pkg):
    return {"ctx": CPU} if pkg is tmx else {}


def _same_weights(jnet, tnet, x):
    jnet.initialize(jmx.init.Xavier())
    jnet(x)
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    load_numpy_params(tnet, arrays, ctx=CPU)
    return arrays


# --- layers ----------------------------------------------------------------

def _concurrent(pkg):
    nn, cnn = pkg.gluon.nn, pkg.gluon.contrib.nn
    net = cnn.HybridConcurrent(axis=1, prefix="conc_")
    net.add(nn.Dense(3, in_units=4), nn.Dense(2, in_units=4),
            cnn.Identity())
    return net


@pytest.mark.parametrize("hybridize", [False, True])
def test_hybrid_concurrent_matches_the_reference(hybridize):
    x = onp.random.RandomState(0).randn(2, 4).astype(onp.float32)
    jnet, tnet = _concurrent(jmx), _concurrent(tmx)
    _same_weights(jnet, tnet, jmx.nd.array(x))
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    for _ in range(2):
        got = tnet(tmx.nd.array(x, ctx=CPU)).asnumpy()
        assert got.shape == (2, 3 + 2 + 4)
        onp.testing.assert_allclose(got, jnet(jmx.nd.array(x)).asnumpy(),
                                    rtol=1e-6, atol=1e-6)
    assert tmx.gluon.contrib.nn.Concurrent.__mro__[1] is \
        tmx.gluon.contrib.nn.HybridConcurrent


def test_identity_and_sync_batchnorm_alias():
    x = tmx.nd.array(onp.arange(6.0).reshape(2, 3), ctx=CPU)
    onp.testing.assert_array_equal(
        tmx.gluon.contrib.nn.Identity()(x).asnumpy(), x.asnumpy())
    assert tmx.gluon.contrib.nn.SyncBatchNorm is tmx.gluon.nn.SyncBatchNorm


SHUFFLES = {"1d": (1, 3, (2, 6, 5)), "2d": (2, 2, (1, 8, 2, 3)),
            "2d_pair": (2, (2, 3), (2, 12, 2, 2)),
            "3d": (3, 2, (1, 16, 2, 3, 2))}


@pytest.mark.parametrize("case", sorted(SHUFFLES))
def test_pixel_shuffle_matches_the_reference(case):
    dim, factor, shape = SHUFFLES[case]
    x = onp.arange(onp.prod(shape), dtype=onp.float32).reshape(shape)
    outs = [getattr(pkg.gluon.contrib.nn, f"PixelShuffle{dim}D")(factor)(
        pkg.nd.array(x, **_kw(pkg))).asnumpy() for pkg in (jmx, tmx)]
    onp.testing.assert_array_equal(outs[1], outs[0])


def test_pixel_shuffle_channel_major_ordering():
    x = tmx.nd.array(onp.arange(8, dtype=onp.float32).reshape(1, 4, 2),
                     ctx=CPU)
    out = tmx.gluon.contrib.nn.PixelShuffle1D(2)(x).asnumpy()[0]
    onp.testing.assert_array_equal(out, [[0, 2, 1, 3], [4, 6, 5, 7]])
    with pytest.raises(tmx.MXNetError):
        tmx.gluon.contrib.nn.PixelShuffle2D((2, 2, 2))


def test_sparse_embedding_updates_the_touched_rows_only():
    ids = onp.array([[1, 3], [3, 4]], onp.int32)
    jemb = jmx.gluon.contrib.nn.SparseEmbedding(6, 3, prefix="emb_")
    temb = tmx.gluon.contrib.nn.SparseEmbedding(6, 3, prefix="emb_")
    _same_weights(jemb, temb, jmx.nd.array(ids, dtype="int32"))
    assert temb.weight._grad_stype == "row_sparse"
    before = temb.weight.data().asnumpy()
    outs = []
    for pkg, net in ((jmx, jemb), (tmx, temb)):
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5})
        x = pkg.nd.array(ids, dtype="int32", **_kw(pkg))
        with pkg.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(1)
        outs.append(net.weight.data().asnumpy())
    onp.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-7)
    untouched = [0, 2, 5]
    onp.testing.assert_array_equal(outs[1][untouched], before[untouched])
    assert not onp.allclose(outs[1][[1, 3, 4]], before[[1, 3, 4]])


# --- the Estimator -----------------------------------------------------------

def _cls(pkg):
    from importlib import import_module

    bert = import_module(pkg.__name__ + ".models.bert")
    return bert.BERTClassifier(
        bert.bert_tiny(vocab_size=V, dropout=0.0, prefix="berttiny_"),
        num_classes=3, prefix="bertcls_")


class _LossLog:
    """The loss, with each batch's mean loss kept."""

    def __init__(self, pkg):
        self.fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        self.values = []

    def __call__(self, out, label):
        loss = self.fn(out, label)
        self.values.append(float(loss.mean().asscalar()))
        return loss


def _metric_log(pkg):
    est = pkg.gluon.contrib.estimator

    class MetricLog(est.BatchEnd):
        def __init__(self):
            self.values = []

        def batch_end(self, estimator, *args, **kwargs):
            self.values.append(estimator.train_metrics[0].get()[1])

    return MetricLog()


def _fit(pkg, net, ids, labels, tmp, capsys):
    est = pkg.gluon.contrib.estimator
    data = pkg.gluon.data
    loader = data.DataLoader(data.ArrayDataset(ids, labels), batch_size=B)
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": LR})
    loss = _LossLog(pkg)
    e = est.Estimator(net, loss, train_metrics=[pkg.metric.Accuracy()],
                      trainer=trainer)
    metric_log = _metric_log(pkg)
    handlers = [est.CheckpointHandler(tmp, model_prefix="cls"),
                est.LoggingHandler(), metric_log,
                est.StoppingHandler(max_epoch=1)]
    capsys.readouterr()
    e.fit(loader, val_data=loader, epochs=1, event_handlers=handlers)
    log = capsys.readouterr().out
    weights = {k: p.data().asnumpy()
               for k, p in net._collect_params_with_prefix().items()}
    return e, loss.values, metric_log.values, weights, log, loader


def test_estimator_fit_on_bert_tiny_matches_the_reference(tmp_path,
                                                           capsys):
    rng = onp.random.RandomState(4)
    ids = rng.randint(0, V, (3 * B, T)).astype(onp.int32)
    labels = rng.randint(0, 3, (3 * B,)).astype(onp.float32)
    jnet, tnet = _cls(jmx), _cls(tmx)
    jmx.random.seed(0)
    _same_weights(jnet, tnet, jmx.nd.array(ids[:1], dtype="int32"))
    with CPU:  # the port's arrays default to the card
        got = _fit(tmx, tnet, ids, labels, str(tmp_path / "t"), capsys)
    ref = _fit(jmx, jnet, ids, labels, str(tmp_path / "j"), capsys)
    onp.testing.assert_allclose(got[1], ref[1], atol=TOL, rtol=0)
    assert len(got[1]) == 3 and got[1][-1] < got[1][0]
    assert got[2] == pytest.approx(ref[2], abs=1e-9)
    assert set(got[3]) == set(ref[3])
    for k in ref[3]:
        tol = 3 * LR if k.endswith("proj_key.bias") else TOL
        onp.testing.assert_allclose(got[3][k], ref[3][k], atol=tol, rtol=0,
                                    err_msg=k)
    # the log lines have the reference's form
    digits = re.compile(r"[0-9.]+")
    assert [digits.sub("#", ln) for ln in got[4].splitlines()] == \
        [digits.sub("#", ln) for ln in ref[4].splitlines()]
    # evaluate equals a hand-written loop over the same batches
    e = got[0]
    acc = tmx.metric.Accuracy()
    for x, y in got[5]:
        with tmx.autograd.predict_mode():
            acc.update(y, tnet(x))
    assert e.evaluate(got[5]) == {"accuracy": acc.get()[1]}
    stats = tnet.cache_stats()
    assert stats["recorded"] == 3 and stats["signatures"] == 1
    # the checkpoint is a .params file the reference reads
    path = str(tmp_path / "t" / "cls-0001.params")
    jnet.load_parameters(path)
    for k, p in jnet._collect_params_with_prefix().items():
        onp.testing.assert_array_equal(p.data().asnumpy(), got[3][k])


def _dense(pkg, units=2):
    net = pkg.gluon.nn.Dense(units, in_units=4)
    net.initialize(**_kw(pkg))
    return net


def _loader(pkg, n=8):
    data = pkg.gluon.data
    x = onp.zeros((n, 4), onp.float32)
    y = onp.zeros((n,), onp.float32)
    return data.DataLoader(data.ArrayDataset(x, y), batch_size=4)


def test_early_stopping_and_stopping_handlers():
    stops = []
    for pkg in (jmx, tmx):
        est = pkg.gluon.contrib.estimator
        with CPU:
            acc = pkg.metric.Accuracy()
            e = est.Estimator(_dense(pkg), pkg.gluon.loss.
                              SoftmaxCrossEntropyLoss(), train_metrics=[acc])
            stop = est.EarlyStoppingHandler(acc, patience=0, mode="max")
            e.fit(_loader(pkg), epochs=50, event_handlers=[stop])
            batches = est.StoppingHandler(max_batch=3)
            e.fit(_loader(pkg, 16), epochs=5, event_handlers=[batches])
        stops.append((stop.stop_training, stop.wait, batches.current_batch,
                      batches.current_epoch))
    assert stops[1] == stops[0] == (True, 1, 3, 1)


def test_fault_tolerant_checkpoint_resumes(tmp_path):
    est = tmx.gluon.contrib.estimator
    d = str(tmp_path / "ft")
    with CPU:
        net = _dense(tmx)
        e = est.Estimator(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss())
        e.fit(_loader(tmx), epochs=1,
              event_handlers=[est.FaultTolerantCheckpoint(d)])
        w1 = net.weight.data().asnumpy()
        net2 = _dense(tmx)
        e2 = est.Estimator(net2, tmx.gluon.loss.SoftmaxCrossEntropyLoss())
        ftc = est.FaultTolerantCheckpoint(d)
        e2.fit(_loader(tmx), epochs=1, event_handlers=[ftc])
    assert ftc.resumed_epoch == 1 and ftc.stop_training
    onp.testing.assert_array_equal(net2.weight.data().asnumpy(), w1)
    assert sorted(os.listdir(d)) == ["ckpt-1"]


# --- higher-order gradients (tests/test_contrib_gluon.py) -----------------

def test_higher_order_grad_polynomial():
    x = tmx.nd.array([1.0, 2.0, 3.0], ctx=CPU)
    x.attach_grad()
    with tmx.autograd.record():
        y = x * x * x
        gx, = tmx.autograd.grad(y, [x], create_graph=True)
        z = gx.sum()
    z.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), 6 * x.asnumpy(),
                                rtol=1e-5)


def test_higher_order_grad_trig():
    x = tmx.nd.array([0.3, 0.7], ctx=CPU)
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.sin(x)
        g1, = tmx.autograd.grad(y, [x], create_graph=True)
        s = (g1 * g1).sum()
    s.backward()
    xa = x.asnumpy()
    onp.testing.assert_allclose(x.grad.asnumpy(),
                                -2 * onp.cos(xa) * onp.sin(xa), rtol=1e-5)


def test_higher_order_through_network_matches_the_reference():
    """Gradient-penalty double backward through Dense layers, the same
    weights in both packages."""
    x = onp.random.RandomState(1).uniform(-1, 1, (4, 4)).astype(onp.float32)
    grads = []
    for pkg in (jmx, tmx):
        net = pkg.gluon.nn.HybridSequential(prefix="gp_")
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(8, in_units=4, activation="tanh"),
                    pkg.gluon.nn.Dense(1, in_units=8))
        grads.append(net)
    jnet, tnet = grads
    _same_weights(jnet, tnet, jmx.nd.array(x))
    out = []
    for pkg, net in ((jmx, jnet), (tmx, tnet)):
        a = pkg.nd.array(x, **_kw(pkg))
        a.attach_grad()
        with pkg.autograd.record():
            o = net(a).sum()
            gx, = pkg.autograd.grad(o, [a], create_graph=True)
            penalty = (gx * gx).sum()
        penalty.backward()
        out.append([p.grad().asnumpy() for p in
                    net.collect_params().values()])
    assert float(onp.abs(out[1][0]).sum()) > 0
    for g, r in zip(out[1], out[0]):
        onp.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)


def test_grad_without_create_graph_unchanged():
    x = tmx.nd.array([2.0], ctx=CPU)
    x.attach_grad()
    with tmx.autograd.record():
        y = x * x
    gx, = tmx.autograd.grad(y, [x])
    assert float(gx.asscalar()) == 4.0
    assert gx._data.grad_fn is None


def _flash(x):
    from mxnet_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(x, x * 0.5, x * 2.0).sum()


def _layer_norm(x):
    g = tmx.nd.ones((x.shape[-1],), ctx=CPU)
    return tmx.nd.LayerNorm(x, g, g * 0).sum()


@pytest.mark.parametrize("op", ["flash_attention", "layer_norm"])
def test_create_graph_through_a_first_order_backward_raises(op):
    """Trap 7: never a wrong second derivative."""
    x = tmx.nd.array(onp.random.RandomState(2).randn(1, 2, 8, 16)
                     .astype(onp.float32), ctx=CPU)
    x.attach_grad()
    fn = _flash if op == "flash_attention" else _layer_norm
    with tmx.autograd.record():
        y = fn(x)
        with pytest.raises(tmx.MXNetError, match="first-order"):
            tmx.autograd.grad(y, [x], create_graph=True)
    with tmx.autograd.record():
        y = fn(x)
    g, = tmx.autograd.grad(y, [x])  # first order is fine
    assert onp.isfinite(g.asnumpy()).all()

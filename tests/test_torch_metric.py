"""``metric``, ``callback`` and ``gluon.utils`` of the PyTorch/CUDA port
against the JAX package's: the same numpy labels and predictions (drawn
from a seed) through each metric of both, the callbacks' logs and files,
and the utilities' results.  Metric values: ``rtol=1e-6`` (both sum in
f32 on the device or f64 on the host in the same order up to
reassociation).
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()


def _nd(pkg, a):
    return pkg.nd.array(a, ctx=CPU) if pkg is tmx else pkg.nd.array(a)


def _data(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "class":
        pred = rng.uniform(size=(16, 6)).astype(np.float32)
        pred /= pred.sum(-1, keepdims=True)
        return rng.randint(0, 6, 16).astype(np.float32), pred
    if kind == "binary":
        return (rng.randint(0, 2, 20).astype(np.float32),
                rng.uniform(size=(20, 2)).astype(np.float32))
    if kind == "loss":
        return None, rng.uniform(size=(8,)).astype(np.float32)
    return (rng.normal(size=(10, 3)).astype(np.float32),
            rng.normal(size=(10, 3)).astype(np.float32))


def _feval(label, pred):
    return float(np.abs(label - pred).sum()), label.size


METRICS = [
    ("accuracy", lambda m: m.Accuracy(), "class"),
    ("top_k", lambda m: m.TopKAccuracy(top_k=3), "class"),
    ("f1", lambda m: m.F1(), "binary"),
    ("mcc", lambda m: m.MCC(), "binary"),
    ("perplexity", lambda m: m.Perplexity(ignore_label=2), "class"),
    ("mae", lambda m: m.MAE(), "reg"),
    ("mse", lambda m: m.MSE(), "reg"),
    ("rmse", lambda m: m.RMSE(), "reg"),
    ("cross_entropy", lambda m: m.CrossEntropy(), "class"),
    ("pearson", lambda m: m.PearsonCorrelation(), "reg"),
    ("loss", lambda m: m.Loss(), "loss"),
    ("torch", lambda m: m.Torch(), "loss"),
    ("caffe", lambda m: m.Caffe(), "loss"),
    ("custom", lambda m: m.CustomMetric(_feval, name="l1"), "reg"),
    ("np", lambda m: m.np(_feval), "reg"),
    ("composite", lambda m: m.CompositeEvalMetric(["acc", "ce"]), "class"),
    ("create_list", lambda m: m.create(["acc", "ce"]), "class"),
    ("create_callable", lambda m: m.create(_feval), "reg"),
]


@pytest.mark.parametrize("name,make,kind", METRICS,
                         ids=[m[0] for m in METRICS])
def test_metric_matches_reference(name, make, kind):
    vals = []
    for pkg in (jmx, tmx):
        metric = make(pkg.metric)
        assert isinstance(metric, pkg.metric.EvalMetric)
        for step in range(2):  # two updates, then get; numpy inputs too
            label, pred = _data(kind, 10 * step + len(name))
            labels = [] if label is None else [_nd(pkg, label)]
            metric.update(labels, [_nd(pkg, pred)])
        label, pred = _data(kind, 99)
        metric.update([] if label is None else [label], [pred])
        vals.append(metric.get())
        metric.reset()
        after = metric.get()[1]
        assert all(np.isnan(v) for v in np.atleast_1d(after))
    (rn, rv), (tn, tv) = vals
    assert rn == tn
    np.testing.assert_allclose(np.atleast_1d(tv), np.atleast_1d(rv),
                               rtol=1e-6)


def test_metric_registry_and_config():
    assert sorted(jmx.metric.__all__) == sorted(tmx.metric.__all__)
    for spec in ("acc", "ce", "mae", "rmse", "f1", "perplexity"):
        assert type(tmx.metric.create(spec)).__name__ == \
            type(jmx.metric.create(spec)).__name__
    acc = tmx.metric.Accuracy(axis=1)
    assert acc.get_config() == jmx.metric.Accuracy(axis=1).get_config()
    acc.update_dict({"y": tmx.nd.array([1.0], ctx=CPU)},
                    {"p": tmx.nd.array([[0.2, 0.8]], ctx=CPU)})
    assert acc.get() == ("accuracy", 1.0)
    with pytest.raises(tmx.MXNetError):
        tmx.metric.create("no_such_metric")
    with pytest.raises(tmx.MXNetError, match="top_k=1"):
        tmx.metric.create("top_k_accuracy")


def _logged(pkg, caplog):
    caplog.clear()
    metric = pkg.metric.Accuracy()
    label, pred = _data("class", 4)
    metric.update([_nd(pkg, label)], [_nd(pkg, pred)])
    speed = pkg.callback.Speedometer(batch_size=16, frequent=2)
    param = pkg.callback.BatchEndParam
    with caplog.at_level(logging.INFO):
        for nbatch in range(5):
            speed(param(0, nbatch, metric))
        metric.update([_nd(pkg, label)], [_nd(pkg, pred)])
        pkg.callback.log_train_metric(1)(param(1, 3, metric))
        pkg.callback.LogValidationMetricsCallback()(param(2, 0, metric))
    return [r.getMessage().split("Speed:")[0] +
            r.getMessage().split("samples/sec")[-1] for r in caplog.records]


def test_callbacks_log_as_the_reference(caplog, tmp_path, capsys):
    assert _logged(tmx, caplog) == _logged(jmx, caplog)
    assert any("accuracy" in m for m in _logged(tmx, caplog))
    bar = tmx.callback.ProgressBar(total=4, length=8)
    bar(tmx.callback.BatchEndParam(0, 2, None))
    assert "[====----] 50%" in capsys.readouterr().out
    arg = {"w": tmx.nd.array(np.arange(6.0).reshape(2, 3), ctx=CPU)}
    aux = {"m": tmx.nd.array([1.5, 2.5], ctx=CPU)}
    cb = tmx.callback.do_checkpoint(str(tmp_path / "net"), period=2)
    cb(0, None, arg, aux)
    assert not (tmp_path / "net-0001.params").exists()
    cb(1, None, arg, aux)
    loaded = jmx.nd.load(str(tmp_path / "net-0002.params"))
    np.testing.assert_array_equal(loaded["arg:w"].asnumpy(),
                                  arg["w"].asnumpy())
    np.testing.assert_array_equal(loaded["aux:m"].asnumpy(),
                                  aux["m"].asnumpy())


def test_gluon_utils_match_the_reference(tmp_path):
    from mxnet_tpu.gluon import utils as jutils
    from mxnet_tpu_torch.gluon import utils as tutils

    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    parts = tutils.split_and_load(x, [CPU, CPU, CPU], even_split=False)
    ref = jutils.split_data(jmx.nd.array(x), 3, even_split=False)
    assert [p.shape for p in parts] == [r.shape for r in ref]
    for p, r in zip(parts, ref):
        np.testing.assert_array_equal(p.asnumpy(), r.asnumpy())
    with pytest.raises(tmx.MXNetError, match="divisible"):
        tutils.split_data(tmx.nd.array(x, ctx=CPU), 3)
    rng = np.random.RandomState(3)
    arrays = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    tarr = [tmx.nd.array(a, ctx=CPU) for a in arrays]
    jarr = [jmx.nd.array(a) for a in arrays]
    tn = tutils.clip_global_norm(tarr, 1.0)
    jn = jutils.clip_global_norm(jarr, 1.0)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    for a, b in zip(tarr, jarr):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6)
    f = tmp_path / "blob"
    f.write_bytes(b"mxnet")
    import hashlib

    digest = hashlib.sha1(b"mxnet").hexdigest()
    assert tutils.check_sha1(str(f), digest) == \
        jutils.check_sha1(str(f), digest) is True
    assert tutils.shape_is_known((2, 3)) and not tutils.shape_is_known(
        (2, 0)) and not tutils.shape_is_known(None)
    hooks = {}
    with tutils.HookHandle() as h:
        h.attach(hooks, print)
        assert len(hooks) == 1
    assert hooks == {}
    with pytest.raises(tmx.MXNetError, match="network"):
        tutils.download("http://example.invalid/x")

"""The sparse linear classification loop of
``examples/sparse_linear_classification.py`` through the port against
the JAX package: the ``test_sparse_linear_classification_example_smoke``
case of ``tests/test_sparse.py`` (its own file: the reference's eager
loop takes about 20 s).  The example imports the JAX package, so the
loop is written here against either package; the losses step for step
within rtol 1e-4 (45 SGD steps at lr 5.0 from the same zeros)."""
import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _linear_classification(mx, n, d, steps, batch, lr, density=0.02):
    """``examples/sparse_linear_classification.py``'s loop, written
    against either package (the example imports the JAX package): CSR
    features, the dense weight's gradient through the CSR ``dot``."""
    rs = np.random.RandomState(0)
    x = rs.randn(n, d).astype(np.float32)
    x[rs.rand(n, d) > density] = 0.0
    w_true = rs.randn(d).astype(np.float32)
    y = (x @ w_true > 0).astype(np.float32)
    x_csr = mx.nd.tanh(mx.nd.array(x).tostype("csr") * 1.0)
    assert x_csr.stype == "csr"
    xn = x_csr.asnumpy()
    w = mx.nd.zeros((d, 1))
    w.attach_grad()
    b = mx.nd.zeros((1,))
    b.attach_grad()
    opt = mx.optimizer.SGD(learning_rate=lr)
    states = {0: opt.create_state(0, w), 1: opt.create_state(1, b)}
    rs = np.random.RandomState(1)
    losses = []
    for _ in range(steps):
        idx = rs.randint(0, n, batch)
        xb = mx.nd.array(xn[idx]).tostype("csr")
        yb = mx.nd.array(y[idx].reshape(-1, 1))
        with mx.autograd.record():
            logits = mx.nd.dot(xb, w) + b
            ls = mx.nd.log_softmax(
                mx.nd.concat(mx.nd.zeros_like(logits), logits, dim=1))
            nll = -(yb * ls[:, 1:2] + (1 - yb) * ls[:, 0:1])
            nll = nll.mean()
        nll.backward()
        for i, p in ((0, w), (1, b)):
            opt.update(i, p, p.grad, states[i])
        losses.append(float(nll.asscalar()))
    pred = (mx.nd.dot(x_csr, w) + b).asnumpy().ravel() > 0
    return np.array(losses), float((pred == (y > 0.5)).mean())


def _both(fn):
    ref = fn(jmx)
    with tmx.cpu():
        got = fn(tmx)
    return got, ref


def test_sparse_linear_classification_example_smoke():
    """The example's loop at the reference test's tiny config (N=1500,
    D=256, 45 steps, batch 128, lr 5.0): the losses step for step and
    the full-set accuracy against the reference's."""
    (losses, acc), (rlosses, racc) = _both(
        lambda mx: _linear_classification(mx, 1500, 256, 45, 128, 5.0))
    np.testing.assert_allclose(losses, rlosses, rtol=1e-4)
    assert losses[-1] < losses[0] * 0.8
    assert abs(acc - racc) < 0.01 and acc > 0.6

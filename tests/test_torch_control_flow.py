"""``nd.contrib.foreach``, ``while_loop`` and ``cond`` of the
PyTorch/CUDA port against the JAX package, eager and under autograd, and
the port's graph-capture route (``cuda_graph.scope()``: what a
hybridized forward runs, masked steps and both branches) against its
eager route.

The same seeded numpy inputs go through both packages; outputs, final
loop vars and gradients are held at ``rtol=atol=1e-6`` (f32, the same
elementwise ops in the same order), the capture route against the eager
route exactly.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cuda_graph

CPU = tmx.cpu()
TOL = dict(rtol=1e-6, atol=1e-6)


def _nd(pkg, a):
    return pkg.nd.array(a, ctx=CPU) if pkg is tmx else pkg.nd.array(a)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [y for o in out for y in _flat(o)]
    return [out.asnumpy()]


def _compare(run):
    """``run(pkg)`` → list of numpy arrays, in both packages."""
    ref, got = run(jmx), run(tmx)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, np.asarray(r, np.float32), **TOL)
    return got


X = np.random.RandomState(0).randn(5, 3).astype(np.float32)
S0 = np.random.RandomState(1).randn(3).astype(np.float32)


def _foreach(pkg, record):
    x, s = _nd(pkg, X), _nd(pkg, S0)
    for a in (x, s):
        a.attach_grad()

    def body(xi, states):
        h = states[0] * 0.5 + xi
        return [h * 2, h.sum()], [h]

    with pkg.autograd.record(record):
        outs, final = pkg.nd.contrib.foreach(body, x, [s])
        loss = outs[0].sum() + (outs[1] * 3).sum() + final[0].sum()
    res = _flat(outs) + _flat(final)
    if record:
        loss.backward()
        res += [x.grad.asnumpy(), s.grad.asnumpy()]
    return res


@pytest.mark.parametrize("record", [False, True])
def test_foreach(record):
    got = _compare(lambda pkg: _foreach(pkg, record))
    assert got[0].shape == (5, 3) and got[1].shape == (5,)


def _while(pkg, limit, max_iterations, record, capture=False):
    i0 = _nd(pkg, np.array([0.0], np.float32))
    v0 = _nd(pkg, S0)
    v0.attach_grad()

    def cond(i, v):
        return i < limit

    def func(i, v):
        nv = v * 1.5 + i
        return [nv * nv], [i + 1, nv]

    with pkg.autograd.record(record):
        if capture:
            with cuda_graph.scope():
                outs, (i, v) = pkg.nd.contrib.while_loop(
                    cond, func, [i0, v0], max_iterations=max_iterations)
        else:
            outs, (i, v) = pkg.nd.contrib.while_loop(
                cond, func, [i0, v0], max_iterations=max_iterations)
        loss = outs.sum() + v.sum()
    res = _flat(outs) + [i.asnumpy(), v.asnumpy()]
    if record:
        loss.backward()
        res.append(v0.grad.asnumpy())
    return res


WHILE_CASES = {"zero_iterations": (0, 4), "fewer_than_max": (2, 4),
               "exactly_max": (4, 4), "cut_at_max": (9, 3)}


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("case", sorted(WHILE_CASES))
def test_while_loop(case, record):
    limit, m = WHILE_CASES[case]
    got = _compare(lambda pkg: _while(pkg, limit, m, record))
    steps = min(limit, m)
    assert got[0].shape == (m, 3)
    assert (got[0][steps:] == 0).all() and float(got[1][0]) == steps


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("case", sorted(WHILE_CASES))
def test_while_loop_capture_route_equals_eager(case, record):
    limit, m = WHILE_CASES[case]
    eager = _while(tmx, limit, m, record)
    masked = _while(tmx, limit, m, record, capture=True)
    for e, c in zip(eager, masked):
        np.testing.assert_array_equal(c, e)


def _cond(pkg, flag, record, capture=False):
    p = _nd(pkg, np.array([flag], np.float32))
    a = _nd(pkg, S0)
    a.attach_grad()
    with pkg.autograd.record(record):
        def run():
            return pkg.nd.contrib.cond(p, lambda: [a * 2, a.sum()],
                                       lambda: [a * a, a.max()])
        if capture:
            with cuda_graph.scope():
                out = run()
        else:
            out = run()
        loss = out[0].sum() + out[1] * 3
    res = _flat(out)
    if record:
        loss.backward()
        res.append(a.grad.asnumpy())
    return res


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("flag", [0.0, 1.0])
def test_cond(flag, record):
    _compare(lambda pkg: _cond(pkg, flag, record))
    eager = _cond(tmx, flag, record)
    for e, c in zip(eager, _cond(tmx, flag, record, capture=True)):
        np.testing.assert_array_equal(c, e)


def test_while_loop_requires_max_iterations():
    with pytest.raises(tmx.MXNetError, match="max_iterations"):
        tmx.nd.contrib.while_loop(lambda v: v, lambda v: ([v], [v]),
                                  [_nd(tmx, S0)])


def test_control_flow_inside_a_hybridized_block():
    """A hybridized block whose forward runs ``cond`` and ``while_loop``
    gives its eager outputs (on the CPU the block runs inline under the
    capture scope, as a card's warm-up does)."""
    class Net(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            y = F.contrib.cond(x.sum() > 0, lambda: x * 2, lambda: -x)
            outs, v = F.contrib.while_loop(
                lambda v: v.sum() < 20, lambda v: ([v], [v + 1]), [y],
                max_iterations=6)
            return outs, v[0]

    net = Net()
    x = _nd(tmx, S0)
    eager = _flat(net(x))
    net.hybridize()
    hybrid = _flat(net(x))
    for e, h in zip(eager, hybrid):
        np.testing.assert_array_equal(h, e)

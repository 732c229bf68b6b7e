"""``mx.np`` and ``mx.npx`` of the PyTorch/CUDA port against the JAX
package, on the CPU.

Every name of the port's np table (``mxnet_tpu_torch.numpy.FUNCTIONS``)
runs once through ``chip_smoke.np_cases`` (loaded by path; the card runs
the same calls at (4096, 4096) in phase 26b) at n = 8, with the same
numpy inputs in both packages, grouped by family.  The reference runs
with x64 on (``tests/conftest.py``), so it is compared at the port's
dtype: every output within 1e-5 of the largest |value| (f32 against
float64-accumulated results), integers and bools exactly (the same
bound, whose scale is ≥ 1).  Where the reference cannot run a call
(``trapz`` is absent from it; its wrapper turns ``resize``'s shape tuple
into an unhashable list), numpy is the reference.  ``partition`` and
``argpartition`` leave every position but the kth unspecified: both are
held at the kth position and by the sorted rows.  Then the reference's
own cases (``tests/test_numpy.py``), output types, npx, save/load, and
numpy's semantics where torch's differ (trap 1), each against the
reference or numpy.
"""
import importlib.util
from pathlib import Path

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
TOL = 1e-5
N = 8
tnp, jnp_ = tmx.np, jmx.np


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
CASES = CS.np_cases(N)
FAMILIES = sorted({c[1] for c in CASES})
NUMPY_REF = {"trapz": lambda y, axis=-1: onp.trapezoid(y, axis=axis),
             "resize": onp.resize}


def _conv(pkg, a):
    kw = {"ctx": CPU} if pkg is tmx else {}
    if isinstance(a, onp.ndarray):
        return pkg.np.array(a, **kw)
    if isinstance(a, (list, tuple)) and a and \
            isinstance(a[0], onp.ndarray):
        return type(a)(_conv(pkg, x) for x in a)
    return a


def _run(pkg, name, args, kw):
    return CS.np_outputs(getattr(pkg.np, name)(
        *[_conv(pkg, a) for a in args], **kw))


@pytest.mark.parametrize("family", FAMILIES)
def test_every_name_of_the_table_matches_the_reference(family):
    for name, fam, args, kw in CASES:
        if fam != family:
            continue
        got = _run(tmx, name, args, kw)
        if name in NUMPY_REF:
            want = CS.np_outputs(NUMPY_REF[name](*args, **kw))
        else:
            want = _run(jmx, name, args, kw)
        assert len(got) == len(want), name
        if name in ("partition", "argpartition"):
            x = args[0]
            kth = args[1]
            vals = [onp.take_along_axis(x, o, -1) if name == "argpartition"
                    else o for o in (got[0], want[0])]
            onp.testing.assert_array_equal(vals[0][:, kth], vals[1][:, kth])
            onp.testing.assert_array_equal(onp.sort(vals[0], -1),
                                           onp.sort(vals[1], -1))
            continue
        for g, w in zip(got, want):
            assert CS.np_rel_err(g, w) <= TOL, (name, g, w)


def test_the_table_covers_the_reference_and_the_cases_cover_the_table():
    ref = {n for n in dir(jnp_) if not n.startswith("_") and
           callable(getattr(jnp_, n)) and
           getattr(getattr(jnp_, n), "__module__", "") ==
           "mxnet_tpu.numpy" and n != "ndarray"}
    port = set(tnp.FUNCTIONS) | set(dir(tnp))
    assert ref - port == set()
    assert {c[0] for c in CASES} == set(tnp.FUNCTIONS)
    assert len(tnp.FUNCTIONS) >= 180


# --- the reference's own cases (tests/test_numpy.py) ----------------------

def test_array_creation_and_types():
    with CPU:
        a = tnp.array([[1.0, 2], [3, 4]])
        assert type(a).__name__ == "ndarray"
        assert isinstance(a, tmx.nd.NDArray)
        assert a.dtype == torch.float32 == tnp.float32
        assert tnp.array([1, 2]).dtype == torch.int64
        z = tnp.zeros((2, 3))
        assert z.shape == (2, 3) and z.dtype == torch.float32
        assert tnp.ones((2,), dtype="float64").dtype == torch.float64
        assert tnp.arange(5).shape == (5,)
        assert tnp.arange(5).dtype == torch.int64
        assert tnp.arange(0.0, 1.0, 0.25).dtype == torch.float32
        assert tnp.linspace(0, 1, 11).shape == (11,)
        assert tnp.eye(3).shape == (3, 3)
    onp.testing.assert_allclose(
        tnp.linspace(0, 1, 11, ctx=CPU).asnumpy(),
        jnp_.linspace(0, 1, 11).asnumpy(), rtol=1e-6)
    onp.testing.assert_allclose(
        tnp.logspace(0, 2, 5, ctx=CPU).asnumpy(),
        jnp_.logspace(0, 2, 5).asnumpy(), rtol=1e-6)
    onp.testing.assert_allclose(
        tnp.geomspace(1, 8, 4, ctx=CPU).asnumpy(),
        jnp_.geomspace(1, 8, 4).asnumpy(), rtol=1e-6)
    onp.testing.assert_array_equal(tnp.tri(3, 4, 1, ctx=CPU).asnumpy(),
                                   jnp_.tri(3, 4, 1).asnumpy())


def test_default_dtypes_and_set_np_default_dtype():
    with CPU:
        assert tnp.array([1.5]).dtype == torch.float32
        assert tnp.array([True]).dtype == torch.bool
        assert (tnp.array([1, 2]) + 1.5).dtype == torch.float32
        assert tnp.add(tnp.array([1, 2], dtype="int32"),
                       tnp.array([1, 2])).dtype == torch.int64
        prev = tmx.util.set_np_default_dtype(True)
        try:
            assert tnp.array([1.5]).dtype == torch.float64
            assert tnp.zeros((2,)).dtype == torch.float64
            assert tnp.linspace(0, 1, 3).dtype == torch.float64
        finally:
            tmx.util.set_np_default_dtype(prev)
        assert tnp.zeros((2,)).dtype == torch.float32


def test_zero_dim_and_zero_size():
    with CPU:
        z = tnp.zeros(())
        assert z.shape == ()
        assert float(z.item()) == 0.0
        e = tnp.zeros((0, 3))
        assert e.shape == (0, 3) and e.size == 0
        s = tnp.sum(tnp.ones((2, 2)))
        assert s.shape == ()
        assert tnp.sum(e, axis=0).shape == (3,)
        assert tnp.concatenate([e, tnp.ones((1, 3))]).shape == (1, 3)
        assert tnp.mean(tnp.ones(())).item() == 1.0


EXPRS = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "pow": lambda a, b: a ** 2, "neg": lambda a, b: -a,
    "abs": lambda a, b: abs(a), "radd": lambda a, b: 2 * a,
    "gt": lambda a, b: a > b, "eq": lambda a, b: a == b,
    "getitem": lambda a, b: a[0], "matmul": lambda a, b: a @ b,
    "method_sum": lambda a, b: a.sum(), "np_sum": lambda a, b: 0,
}


@pytest.mark.parametrize("expr", sorted(EXPRS))
def test_output_types_match_the_reference(expr):
    x = onp.array([[1.0, 2.0], [3.0, 4.0]], onp.float32)
    types = []
    for pkg in (jmx, tmx):
        kw = {"ctx": CPU} if pkg is tmx else {}
        a, b = pkg.np.array(x, **kw), pkg.np.array(x + 1, **kw)
        out = pkg.np.sum(a) if expr == "np_sum" else EXPRS[expr](a, b)
        types.append(type(out).__name__)
        want = EXPRS[expr](x, x + 1) if expr != "np_sum" else x.sum()
        onp.testing.assert_allclose(out.asnumpy(), want, rtol=1e-6)
    assert types[0] == types[1]


def test_hybridized_block_output_types_match_the_reference():
    """Trap 2: a block's eager outputs keep the np type its forward
    makes; hybridized, the reference's compiled graph returns the
    classic ``NDArray`` (also under ``record()``), and so does the port's
    ``CachedOp`` on every route."""
    got = {}
    for pkg in (jmx, tmx):
        class Net(pkg.gluon.HybridBlock):
            def hybrid_forward(self, F, x):
                return x * 2, x + 1

        kw = {"ctx": CPU} if pkg is tmx else {}
        net = Net()
        x = pkg.np.array(onp.ones((2, 2), onp.float32), **kw)
        types = [[type(o).__name__ for o in net(x)]]
        net.hybridize()
        types += [[type(o).__name__ for o in net(x)] for _ in range(2)]
        with pkg.autograd.record():
            types.append([type(o).__name__ for o in net(x)])
        got[pkg] = types
    assert got[tmx] == got[jmx]
    assert got[tmx][0] == ["ndarray"] * 2
    assert got[tmx][1:] == [["NDArray"] * 2] * 3


def test_elemwise_and_reductions_match_numpy():
    rng = onp.random.RandomState(0)
    x = rng.uniform(0.5, 2.0, (3, 4)).astype(onp.float32)
    a = tnp.array(x, ctx=CPU)
    for name in ["exp", "log", "sqrt", "sin", "cos", "tanh", "square",
                 "sign", "floor", "ceil"]:
        onp.testing.assert_allclose(getattr(tnp, name)(a).asnumpy(),
                                    getattr(onp, name)(x), rtol=1e-5,
                                    atol=1e-6)
    onp.testing.assert_allclose(tnp.sum(a, axis=1).asnumpy(), x.sum(axis=1),
                                rtol=1e-5)
    onp.testing.assert_allclose(tnp.mean(a).item(), x.mean(), rtol=1e-5)
    assert tnp.argmax(a).item() == x.argmax()
    onp.testing.assert_allclose(tnp.cumsum(a, axis=0).asnumpy(),
                                x.cumsum(axis=0), rtol=1e-5)


def test_shape_manipulation():
    with CPU:
        a = tnp.reshape(tnp.arange(12), (3, 4))
        assert a.shape == (3, 4)
        assert tnp.transpose(a).shape == (4, 3)
        assert tnp.expand_dims(a, 0).shape == (1, 3, 4)
        assert tnp.squeeze(tnp.expand_dims(a, 0)).shape == (3, 4)
        b = tnp.concatenate([a, a], axis=0)
        assert b.shape == (6, 4)
        s = tnp.split(b, 2, axis=0)
        assert len(s) == 2 and s[0].shape == (3, 4)
        assert tnp.stack([a, a]).shape == (2, 3, 4)
        assert tnp.tile(a, (2, 1)).shape == (6, 4)
        assert tnp.broadcast_to(tnp.ones((1, 4)), (3, 4)).shape == (3, 4)
        assert tnp.where(a > 5, a, tnp.zeros_like(a)).shape == (3, 4)
        with pytest.raises(tmx.MXNetError):
            tnp.squeeze(a, axis=0)


def test_matmul_dot_einsum():
    a = onp.arange(6).reshape(2, 3).astype(onp.float32)
    b = onp.arange(12).reshape(3, 4).astype(onp.float32)
    ta, tb = tnp.array(a, ctx=CPU), tnp.array(b, ctx=CPU)
    for got in (tnp.matmul(ta, tb), tnp.dot(ta, tb),
                tnp.einsum("ij,jk->ik", ta, tb)):
        onp.testing.assert_allclose(got.asnumpy(), a @ b, rtol=1e-5)
    t3 = onp.arange(24).reshape(2, 3, 4).astype(onp.float32)
    w3 = onp.arange(20).reshape(4, 5).astype(onp.float32)
    onp.testing.assert_allclose(
        tnp.dot(tnp.array(t3, ctx=CPU), tnp.array(w3, ctx=CPU)).asnumpy(),
        onp.dot(t3, w3))
    onp.testing.assert_allclose(tnp.dot(ta, 2.0).asnumpy(), a * 2)


def test_autograd_through_np():
    x = tnp.array([1.0, 2.0], ctx=CPU)
    x.attach_grad()
    with tmx.autograd.record():
        y = tnp.sum(x * x * 3)
    y.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), 6 * x.asnumpy())
    # a gradient through a function of the table and a reduction
    v = onp.array([[0.3, -1.2, 2.0], [1.5, 0.1, -0.4]], onp.float32)
    grads = []
    for pkg, ag in ((jmx, jmx.autograd), (tmx, tmx.autograd)):
        kw = {"ctx": CPU} if pkg is tmx else {}
        z = pkg.np.array(v, **kw)
        z.attach_grad()
        with ag.record():
            out = pkg.np.sum(pkg.np.tanh(z) * pkg.np.median(z, axis=1,
                                                            keepdims=True))
        out.backward()
        grads.append(z.grad.asnumpy())
    onp.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-6)


def test_npx_ops_and_np_mode():
    with CPU:
        a = tnp.array([-1.0, 2.0])
        onp.testing.assert_allclose(tmx.npx.relu(a).asnumpy(), [0, 2])
        assert type(tmx.npx.relu(a)).__name__ == "ndarray"
        sm = tmx.npx.softmax(tnp.array([[1.0, 1.0]]))
        onp.testing.assert_allclose(sm.asnumpy(), [[0.5, 0.5]], rtol=1e-6)
    tmx.npx.set_np()
    try:
        assert tmx.util.is_np_array() and tmx.util.is_np_shape()
        arr = tmx.util.default_array([1.0], ctx=CPU)
        assert type(arr).__name__ == "ndarray"
    finally:
        tmx.npx.reset_np()
    assert not tmx.util.is_np_array()
    assert type(tmx.util.default_array([1.0], ctx=CPU)) is tmx.nd.NDArray
    assert sorted(n for n in dir(jmx.npx) if not n.startswith("_")) == \
        sorted(n for n in dir(tmx.npx) if not n.startswith("_"))


def test_npx_save_load_keeps_the_nd_save_bytes(tmp_path):
    w = onp.array([1.0, 2.0], onp.float32)
    tf, jf = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tmx.npx.save(tf, {"w": tnp.array(w, ctx=CPU)})
    jmx.npx.save(jf, {"w": jnp_.array(w)})
    assert open(tf, "rb").read() == open(jf, "rb").read()
    back = tmx.npx.load(jf)
    assert type(back["w"]).__name__ == "ndarray"
    onp.testing.assert_allclose(back["w"].asnumpy(), [1, 2])
    assert type(tmx.npx.load(tf)["w"]).__name__ == "ndarray"


def test_conversion_nd_np():
    a = tnp.array([1.0, 2.0], ctx=CPU)
    nd_a = a.as_nd_ndarray()
    assert type(nd_a) is tmx.nd.NDArray
    back = tnp._np(nd_a)
    assert type(back).__name__ == "ndarray"
    assert type(nd_a) is tmx.nd.NDArray
    assert nd_a._data is a._data
    assert repr(tnp.array([1.0, 2.0], ctx=CPU)) == \
        repr(jnp_.array([1.0, 2.0]))


def test_np_interops_with_gluon():
    net = tmx.gluon.nn.Dense(3, in_units=2)
    net.initialize(ctx=CPU)
    out = net(tnp.ones((2, 2), ctx=CPU))
    assert out.shape == (2, 3)


# --- trap 1: numpy's semantics where torch's differ -----------------------

def _both(name, *args, **kw):
    got = getattr(tnp, name)(*[tnp.array(a, ctx=CPU)
                               if isinstance(a, onp.ndarray) else a
                               for a in args], **kw)
    want = getattr(jnp_, name)(*[jnp_.array(a)
                                 if isinstance(a, onp.ndarray) else a
                                 for a in args], **kw)
    return CS.np_outputs(got), CS.np_outputs(want)


TRAPS = {
    # torch.median returns the lower middle value
    "median_even": ("median", (onp.array([4.0, 1, 3, 2], onp.float32),),
                    {}, [2.5]),
    "percentile_linear": ("percentile", (onp.arange(5, dtype=onp.float32),
                                         onp.array([10.0, 55.0])), {},
                          [0.4, 2.2]),
    "quantile_nan": ("quantile", (onp.array([1.0, onp.nan, 3],
                                            onp.float32), 0.5), {},
                     [onp.nan]),
    # the divisor's sign (torch.fmod takes the dividend's)
    "mod_sign": ("mod", (onp.array([-7, 7, -7, 7]),
                         onp.array([3, -3, -3, 3])), {}, [2, -2, -1, 1]),
    "remainder_float": ("remainder", (onp.array([-5.5, 5.5], onp.float32),
                                      2.0), {}, [0.5, 1.5]),
    "floor_divide": ("floor_divide", (onp.array([-7, 7]), 2), {},
                     [-4, 3]),
    "nonzero_tuple": ("nonzero", (onp.array([[0, 1], [1, 0]]),), {},
                      [0, 1, 1, 0]),
    "unique_sorted": ("unique", (onp.array([3, 1, 2, 1, 3]),), {},
                      [1, 2, 3]),
    "argsort_stable": ("argsort", (onp.array([2, 1, 2, 1, 2]),), {},
                       [1, 3, 0, 2, 4]),
    "round_half_even": ("round", (onp.array([0.5, 1.5, 2.5, -0.5, -2.5],
                                            onp.float32),), {},
                        [0, 2, 2, 0, -2]),
    "round_decimals": ("round", (onp.array([1.25, 1.35], onp.float32),),
                       {"decimals": 1}, [1.2, 1.4]),
    "std_ddof": ("std", (onp.array([1.0, 2, 3, 4], onp.float32),),
                 {"ddof": 1}, [onp.std([1.0, 2, 3, 4], ddof=1)]),
    "var_ddof": ("var", (onp.array([1.0, 2, 3, 4], onp.float32),),
                 {"ddof": 2}, [onp.var([1.0, 2, 3, 4], ddof=2)]),
    "argmax_nan_first": ("argmax", (onp.array([1.0, onp.nan, 5, onp.nan],
                                              onp.float32),), {}, [1]),
    "argmin_nan_first": ("argmin", (onp.array([1.0, 0, onp.nan],
                                              onp.float32),), {}, [2]),
    "histogram_last_edge": ("histogram", (onp.array([0.0, 1, 2, 3, 3],
                                                    onp.float32),),
                            {"bins": 3}, [1, 1, 3, 0, 1, 2, 3]),
    "histogram_range": ("histogram", (onp.array([-1.0, 0, 0.5, 1, 2],
                                                onp.float32),),
                        {"bins": 2, "range": (0, 1)}, [1, 2, 0, 0.5, 1]),
    "interp_edges": ("interp", (onp.array([-1.0, 0, 1.5, 3, 4],
                                          onp.float32),
                                onp.array([0.0, 1, 2, 3], onp.float32),
                                onp.array([0.0, 10, 20, 30], onp.float32)),
                     {}, [0, 0, 15, 30, 30]),
    "interp_left_right": ("interp", (onp.array([-1.0, 4], onp.float32),
                                     onp.array([0.0, 3], onp.float32),
                                     onp.array([0.0, 30], onp.float32)),
                          {"left": -5.0, "right": 99.0}, [-5, 99]),
    "digitize": ("digitize", (onp.array([0.0, 1, 2.5, 10], onp.float32),
                              onp.array([0.0, 1, 2.5, 4], onp.float32)),
                 {}, [1, 2, 3, 4]),
    "digitize_right": ("digitize", (onp.array([0.0, 1, 2.5, 10],
                                              onp.float32),
                                    onp.array([0.0, 1, 2.5, 4],
                                              onp.float32)),
                       {"right": True}, [0, 1, 2, 4]),
    "digitize_decreasing": ("digitize", (onp.array([0.0, 1, 3],
                                                   onp.float32),
                                         onp.array([4.0, 2, 1, 0],
                                                   onp.float32)),
                            {}, [3, 2, 1]),
    "greater_is_bool": ("greater", (onp.array([1, 3]), 2), {},
                        [False, True]),
}


@pytest.mark.parametrize("trap", sorted(TRAPS))
def test_numpy_semantics_where_torch_differs(trap):
    name, args, kw, expect = TRAPS[trap]
    got, want = _both(name, *args, **kw)
    assert onp.concatenate([g.reshape(-1) for g in got]).tolist() == \
        pytest.approx(onp.asarray(expect, onp.float64).tolist(),
                      rel=1e-6, nan_ok=True)
    for g, w in zip(got, want):
        assert CS.np_rel_err(g, w) <= TOL, (g, w)
    if name in ("greater", "isclose"):
        assert got[0].dtype == onp.bool_


def test_trapz_and_resize_follow_numpy():
    y = onp.array([[1.0, 2, 4], [0, 1, 0]], onp.float32)
    x = onp.array([0.0, 0.5, 2], onp.float32)
    onp.testing.assert_allclose(
        tnp.trapz(tnp.array(y, ctx=CPU), tnp.array(x, ctx=CPU)).asnumpy(),
        onp.trapezoid(y, x), rtol=1e-6)
    onp.testing.assert_allclose(
        tnp.trapz(tnp.array(y, ctx=CPU), dx=0.5, axis=0).asnumpy(),
        onp.trapezoid(y, dx=0.5, axis=0), rtol=1e-6)
    onp.testing.assert_array_equal(
        tnp.resize(tnp.array(y, ctx=CPU), (4, 2)).asnumpy(),
        onp.resize(y, (4, 2)))


def test_metadata_helpers():
    a = tnp.ones((2, 3), ctx=CPU)
    assert tnp.shape(a) == (2, 3) and tnp.ndim(a) == 2
    assert tnp.size(a) == 6 and tnp.size(a, 1) == 3
    assert tnp.result_type(a, tnp.ones((1,), dtype="int32", ctx=CPU)) == \
        torch.float32
    assert tnp.promote_types("int32", "float32") == torch.float32
    assert tnp.can_cast("int32", "int64") and \
        not tnp.can_cast("float32", "int32")
    assert tnp.may_share_memory(a, a[0]) and \
        not tnp.may_share_memory(a, tnp.ones((2,), ctx=CPU))

"""``mx.np.random`` and ``mx.np.linalg`` of the PyTorch/CUDA port against
the JAX package, on the CPU.

Random streams differ by design (torch generators against JAX keys), so
draws are never compared value by value (trap 4): each distribution is
held by its moments, within 5 standard errors of the exact mean and
variance at 200,000 draws, and ``gamma``, ``beta``, ``normal``,
``uniform``, ``exponential`` and ``chisquare`` by a Kolmogorov–Smirnov
test against ``scipy.stats``'s exact distribution (p > 1e-4, in both
packages); ``choice``, ``shuffle`` and ``multinomial`` by their support
and their counts.  Eigen- and singular vectors are unique only up to
sign (trap 5): linalg is held by reconstructions (A·V = V·Λ, U·S·Vh = A,
Q·R = A, L·Lᵀ = A) and by the sorted eigenvalues against the
reference's, within 1e-4 of the largest value (f32 against the
reference's float64 on the same f32 inputs).
"""
import numpy as onp
import pytest
import scipy.stats

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
N = 200_000
TOL = 1e-4
KS_P = 1e-4
tnp, jnp_ = tmx.np, jmx.np


def _draw(pkg, name, *args, **kw):
    kw = dict(kw, **({"ctx": CPU} if pkg is tmx else {}))
    return getattr(pkg.np.random, name)(*args, **kw).asnumpy() \
        .astype(onp.float64)


DISTS = {
    "uniform": ((-1.0, 3.0), scipy.stats.uniform(-1.0, 4.0)),
    "normal": ((0.5, 2.0), scipy.stats.norm(0.5, 2.0)),
    "gamma": ((2.5, 1.5), scipy.stats.gamma(2.5, scale=1.5)),
    "beta": ((2.0, 5.0), scipy.stats.beta(2.0, 5.0)),
    "chisquare": ((3.0,), scipy.stats.chi2(3.0)),
    "exponential": ((2.0,), scipy.stats.expon(scale=2.0)),
}


@pytest.mark.parametrize("name", sorted(DISTS))
def test_distribution_moments_and_ks(name):
    args, ref = DISTS[name]
    tmx.np.random.seed(7)
    for pkg in (jmx, tmx):
        kw = {} if pkg is jmx or name == "exponential" else \
            {"dtype": "float32"}
        x = _draw(pkg, name, *args, size=(N,), **kw)
        assert x.shape == (N,)
        mean, var = ref.stats("mv")
        assert abs(x.mean() - mean) <= 5 * onp.sqrt(var / N), (pkg, name)
        m4 = ref.moment(4) - 4 * ref.moment(3) * mean + \
            6 * ref.moment(2) * mean ** 2 - 3 * mean ** 4
        se_var = onp.sqrt(max(m4 - var ** 2, 0.0) / N)
        assert abs(x.var() - var) <= 5 * se_var, (pkg, name)
        assert scipy.stats.kstest(x, ref.cdf).pvalue > KS_P, (pkg, name)


def test_randint_rand_randn_and_dtypes():
    tmx.np.random.seed(3)
    with CPU:
        r = tnp.random.randint(0, 10, size=(N,))
        assert str(r.dtype) == "torch.int64"
        counts = onp.bincount(r.asnumpy(), minlength=10)
        assert counts.min() > 0 and r.asnumpy().max() < 10
        assert abs(counts / N - 0.1).max() < 5 * onp.sqrt(0.09 / N)
        assert tnp.random.randint(5, size=(3,)).asnumpy().max() < 5
        assert tnp.random.rand(2, 3).shape == (2, 3)
        assert tnp.random.randn(4).shape == (4,)
        assert tnp.random.uniform().shape == ()
        assert type(tnp.random.normal(size=(2,))).__name__ == "ndarray"


def test_the_same_seed_gives_the_same_draws():
    tmx.np.random.seed(11)
    a = tnp.random.normal(size=(5,), ctx=CPU).asnumpy()
    g = tnp.random.gamma(2.0, size=(5,), ctx=CPU).asnumpy()
    tmx.np.random.seed(11)
    onp.testing.assert_array_equal(
        a, tnp.random.normal(size=(5,), ctx=CPU).asnumpy())
    onp.testing.assert_array_equal(
        g, tnp.random.gamma(2.0, size=(5,), ctx=CPU).asnumpy())


def test_choice_support_and_counts():
    tmx.np.random.seed(5)
    p = onp.array([0.1, 0.2, 0.3, 0.4])
    for pkg in (jmx, tmx):
        kw = {"ctx": CPU} if pkg is tmx else {}
        c = pkg.np.random.choice(4, size=(N,), p=p, **kw).asnumpy()
        freq = onp.bincount(c, minlength=4) / N
        assert abs(freq - p).max() < 5 * onp.sqrt(0.25 / N)
        u = pkg.np.random.choice(5, size=(N,), **kw).asnumpy()
        assert set(onp.unique(u)) == set(range(5))
        perm = pkg.np.random.choice(10, size=(10,), replace=False,
                                    **kw).asnumpy()
        assert sorted(perm.tolist()) == list(range(10))
        pool = pkg.np.array(onp.array([3.0, 5.0, 7.0]), **kw)
        assert set(pkg.np.random.choice(pool, size=(50,)).asnumpy()) <= \
            {3.0, 5.0, 7.0}


def test_shuffle_permutes_rows_in_place():
    tmx.np.random.seed(9)
    x = tnp.array(onp.arange(20).reshape(10, 2), ctx=CPU)
    assert tnp.random.shuffle(x) is None
    rows = x.asnumpy()
    assert sorted(map(tuple, rows.tolist())) == \
        [(2 * i, 2 * i + 1) for i in range(10)]
    assert not (rows == onp.arange(20).reshape(10, 2)).all()


def test_multinomial_counts():
    tmx.np.random.seed(13)
    pv = [0.2, 0.3, 0.5]
    for pkg in (jmx, tmx):
        with CPU:
            c = pkg.np.random.multinomial(20, pv, size=(5000,)).asnumpy()
        assert c.shape == (5000, 3) and (c.sum(axis=1) == 20).all()
        assert abs(c.mean(axis=0) - 20 * onp.array(pv)).max() < \
            5 * onp.sqrt(20 * 0.25 / 5000)
    with CPU:
        one = tnp.random.multinomial(7, pv).asnumpy()
    assert one.shape == (3,) and one.sum() == 7


# --- linalg -------------------------------------------------------------

RS = onp.random.RandomState(0)
A = RS.standard_normal((6, 6)).astype(onp.float32)
SPD = (A @ A.T + 6 * onp.eye(6)).astype(onp.float32)
R = RS.standard_normal((7, 4)).astype(onp.float32)
B = RS.standard_normal((6, 2)).astype(onp.float32)


def _t(x):
    return tnp.array(x, ctx=CPU)


def _rel(a, b):
    a, b = onp.asarray(a, onp.complex128), onp.asarray(b, onp.complex128)
    return float(onp.abs(a - b).max() / max(onp.abs(b).max(), 1e-30))


def test_eig_reconstructs_and_eigvals_match_as_sorted_pairs():
    w, v = (o.asnumpy() for o in tnp.linalg.eig(_t(A)))
    assert _rel(A.astype(onp.complex128) @ v, v * w) <= TOL
    ref = jnp_.linalg.eigvals(jnp_.array(A)).asnumpy()
    got = tnp.linalg.eigvals(_t(A)).asnumpy()

    def key(z):
        return sorted(z, key=lambda c: (round(c.real, 4), round(c.imag, 4)))

    assert _rel(onp.array(key(got)), onp.array(key(ref))) <= TOL


def test_eigh_and_eigvalsh():
    w, v = (o.asnumpy() for o in tnp.linalg.eigh(_t(SPD)))
    assert _rel(SPD @ v, v * w) <= TOL
    assert _rel(v.T @ v, onp.eye(6)) <= TOL
    ref = jnp_.linalg.eigvalsh(jnp_.array(SPD)).asnumpy()
    assert _rel(tnp.linalg.eigvalsh(_t(SPD)).asnumpy(), ref) <= TOL


@pytest.mark.parametrize("full", [True, False])
def test_svd_reconstructs(full):
    u, s, vh = (o.asnumpy() for o in tnp.linalg.svd(_t(R),
                                                    full_matrices=full))
    k = s.shape[0]
    assert _rel(u[:, :k] * s @ vh[:k], R) <= TOL
    ref = jnp_.linalg.svd(jnp_.array(R), full_matrices=full)
    assert [o.shape for o in ref] == [(7, 7 if full else 4), (4,), (4, 4)]
    assert (u.shape, vh.shape) == (ref[0].shape, ref[2].shape)
    assert _rel(s, ref[1].asnumpy()) <= TOL
    assert _rel(tnp.linalg.svd(_t(R), compute_uv=False).asnumpy(),
                ref[1].asnumpy()) <= TOL


def test_qr_and_cholesky_reconstruct():
    q, r = (o.asnumpy() for o in tnp.linalg.qr(_t(R)))
    assert _rel(q @ r, R) <= TOL and _rel(onp.triu(r), r) == 0.0
    l = tnp.linalg.cholesky(_t(SPD)).asnumpy()
    assert _rel(l @ l.T, SPD) <= TOL and _rel(onp.tril(l), l) == 0.0
    ref = jnp_.linalg.cholesky(jnp_.array(SPD)).asnumpy()
    assert _rel(l, ref) <= TOL  # unique: positive diagonal


DIRECT = {
    "inv": ((A,), {}), "pinv": ((R,), {}), "det": ((A,), {}),
    "slogdet": ((A,), {}), "solve": ((A, B), {}),
    "matrix_rank": ((R @ R.T,), {}), "matrix_power": ((A, 3), {}),
    "norm": ((A,), {}), "norm_axis": ((R,), {"axis": 1}),
    "norm_nuc": ((A,), {"ord": "nuc"}), "cond": ((SPD,), {}),
    "multi_dot": (([A, A, B],), {}),
    "tensorinv": ((onp.eye(6, dtype=onp.float32).reshape(6, 2, 3) * 2,),
                  {"ind": 1}),
    "tensorsolve": ((onp.eye(6, dtype=onp.float32).reshape(2, 3, 6) * 2,
                     onp.ones((2, 3), onp.float32)), {}),
    "lstsq": ((R, RS.standard_normal(7).astype(onp.float32)), {}),
}


@pytest.mark.parametrize("case", sorted(DIRECT))
def test_unique_results_match_the_reference(case):
    args, kw = DIRECT[case]
    name = case.split("_")[0] if case.startswith("norm") else case
    conv = [
        [p.np.array(x, **k) for x in a] if isinstance(a, list) else
        p.np.array(a, **k) if isinstance(a, onp.ndarray) else a
        for p, k in ((tmx, {"ctx": CPU}), (jmx, {})) for a in args]
    half = len(args)
    got = getattr(tnp.linalg, name)(*conv[:half], **kw)
    want = getattr(jnp_.linalg, name)(*conv[half:], **kw)
    if name == "matrix_rank":
        assert int(got.item()) == int(want.item()) == 4
        return
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if name == "lstsq" and g.size == 0:
            continue
        assert _rel(g.asnumpy(), w.asnumpy()) <= TOL, (case, g, w)


def test_linalg_is_differentiable():
    grads = []
    for pkg, ag in ((jmx, jmx.autograd), (tmx, tmx.autograd)):
        kw = {"ctx": CPU} if pkg is tmx else {}
        x = pkg.np.array(SPD, **kw)
        x.attach_grad()
        with ag.record():
            y = pkg.np.linalg.det(x) + pkg.np.sum(pkg.np.linalg.inv(x))
        y.backward()
        grads.append(x.grad.asnumpy())
    assert _rel(grads[1], grads[0]) <= 1e-3

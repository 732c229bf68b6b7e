"""Sparse storage of the port (``mxnet_tpu_torch/ndarray/sparse.py``)
against the JAX package: every case of ``tests/test_sparse.py``, at its
sizes and with its parametrisation, run through both packages on the
same numpy inputs, plus the constructors, ``retain``, ``zeros`` and the
transposed CSR products.

Stored indices (and ``indptr``) must be exactly equal to the
reference's; values are f32 within rtol 1e-6, ``dot`` within 1e-5.  The
reference's example smoke case is in ``test_torch_sparse_linear.py``
(its JAX side alone takes about 20 s).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

R = np.random.RandomState(7)
VAL_RTOL = 1e-6
DOT_RTOL = 1e-5


def _sparse_np(shape, density=0.4, seed_off=0):
    rs = np.random.RandomState(11 + seed_off)
    x = np.round(rs.randn(*shape), 2).astype(np.float32)
    x[rs.rand(*shape) > density] = 0.0
    return x


A = _sparse_np((6, 5))
B = _sparse_np((6, 5), seed_off=1)
D = np.round(R.randn(6, 5), 2).astype(np.float32) + 3.0  # dense, nonzero


def _both(fn):
    """(port result, reference result) of ``fn(mx)``; the port's on the
    CPU."""
    ref = fn(jmx)
    with tmx.cpu():
        got = fn(tmx)
    return got, ref


def _stype(x):
    return getattr(x, "stype", "default")


def _same(got, ref, rtol=VAL_RTOL, atol=0.0):
    """Same storage type, exactly the same stored pattern, close
    values."""
    assert _stype(got) == _stype(ref)
    if _stype(got) in ("row_sparse", "csr"):
        np.testing.assert_array_equal(got.indices.asnumpy(),
                                      np.asarray(ref.indices.asnumpy()))
    if _stype(got) == "csr":
        np.testing.assert_array_equal(got.indptr.asnumpy(),
                                      np.asarray(ref.indptr.asnumpy()))
    np.testing.assert_allclose(got.asnumpy(), np.asarray(ref.asnumpy()),
                               rtol=rtol, atol=atol)


def _mk(stype):
    return lambda mx, x: mx.nd.array(x).tostype(stype)


MAKERS = [("row_sparse", _mk("row_sparse")), ("csr", _mk("csr"))]


# --- binary: sparse kernels keep the stype ----------------------------------

@pytest.mark.parametrize("stype,mk", MAKERS)
@pytest.mark.parametrize("opname,npop", [
    ("add", np.add), ("subtract", np.subtract), ("multiply", np.multiply),
])
def test_binary_sparse_sparse(stype, mk, opname, npop):
    got, ref = _both(lambda mx: getattr(mx.nd.sparse, opname)(
        mk(mx, A), mk(mx, B)))
    assert got.stype == stype
    _same(got, ref)
    np.testing.assert_allclose(got.asnumpy(), npop(A, B), rtol=VAL_RTOL)


@pytest.mark.parametrize("stype,mk", MAKERS)
def test_binary_sparse_dense_mul_div(stype, mk):
    for op in (lambda s, d: s * d, lambda s, d: d * s, lambda s, d: s / d):
        got, ref = _both(lambda mx: op(mk(mx, A), mx.nd.array(D)))
        assert got.stype == stype
        _same(got, ref)


@pytest.mark.parametrize("stype,mk", MAKERS)
def test_binary_sparse_scalar(stype, mk):
    for op in (lambda s: s * 2.5, lambda s: s / 2.0, lambda s: 3.0 * s,
               lambda s: -s):
        got, ref = _both(lambda mx: op(mk(mx, A)))
        assert got.stype == stype
        _same(got, ref)


def test_binary_storage_fallback_densifies():
    from mxnet_tpu_torch.ndarray import sparse as tsp

    for op in (lambda mx: _mk("row_sparse")(mx, A) + mx.nd.array(D),
               lambda mx: _mk("csr")(mx, A) + 1.0,
               lambda mx: mx.nd.sparse.divide(_mk("row_sparse")(mx, A),
                                              _mk("row_sparse")(mx, B))):
        got, ref = _both(op)
        assert not isinstance(got, tsp.BaseSparseNDArray)
        _same(got, ref)


def test_binary_union_actually_merges():
    def f(mx):
        a = mx.nd.sparse.row_sparse_array(
            (np.ones((2, 3), np.float32), np.array([0, 2])), shape=(5, 3))
        b = mx.nd.sparse.row_sparse_array(
            (np.full((2, 3), 2.0, np.float32), np.array([2, 4])),
            shape=(5, 3))
        return a + b

    got, ref = _both(f)
    assert got.indices.asnumpy().tolist() == [0, 2, 4]
    _same(got, ref)


def test_binary_intersection_drops_single_sided_rows():
    def f(mx):
        a = mx.nd.sparse.row_sparse_array(
            (np.ones((2, 3), np.float32), np.array([0, 2])), shape=(5, 3))
        b = mx.nd.sparse.row_sparse_array(
            (np.full((2, 3), 2.0, np.float32), np.array([2, 4])),
            shape=(5, 3))
        return a * b

    got, ref = _both(f)
    assert got.indices.asnumpy().tolist() == [2]
    _same(got, ref)


# --- unary ------------------------------------------------------------------

@pytest.mark.parametrize("stype,mk", MAKERS)
@pytest.mark.parametrize("opname", ["abs", "sign", "square", "sqrt", "relu",
                                    "negative", "tanh", "expm1", "log1p"])
def test_unary_zero_preserving_keeps_structure(stype, mk, opname):
    x = np.abs(A) if opname in ("sqrt", "log1p") else A
    got, ref = _both(lambda mx: getattr(mx.nd, opname)(mk(mx, x)))
    assert got.stype == stype
    _same(got, ref, rtol=1e-5, atol=1e-6)


def test_unary_non_zero_preserving_densifies():
    got, ref = _both(lambda mx: mx.nd.exp(_mk("row_sparse")(mx, A)))
    assert _stype(got) == "default"
    _same(got, ref, rtol=1e-5)


# --- cast_storage -----------------------------------------------------------

@pytest.mark.parametrize("src", ["default", "row_sparse", "csr"])
@pytest.mark.parametrize("dst", ["default", "row_sparse", "csr"])
def test_cast_storage_all_pairs(src, dst):
    def f(mx):
        dense = mx.nd.array(A)
        x = mx.nd.cast_storage(dense, src) if src != "default" else dense
        return mx.nd.cast_storage(x, dst)

    got, ref = _both(f)
    assert _stype(got) == dst
    _same(got, ref, rtol=0)
    np.testing.assert_array_equal(got.asnumpy(), A)


def test_cast_storage_csr_pattern():
    got, ref = _both(lambda mx: mx.nd.cast_storage(mx.nd.array(A), "csr"))
    rows, cols = np.nonzero(A)
    assert got.indices.asnumpy().tolist() == cols.tolist()
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=A.shape[0]))])
    assert got.indptr.asnumpy().tolist() == indptr.tolist()
    _same(got, ref, rtol=0)


# --- the chained user script -------------------------------------------------

def test_sparse_chain_never_densifies():
    X = _sparse_np((8, 6), density=0.3)
    W = np.round(R.randn(6, 4), 2).astype(np.float32)

    def f(mx):
        rsp = mx.nd.array(X).tostype("row_sparse")
        scaled = rsp * 0.5
        sq = mx.nd.square(scaled)
        csr = mx.nd.cast_storage(sq, "csr")
        damped = csr * mx.nd.array(np.full((8, 6), 0.9, np.float32))
        steps = (scaled, sq, csr, damped)
        return [s.stype for s in steps], damped, \
            mx.nd.dot(damped, mx.nd.array(W))

    (stypes, damped, out), (rstypes, rdamped, rout) = _both(f)
    assert stypes == rstypes == ["row_sparse", "row_sparse", "csr", "csr"]
    _same(damped, rdamped)
    _same(out, rout, rtol=DOT_RTOL)
    np.testing.assert_allclose(out.asnumpy(), ((X * 0.5) ** 2 * 0.9) @ W,
                               rtol=2e-5, atol=1e-5)


def test_csr_roundtrip_via_rsp():
    def f(mx):
        r = _mk("csr")(mx, A).tostype("row_sparse")
        return r, r.tostype("csr")

    (r, back), (rr, rback) = _both(f)
    assert (r.stype, back.stype) == ("row_sparse", "csr")
    _same(r, rr, rtol=0)
    _same(back, rback, rtol=0)


def test_fallback_keeps_dense_autograd_tape():
    def f(mx):
        x = mx.nd.array(D)
        x.attach_grad()
        s = _mk("row_sparse")(mx, A)
        with mx.autograd.record():
            z = (x * 3.0) + s
            loss = (z * z).sum()
        loss.backward()
        return x.grad

    got, ref = _both(f)
    _same(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got.asnumpy(), 2.0 * (3.0 * D + A) * 3.0,
                               rtol=1e-5)


def test_out_kwarg_with_sparse_raises():
    with tmx.cpu():
        o = tmx.nd.zeros((6, 5))
        with pytest.raises(tmx.MXNetError):
            tmx.nd.square(_mk("row_sparse")(tmx, A), out=o)
        with pytest.raises(tmx.MXNetError):
            tmx.nd.multiply(_mk("row_sparse")(tmx, A),
                            _mk("row_sparse")(tmx, B), out=o)


def test_cast_storage_3d_rsp_to_csr_raises():
    with tmx.cpu():
        r = tmx.nd.sparse.row_sparse_array(
            (np.ones((2, 2, 2), np.float32), np.array([0, 2])),
            shape=(4, 2, 2))
        with pytest.raises(tmx.MXNetError, match="2D"):
            r.tostype("csr")


def test_stored_entry_kernel_defers_to_tape_when_recording():
    def f(mx):
        x = mx.nd.array(D)
        x.attach_grad()
        s = _mk("csr")(mx, A)
        with mx.autograd.record():
            z = x * s
            loss = (z * z).sum() + (x * x).sum()
        loss.backward()
        return x.grad, _stype(z), (x * s).stype

    (g, zst, st), (rg, rzst, rst) = _both(f)
    assert (zst, st) == (rzst, rst) == ("default", "csr")
    _same(g, rg, rtol=1e-5)


def test_divide_semantics_match_inside_record():
    dz = D.copy()
    dz[0, 0] = 0.0
    Az = A.copy()
    Az[0, 0] = 0.0

    def f(mx):
        s = _mk("csr")(mx, Az)
        outside = s / mx.nd.array(dz)
        x = mx.nd.array(dz)
        x.attach_grad()
        with mx.autograd.record():
            z = s / x
            loss = z.sum()
        loss.backward()
        return outside, z, x.grad

    (out, z, g), (rout, rz, rg) = _both(f)
    _same(out, rout)
    _same(z, rz)
    _same(g, rg, rtol=1e-5)
    assert np.isfinite(z.asnumpy()).all() and np.isfinite(g.asnumpy()).all()
    assert g.asnumpy()[0, 0] == 0.0


def test_sparse_dot_dense_operand_gradient_flows():
    X = _sparse_np((12, 6), density=0.4)

    def f(mx):
        w = mx.nd.zeros((6, 1))
        w.attach_grad()
        csr = mx.nd.array(X).tostype("csr")
        with mx.autograd.record():
            out = mx.nd.dot(csr, w)
            loss = (out * out).sum() + out.sum()
        loss.backward()
        return w.grad

    got, ref = _both(f)
    _same(got, ref, rtol=DOT_RTOL)
    np.testing.assert_allclose(got.asnumpy(), X.T @ np.ones((12, 1)),
                               rtol=1e-5)


# --- beyond the reference's cases -------------------------------------------

@pytest.mark.parametrize("transpose_a,transpose_b", [
    (False, False), (True, False), (False, True), (True, True)])
def test_csr_dot_transposes(transpose_a, transpose_b):
    X = _sparse_np((7, 9), density=0.3, seed_off=3)
    rs = np.random.RandomState(5)
    rows = 7 if transpose_a else 9
    W = rs.randn(*((4, rows) if transpose_b else (rows, 4))) \
        .astype(np.float32)

    got, ref = _both(lambda mx: mx.nd.dot(
        mx.nd.array(X).tostype("csr"), mx.nd.array(W),
        transpose_a=transpose_a, transpose_b=transpose_b))
    _same(got, ref, rtol=DOT_RTOL, atol=1e-6)
    xa = X.T if transpose_a else X
    wb = W.T if transpose_b else W
    np.testing.assert_allclose(got.asnumpy(), xa @ wb, rtol=1e-5,
                               atol=1e-5)


def _fm_like_csr(dtype, features=900, seed=9):
    """A CSR batch with the factorization machine's row width (39 stored
    entries, increasing columns) plus an empty row, a ragged row of one
    entry and one of 250, and columns that no row names; the entries'
    rows, values and a (rows, 16) rhs in ``dtype``."""
    import torch

    rs = np.random.RandomState(seed)
    widths = [39] * 6 + [0, 1, 39, 0, 250, 39]
    used = np.arange(0, features, 3)  # two columns in three never stored
    cols = [np.sort(rs.choice(used, w, replace=False)) for w in widths]
    indptr = np.concatenate([[0], np.cumsum(widths)])
    vals = rs.uniform(-1, 1, indptr[-1]).astype(np.float32)
    g = rs.normal(size=(len(widths), 16)).astype(np.float32)
    to = (lambda a, dt=dtype: torch.from_numpy(a).to(dt))
    rows = torch.repeat_interleave(torch.arange(len(widths)),
                                   torch.from_numpy(np.diff(indptr)))
    return (to(vals), to(np.concatenate(cols).astype(np.int64),
                         torch.int64),
            to(indptr.astype(np.int64), torch.int64), rows, to(g))


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16",
                                   "bfloat16"])
def test_csr_column_view_through_the_plain_product_is_the_transpose(dtype):
    """The transposed product's column-ordered view (``_csr_column_view``,
    what the card's kernel runs ``Aᵀ @ rhs`` on), fed through the plain
    version as a CSR array of ``Aᵀ``, equals ``_csr_dense_dot(...,
    transpose_a=True)`` bit for bit: each column's entries keep their
    stored order, the order in which ``index_add_`` adds them."""
    import torch
    from mxnet_tpu_torch.ndarray import sparse as tsp

    dt = getattr(torch, dtype)
    features = 900
    vals, cols, indptr, rows, g = _fm_like_csr(dt, features)
    want = tsp._csr_dense_dot(vals, cols, rows, features, g,
                              transpose_a=True)
    d_t, c_t, p_t, r_t = tsp._csr_column_view(vals, cols, rows, features)
    assert p_t.numel() == features + 1 and int(p_t[-1]) == vals.numel()
    assert torch.equal(p_t[1:] - p_t[:-1],
                       torch.bincount(cols, minlength=features))
    assert torch.equal(r_t, torch.sort(cols).values)
    got = tsp._csr_dense_dot(d_t, c_t, r_t, features, g)
    assert got.dtype == want.dtype and torch.equal(got, want)
    # and through the wrapper, which takes the plain version on the CPU
    assert torch.equal(tsp.csr_dense_dot(vals, cols, indptr, rows, g,
                                         transpose_a=True,
                                         n_cols=features), want)


def test_dot_of_a_vector_and_of_row_sparse_densifies():
    X = _sparse_np((6, 5), seed_off=4)
    v = np.arange(5, dtype=np.float32)
    got, ref = _both(lambda mx: mx.nd.dot(mx.nd.array(X).tostype("csr"),
                                          mx.nd.array(v)))
    _same(got, ref, rtol=DOT_RTOL)
    got, ref = _both(lambda mx: mx.nd.dot(
        mx.nd.array(X).tostype("row_sparse"), mx.nd.array(D.T)))
    _same(got, ref, rtol=DOT_RTOL)


def test_constructors_retain_and_zeros():
    def f(mx):
        sp = mx.nd.sparse
        r = sp.row_sparse_array((np.arange(6, dtype=np.float32)
                                 .reshape(3, 2), np.array([1, 3, 4])),
                                shape=(6, 2))
        c = sp.csr_matrix((np.array([1.0, 2.0, 3.0], np.float32),
                           np.array([0, 2, 1]), np.array([0, 2, 2, 3])),
                          shape=(3, 4))
        return (r, sp.retain(r, mx.nd.array([3, 4, 5])), c,
                sp.row_sparse_array(A), sp.csr_matrix(A),
                sp.zeros("row_sparse", (4, 3)), sp.zeros("csr", (4, 3)))

    got, ref = _both(f)
    for g, r in zip(got, ref):
        _same(g, r, rtol=0)
    assert got[1].indices.asnumpy().tolist() == [3, 4]
    assert got[0].indices.dtype == got[2].indptr.dtype == \
        tmx.nd.array([0], dtype="int64", ctx=tmx.cpu()).dtype


def test_to_bcoo_is_not_carried_over_and_values_stay_put():
    with tmx.cpu():
        c = _mk("csr")(tmx, A)
        with pytest.raises(tmx.MXNetError, match="Not carried over"):
            c.to_bcoo()
        for x in (c, c.tostype("row_sparse"), c * 2.0, c + c,
                  tmx.nd.sparse.retain(c.tostype("row_sparse"), [0])):
            assert x.data.context == x.indices.context == tmx.cpu()

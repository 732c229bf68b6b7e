"""The factorization machine, ``LibSVMIter`` and the row-sparse store
paths of the port against the JAX package (``tests/test_fm.py``'s cases
and more).

- ``LibSVMIter``: batches, ``round_batch`` padding (also past the data),
  ``round_batch=False`` and the label file, equal to the reference's.
- ``FMModel``: the same seed draws the same tables in both packages; the
  forward; 5 steps with local SGD, with the store's SGD and with the
  store's Adam (the lazy row updates): losses and tables within rtol
  1e-5, and every row a step did not touch bit-equal to before, in the
  model's tables and in the store's Adam state.
- ``row_sparse_pull`` into dense and ``RowSparseNDArray`` targets, and
  the optimizers' lazy rules on their own.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import fm as jfm
from mxnet_tpu_torch.models import fm as tfm

CPU = tmx.cpu()
RTOL = 1e-5
NFEAT = 64


@pytest.fixture(autouse=True)
def on_cpu():
    with CPU:
        yield


def _toy_libsvm(path, n=40, nfeat=16, seed=0, extra=3):
    """Separable data: label = 1 iff feature 0 present (the reference
    test's generator)."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            label = i % 2
            feats = {0: 1.0} if label else {1: 1.0}
            for _ in range(extra):
                feats[int(rng.randint(2, nfeat))] = float(
                    rng.uniform(0.5, 1.0))
            toks = " ".join(f"{k}:{v}" for k, v in sorted(feats.items()))
            f.write(f"{label} {toks}\n")


def _batches(it):
    return [(b.data[0], b.label[0], b.pad) for b in it]


def _same_csr(got, ref):
    assert got.stype == ref.stype == "csr" and got.shape == ref.shape
    for part in ("indices", "indptr"):
        np.testing.assert_array_equal(getattr(got, part).asnumpy(),
                                      getattr(ref, part).asnumpy())
    np.testing.assert_array_equal(got.data.asnumpy(), ref.data.asnumpy())


# --- LibSVMIter ---------------------------------------------------------------

@pytest.mark.parametrize("batch_size,round_batch", [
    (4, True), (4, False), (16, True), (25, True)])
def test_libsvm_iter_batches_and_padding(tmp_path, batch_size, round_batch):
    path = str(tmp_path / "data.libsvm")
    _toy_libsvm(path, n=10, nfeat=16)
    kw = dict(data_libsvm=path, data_shape=(16,), batch_size=batch_size,
              round_batch=round_batch)
    ref = _batches(jmx.io.LibSVMIter(**kw))
    it = tmx.io.LibSVMIter(**kw)
    got = _batches(it)
    assert len(got) == len(ref) > 0
    for (g, gl, gp), (r, rl, rp) in zip(got, ref):
        _same_csr(g, r)
        np.testing.assert_array_equal(gl.asnumpy(), rl.asnumpy())
        assert gp == rp
        assert g.data.context == gl.context == CPU
    it.reset()
    assert len(list(it)) == len(ref)
    assert it.provide_data[0].shape == (batch_size, 16)


def test_libsvm_iter_label_file(tmp_path):
    path = str(tmp_path / "data.libsvm")
    _toy_libsvm(path, n=6, nfeat=8)
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"{i * 0.5} 0:1\n" for i in range(6)))
    kw = dict(data_libsvm=path, data_shape=(8,), batch_size=4,
              label_libsvm=str(labels))
    ref = _batches(jmx.io.LibSVMIter(**kw))
    got = _batches(tmx.io.LibSVMIter(**kw))
    for (g, gl, _), (r, rl, _) in zip(got, ref):
        _same_csr(g, r)
        np.testing.assert_array_equal(gl.asnumpy(), rl.asnumpy())
    assert got[0][1].asnumpy().tolist() == [0.0, 0.5, 1.0, 1.5]
    labels.write_text("1\n0\n")
    with pytest.raises(tmx.MXNetError, match="label file has 2 rows"):
        tmx.io.LibSVMIter(**kw)


def test_libsvm_iter(tmp_path):
    """The reference test's case on the port."""
    path = str(tmp_path / "data.libsvm")
    _toy_libsvm(path, n=10, nfeat=16)
    it = tmx.io.LibSVMIter(data_libsvm=path, data_shape=(16,), batch_size=4)
    batches = list(it)
    assert len(batches) == 3
    b0 = batches[0]
    assert isinstance(b0.data[0], tmx.nd.sparse.CSRNDArray)
    assert b0.data[0].shape == (4, 16) and b0.label[0].shape == (4,)
    assert batches[-1].pad == 2
    dense = b0.data[0].todense().asnumpy()
    assert dense.shape == (4, 16) and (dense != 0).sum() >= 8


# --- FMModel --------------------------------------------------------------------

def _csr(pkg, dense):
    return pkg.nd.sparse.cast_storage(pkg.nd.array(dense), "csr")


def _tables(model):
    return [model.w0.asnumpy(), model.w.asnumpy(), model.v.asnumpy()]


def test_fm_forward_matches_dense_formula_and_the_reference():
    rng = np.random.RandomState(0)
    dense = (rng.uniform(size=(4, 8)) < 0.4) * rng.uniform(size=(4, 8))
    dense = dense.astype(np.float32)
    jm = jfm.FMModel(8, factor_dim=3, seed=1)
    tm = tfm.FMModel(8, factor_dim=3, seed=1)
    for g, r in zip(_tables(tm), _tables(jm)):
        np.testing.assert_array_equal(g, r)  # the same numpy draw
    out = tm(_csr(tmx, dense)).asnumpy().ravel()
    np.testing.assert_allclose(
        out, jm(_csr(jmx, dense)).asnumpy().ravel(), rtol=RTOL, atol=1e-7)
    w0, w, v = _tables(tm)
    xv = dense @ v
    want = (w0[0] + dense @ w[:, 0]
            + 0.5 * ((xv ** 2) - (dense ** 2) @ (v ** 2)).sum(1))
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


def test_fm_rowsparse_grad_shape():
    dense = np.zeros((2, 10), np.float32)
    dense[0, 3] = 1.0
    dense[1, 7] = 2.0
    csr = _csr(tmx, dense)
    model = tfm.FMModel(10, factor_dim=2)
    rows = model._touched_rows(csr)
    assert rows.asnumpy().tolist() == [3, 7]
    g = model._rowslice(tmx.nd.array(np.arange(20, dtype=np.float32)
                                     .reshape(10, 2)), rows)
    assert isinstance(g, tmx.nd.sparse.RowSparseNDArray)
    assert g.data.shape == (2, 2)
    np.testing.assert_array_equal(g.data.asnumpy(), [[6, 7], [14, 15]])


def _store(pkg, mode):
    if mode == "local_sgd":
        return None
    kv = pkg.kv.create("local")
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5) if mode == "sgd"
                     else pkg.optimizer.Adam(learning_rate=0.05))
    return kv


def _adam_state(model):
    upd = model.kv._updater
    if upd is None or not isinstance(upd.states.get("fm_v"), tuple):
        return []
    return [s.asnumpy() for s in upd.states["fm_v"]] + \
        [s.asnumpy() for s in upd.states["fm_w"]]


@pytest.mark.parametrize("mode", ["local_sgd", "sgd", "adam"])
def test_fm_steps_match_the_reference_and_leave_untouched_rows(tmp_path,
                                                               mode):
    """5 steps of 16 rows over 64 features: the losses and the tables
    against the reference's; each step's untouched rows, and their Adam
    moments, keep their bits."""
    path = str(tmp_path / "train.libsvm")
    _toy_libsvm(path, n=80, nfeat=NFEAT, extra=4)
    kw = dict(data_libsvm=path, data_shape=(NFEAT,), batch_size=16)
    jm = jfm.FMModel(NFEAT, factor_dim=4, lr=0.5, seed=3,
                     kvstore=_store(jmx, mode))
    tm = tfm.FMModel(NFEAT, factor_dim=4, lr=0.5, seed=3,
                     kvstore=_store(tmx, mode))
    jb, tb = list(jmx.io.LibSVMIter(**kw)), list(tmx.io.LibSVMIter(**kw))
    assert len(tb) == 5
    for step, (jbatch, tbatch) in enumerate(zip(jb, tb)):
        before = _tables(tm) + _adam_state(tm)
        rows = np.unique(tbatch.data[0].indices.asnumpy())
        rl = jm.step(jbatch.data[0], jbatch.label[0])
        tl = tm.step(tbatch.data[0], tbatch.label[0])
        np.testing.assert_allclose(tl, rl, rtol=RTOL)
        for g, r in zip(_tables(tm), _tables(jm)):
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=1e-7)
        after = _tables(tm) + _adam_state(tm)
        untouched = np.setdiff1d(np.arange(NFEAT), rows)
        assert len(untouched) > 0
        for b, a in zip(before[1:], after[1:]):  # w, v and Adam's state
            np.testing.assert_array_equal(a[untouched], b[untouched])
        if step == 0 and mode == "adam":
            assert len(after) == 7  # m and v of fm_v and fm_w were made


def test_fm_trains_on_libsvm(tmp_path):
    """The reference test's case on the port: 15 epochs, the loss falls
    and the accuracy of a batch reaches 0.9."""
    path = str(tmp_path / "train.libsvm")
    _toy_libsvm(path, n=64, nfeat=16)
    it = tmx.io.LibSVMIter(data_libsvm=path, data_shape=(16,), batch_size=16)
    model = tfm.FMModel(16, factor_dim=4, lr=0.5)
    losses = []
    for _epoch in range(15):
        it.reset()
        for batch in it:
            losses.append(model.step(batch.data[0], batch.label[0]))
    assert losses[-1] < losses[0] * 0.7
    it.reset()
    batch = next(iter(it))
    assert model.accuracy(batch.data[0], batch.label[0]) >= 0.9


def test_fm_with_kvstore_optimizer():
    """The reference test's case: the store's optimizer and
    row_sparse_pull, 31 steps."""
    dense = np.zeros((4, 6), np.float32)
    dense[:, 0] = [1, 0, 1, 0]
    dense[:, 1] = [0, 1, 0, 1]
    csr = _csr(tmx, dense)
    labels = tmx.nd.array([1.0, 0, 1, 0])
    kv = tmx.kv.create("local")
    kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.5))
    model = tfm.FMModel(6, factor_dim=2, kvstore=kv)
    first = model.step(csr, labels)
    for _ in range(30):
        last = model.step(csr, labels)
    assert last < first


# --- row_sparse_pull and the lazy rules ---------------------------------------

def test_row_sparse_pull_into_dense_and_sparse_targets():
    table = np.arange(12, dtype=np.float32).reshape(6, 2)
    res = []
    for pkg in (jmx, tmx):
        kv = pkg.kv.create("local")
        kv.init("t", pkg.nd.array(table))
        dense = pkg.nd.ones((6, 2)) * -1
        kv.row_sparse_pull("t", out=dense, row_ids=pkg.nd.array([4, 1]))
        rsp = pkg.nd.sparse.zeros("row_sparse", (6, 2))
        kv.row_sparse_pull("t", out=rsp, row_ids=pkg.nd.array([0, 5]))
        res.append((dense.asnumpy(), rsp.indices.asnumpy(),
                    rsp.data.asnumpy(), rsp.asnumpy()))
    for g, r in zip(*res[::-1]):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert res[1][0][0].tolist() == [-1.0, -1.0]  # an unrequested row


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01, "clip_gradient": 0.5}),
    ("adamw", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01})])
def test_lazy_rules_match_the_reference(name, kw):
    """Three updates of a (7, 3) weight by row_sparse gradients: SGD and
    Adam (and AdamW, which inherits Adam's rule in both packages) touch
    only the stored rows; an optimizer without a lazy rule takes the
    gradient dense."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(7, 3).astype(np.float32)
    grads = [(rng.randn(2, 3).astype(np.float32), rows)
             for rows in ([1, 4], [4, 6], [0, 1])]
    res = []
    for pkg in (jmx, tmx):
        opt = pkg.optimizer.create(name, rescale_grad=0.5, **kw)
        w = pkg.nd.array(w0)
        state = opt.create_state(0, w)
        seen = []
        for vals, rows in grads:
            g = pkg.nd.sparse.row_sparse_array((vals, np.array(rows)),
                                               shape=(7, 3))
            opt.update(0, w, g, state)
            seen.append(w.asnumpy())
        res.append(seen)
    for g, r in zip(*res[::-1]):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=1e-7)
    if name in ("sgd", "adam", "adamw"):
        np.testing.assert_array_equal(res[1][-1][[2, 3, 5]], w0[[2, 3, 5]])


def test_sparse_gradients_through_update_many_take_the_lazy_rule():
    """The parameter server's batched update: a row_sparse gradient among
    dense ones keeps its lazy rule, the dense ones the fused route."""
    opt = tmx.optimizer.Adam(learning_rate=0.1)
    upd = tmx.optimizer.get_updater(opt)
    w_sp, w_d = tmx.nd.ones((5, 2)), tmx.nd.ones((3,))
    g_sp = tmx.nd.sparse.row_sparse_array(
        (np.ones((1, 2), np.float32), np.array([3])), shape=(5, 2))
    upd.update_many(["a", "b"], [g_sp, tmx.nd.ones((3,))], [w_sp, w_d])
    got = w_sp.asnumpy()
    assert (got[[0, 1, 2, 4]] == 1.0).all() and (got[3] < 1.0).all()
    assert (w_d.asnumpy() < 1.0).all()
    assert torch.equal(upd.states["a"][0]._data[0], torch.zeros(2))

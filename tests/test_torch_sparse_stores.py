"""Row-sparse values through the other stores and files, against the JAX
package:

- the ``dist_async`` wire both ways (a port worker on the reference's
  server, a reference worker on the port's): row-sparse values given at
  init and pushed, and ``row_sparse_pull``'s rows, equal to the
  reference's local store doing the same;
- the factorization machine through a port ``dist_async`` server over
  TCP (Adam's lazy update on the server), its tables equal to the local
  store's after each step, bit for bit;
- ``dist_sync`` over a gloo group of two ranks (each rank its own FM
  batch): every rank's store holds, after each step, what the
  reference's local store holds after the ranks' summed row-sparse
  gradients (the union of their rows), and each rank's pulled rows are
  the store's;
- a V2 row-sparse ``.params`` blob built to the reference reader's
  layout, read by both packages.
"""
import os
import socket
import struct
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NFEAT, K, B = 48, 4, 12
STEPS = 3
RTOL = 1e-5


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _libsvm(path, n, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            feats = {int(j): float(rng.uniform(0.1, 1.0))
                     for j in rng.choice(NFEAT, 5, replace=False)}
            toks = " ".join(f"{k}:{v}" for k, v in sorted(feats.items()))
            f.write(f"{i % 2} {toks}\n")


GRADS = [(np.random.RandomState(s).randn(3, 2).astype(np.float32), rows)
         for s, rows in ((1, [0, 3, 7]), (2, [3, 5, 8]))]
TABLE = np.random.RandomState(0).randn(10, 2).astype(np.float32)


def _reference_local(jmx):
    """The reference's local store (no optimizer: a push replaces the
    stored value) after GRADS pushed: the table, the rows [3, 5, 9] it
    gives a row_sparse_pull, and a row_sparse value it was given at
    init, pulled dense."""
    kv = jmx.kv.create("local")
    kv.init("emb", jmx.nd.array(TABLE))
    kv.init("rsp", _rsp(jmx, *GRADS[0]))
    for vals, rows in GRADS:
        kv.push("emb", _rsp(jmx, vals, rows))
    out = jmx.nd.zeros((10, 2))
    kv.row_sparse_pull("emb", out=out, row_ids=jmx.nd.array([3, 5, 9]))
    dense = jmx.nd.zeros((10, 2))
    kv.pull("rsp", out=dense)
    return kv._store["emb"].asnumpy(), out.asnumpy(), dense.asnumpy()


def _rsp(pkg, vals, rows):
    return pkg.nd.sparse.row_sparse_array((vals, np.array(rows)),
                                          shape=(10, 2))


def _run_worker(pkg, kv, ids):
    """GRADS through a worker store: init, row-sparse pushes (no
    optimizer: the server keeps each pushed value, dense), a
    row_sparse_pull into a dense and a row_sparse target, and a pull of a
    row_sparse value given at init."""
    kv.init("emb", pkg.nd.array(TABLE))
    kv.init("rsp", _rsp(pkg, *GRADS[0]))
    for vals, rows in GRADS:
        kv.push("emb", _rsp(pkg, vals, rows))
    out = pkg.nd.zeros((10, 2))
    kv.row_sparse_pull("emb", out=out, row_ids=ids([3, 5, 9]))
    dense = pkg.nd.zeros((10, 2))
    kv.pull("rsp", out=dense)
    return out.asnumpy(), dense.asnumpy()


def test_port_worker_sends_row_sparse_to_the_reference_server(monkeypatch):
    """(Both packages' optimizers pickle as their own classes, so the
    server's lazy update is held within the port by the FM tests below
    and ``test_torch_fm.py``.)"""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    from mxnet_tpu.kvstore import dist_async as jda
    from mxnet_tpu_torch.kvstore.dist_async import AsyncPSKVStore

    monkeypatch.setenv("MXT_PS_SECRET", "sparse-secret")
    want_table, want_pull, want_dense = _reference_local(jmx)
    uri = f"127.0.0.1:{_free_port()}"
    srv = jda.serve_forever(uri, jda.PSServer())
    try:
        with tmx.cpu():
            kv = AsyncPSKVStore(root_uri=uri)
            pulled, dense = _run_worker(tmx, kv, list)
            rsp = tmx.nd.sparse.zeros("row_sparse", (10, 2))
            kv.row_sparse_pull("emb", out=rsp, row_ids=[8, 3])
            kv.close()
        np.testing.assert_array_equal(srv.ps._store["emb"].asnumpy(),
                                      want_table)
        assert isinstance(srv.ps._store["rsp"],
                          jmx.nd.sparse.RowSparseNDArray)
        np.testing.assert_array_equal(pulled, want_pull)
        np.testing.assert_array_equal(dense, want_dense)
        assert rsp.indices.asnumpy().tolist() == [8, 3]
        np.testing.assert_array_equal(rsp.data.asnumpy(),
                                      want_table[[8, 3]])
    finally:
        srv.shutdown()
        srv.server_close()


def test_reference_worker_sends_row_sparse_to_the_port_server(monkeypatch):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    from mxnet_tpu.kvstore import dist_async as jda
    from mxnet_tpu_torch.kvstore.dist_async import PSServer, serve_forever

    monkeypatch.setenv("MXT_PS_SECRET", "sparse-secret")
    want_table, want_pull, want_dense = _reference_local(jmx)
    uri = f"127.0.0.1:{_free_port()}"
    srv = serve_forever(uri, PSServer())
    try:
        kv = jda.AsyncPSKVStore(root_uri=uri)
        pulled, dense = _run_worker(jmx, kv, jmx.nd.array)
        kv.close()
        stored = srv.ps._store["emb"]._data
        assert stored.device.type == "cpu"
        np.testing.assert_array_equal(stored.numpy(), want_table)
        assert isinstance(srv.ps._store["rsp"],
                          tmx.nd.sparse.RowSparseNDArray)
        np.testing.assert_array_equal(pulled, want_pull)
        np.testing.assert_array_equal(dense, want_dense)
    finally:
        srv.shutdown()
        srv.server_close()


def test_fm_through_a_dist_async_server_equals_the_local_store(tmp_path,
                                                               monkeypatch):
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.kvstore.dist_async import (AsyncPSKVStore,
                                                    PSServer, serve_forever)
    from mxnet_tpu_torch.models import fm

    monkeypatch.setenv("MXT_PS_SECRET", "fm-secret")
    path = str(tmp_path / "d.libsvm")
    _libsvm(path, B * STEPS)
    uri = f"127.0.0.1:{_free_port()}"
    srv = serve_forever(uri, PSServer())
    try:
        with tmx.cpu():
            kv = AsyncPSKVStore(root_uri=uri)
            kv.set_optimizer(tmx.optimizer.Adam(learning_rate=0.05))
            local = tmx.kv.create("local")
            local.set_optimizer(tmx.optimizer.Adam(learning_rate=0.05))
            remote = fm.FMModel(NFEAT, K, seed=2, kvstore=kv)
            here = fm.FMModel(NFEAT, K, seed=2, kvstore=local)
            it = tmx.io.LibSVMIter(data_libsvm=path, data_shape=(NFEAT,),
                                   batch_size=B)
            for batch in it:
                a = remote.step(batch.data[0], batch.label[0])
                b = here.step(batch.data[0], batch.label[0])
                assert a == b
                for x, y in ((remote.w, here.w), (remote.v, here.v),
                             (remote.w0, here.w0)):
                    np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())
            kv.close()
    finally:
        srv.shutdown()
        srv.server_close()


# --- dist_sync over two gloo ranks --------------------------------------------

@pytest.fixture(scope="module")
def sync_ranks(tmp_path_factory):
    from test_torch_parallel import spawn

    tmp = tmp_path_factory.mktemp("sparse_sync")
    _libsvm(str(tmp / "d.libsvm"), 2 * B * STEPS)
    return spawn(2, tmp, __file__, timeout=120)


def test_dist_sync_sums_row_sparse_pushes_over_the_ranks(sync_ranks):
    """Each step: the ranks' stores hold the same tables, equal to the
    reference's local store after their summed row_sparse gradients
    (Adam, lazy); each rank's model holds the store's values at the rows
    it touched."""
    import mxnet_tpu as jmx

    r0, r1 = sync_ranks
    kv = jmx.kv.create("local")
    kv.set_optimizer(jmx.optimizer.Adam(learning_rate=0.05))
    for key in ("fm_w0", "fm_w", "fm_v"):
        kv.init(key, jmx.nd.array(r0[f"init.{key}"]))
    for s in range(STEPS):
        for key in ("fm_w0", "fm_w", "fm_v"):
            gs = [r[f"g{s}.{key}"] for r in (r0, r1)]
            if key == "fm_w0":
                kv.push(key, jmx.nd.array(gs[0] + gs[1]))
                continue
            rows = np.union1d(r0[f"rows{s}"], r1[f"rows{s}"])
            kv.push(key, jmx.nd.sparse.row_sparse_array(
                ((gs[0] + gs[1])[rows], rows), shape=gs[0].shape))
            want = kv._store[key].asnumpy()
            for r in (r0, r1):
                np.testing.assert_allclose(r[f"store{s}.{key}"], want,
                                           rtol=RTOL, atol=1e-7)
                mine = r[f"rows{s}"]
                np.testing.assert_array_equal(r[f"model{s}.{key}"][mine],
                                              r[f"store{s}.{key}"][mine])
    assert int(r0["world"]) == 2


def _worker(tmp):
    """One rank (no JAX): FM steps through ``dist_sync`` on its own
    batches; records the dense form of each pushed gradient, the store's
    tables and the model's after each step."""
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import fm

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)
    r = parallel.rank()
    out = {"world": parallel.world_size()}
    with cpu:
        kv = tmx.kv.create("dist_sync")
        kv.set_optimizer(tmx.optimizer.Adam(learning_rate=0.05))
        model = fm.FMModel(NFEAT, K, seed=2, kvstore=kv)
        for key in ("fm_w0", "fm_w", "fm_v"):
            out[f"init.{key}"] = kv._local._store[key].asnumpy()
        pushed = {}
        push = kv.push

        def recording_push(key, value, priority=0):
            pushed[key] = value.asnumpy()
            push(key, value, priority)

        kv.push = recording_push
        it = tmx.io.LibSVMIter(data_libsvm=str(tmp / "d.libsvm"),
                               data_shape=(NFEAT,), batch_size=B)
        batches = list(it)[r::2]
        for s, batch in enumerate(batches[:STEPS]):
            out[f"rows{s}"] = np.unique(batch.data[0].indices.asnumpy())
            model.step(batch.data[0], batch.label[0])
            for key, table in (("fm_w0", model.w0), ("fm_w", model.w),
                               ("fm_v", model.v)):
                out[f"g{s}.{key}"] = pushed[key]
                out[f"store{s}.{key}"] = kv._local._store[key].asnumpy()
                out[f"model{s}.{key}"] = table.asnumpy()
    np.savez(tmp / f"rank{r}.npz", **out)


# --- .params ------------------------------------------------------------------

def _row_sparse_blob(shape, idx, vals):
    """A ``.params`` container of one named V2 row_sparse array, in the
    layout the reference's reader takes (``mxnet_tpu/serialization.py``):
    the shape, the aux count and aux shapes, then the indices' and the
    values' dense bodies (dev_type, dev_id, type flag, raw)."""
    out = struct.pack("<QQQ", 0x112, 0, 1)
    out += struct.pack("<Ii", 0xF993FAC9, 1)
    out += struct.pack(f"<I{len(shape)}q", len(shape), *shape)
    out += struct.pack("<I", 1)
    out += struct.pack("<Iq", 1, len(idx))
    out += struct.pack("<iii", 1, 0, 6) + idx.astype(np.int64).tobytes()
    out += struct.pack("<iii", 1, 0, 0) + vals.astype(np.float32).tobytes()
    name = b"emb_weight"
    out += struct.pack("<QQ", 1, len(name)) + name
    return out


def test_row_sparse_params_blob_reads_in_both_packages(tmp_path):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    idx = np.array([1, 4, 6])
    vals = np.arange(9, dtype=np.float32).reshape(3, 3) - 4
    path = tmp_path / "rsp.params"
    path.write_bytes(_row_sparse_blob((8, 3), idx, vals))
    ref = jmx.nd.load(str(path))["emb_weight"]
    got = tmx.nd.load(str(path))["emb_weight"]
    assert got.stype == ref.stype == "row_sparse"
    assert got.shape == ref.shape == (8, 3)
    np.testing.assert_array_equal(got.indices.asnumpy(),
                                  ref.indices.asnumpy())
    np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())
    assert got.data.context == tmx.cpu()
    # written back dense, as the reference writes it
    tmx.nd.save(str(tmp_path / "d.params"), {"emb_weight": got})
    back = jmx.nd.load(str(tmp_path / "d.params"))["emb_weight"]
    assert getattr(back, "stype", "default") == "default"
    np.testing.assert_array_equal(back.asnumpy(), ref.asnumpy())

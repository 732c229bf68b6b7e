"""The ``dist_async`` parameter-server store of the port, against the
JAX package's.

The cases of the reference's ``test_dist_async.py`` and its two
``dist_async`` fault-injection cases (``test_fault_injection.py``) run on
the port (CPU tensors), and the wire is held to the reference's both
ways: a port worker pushes to and pulls from the reference's
``serve_forever``, and a reference worker does the same with the
port's, with the secret, in f32 and bf16 (values exact: the wire copies
bytes).  Trainer results are held to the local store's within rtol 1e-5,
atol 1e-6 (f32).
"""
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.kvstore import dist_async as jda
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.kvstore import dist_async as tda
from mxnet_tpu_torch.kvstore.dist_async import (AsyncPSKVStore, PSServer,
                                                serve_forever)


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def uri():
    return f"127.0.0.1:{_free_port()}"


@pytest.fixture
def ps_secret(monkeypatch):
    """Remote set_optimizer needs HMAC-signed frames (the launcher sets
    MXT_PS_SECRET)."""
    monkeypatch.setenv("MXT_PS_SECRET", "test-job-secret")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                               atol=1e-7)


def test_embedded_push_pull_replaces():
    kv = AsyncPSKVStore()
    kv.init(3, nd.ones((2, 3)))
    out = nd.zeros((2, 3))
    for i in range(4):
        kv.push(3, nd.ones((2, 3)) * (i + 1))
    kv.pull(3, out=out)
    # no updater: the last pushed value replaces the stored one
    _close(out.asnumpy(), np.full((2, 3), 4.0))
    kv.close()


def test_embedded_server_side_sgd():
    kv = tmx.kv.create("dist_async")
    assert kv.type == "dist_async" and isinstance(kv, AsyncPSKVStore)
    kv.init("w", nd.ones((4,)))
    kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.5))
    kv.push("w", nd.ones((4,)) * 2.0)  # w -= 0.5 * 2
    out = nd.zeros((4,))
    kv.pull("w", out=out)
    _close(out.asnumpy(), np.zeros((4,)))
    kv.close()


def test_async_push_is_nonblocking_and_fifo():
    kv = AsyncPSKVStore()
    kv.init(0, nd.zeros((1000, 100)))
    # lr=-1 SGD turns every push into "+= grad": 50 pushes => 50.0
    kv.set_optimizer(tmx.optimizer.SGD(learning_rate=-1.0))
    for _ in range(50):
        kv.push(0, nd.ones((1000, 100)))
    kv.wait_all()
    out = nd.zeros((1000, 100))
    kv.pull(0, out=out)
    _close(out.asnumpy(), np.full((1000, 100), 50.0))
    kv.close()


def test_a_queued_push_copies_its_value():
    """A push's value is copied when it is queued: a later in-place write
    to the source (the next backward into a gradient) does not reach the
    server, and the table never shares a worker's storage."""
    kv = AsyncPSKVStore()
    w = nd.zeros((4,))
    kv.init("k", w)
    g = nd.ones((4,))
    kv.push("k", g)
    g._data.fill_(7.0)
    w._data.fill_(9.0)
    out = nd.zeros((4,))
    kv.pull("k", out=out)
    _close(out.asnumpy(), np.ones(4))
    kv.close()


def test_queued_pushes_update_together_through_the_fused_route(
        monkeypatch):
    """The in-process server keeps its table on its device (the CPU here,
    without a card) and applies pushes queued behind the one it is
    working on, to distinct keys, in one call of the fused multi-tensor
    update (the Trainer's route); SGD with momentum gives each key
    w - lr·g exactly."""
    from mxnet_tpu_torch.ops import multi_tensor

    calls = []
    real = multi_tensor.multi_tensor_update

    def counted(optimizer, items):
        items = list(items)
        calls.append(len(items))
        return real(optimizer, items)

    monkeypatch.setattr(multi_tensor, "multi_tensor_update", counted)
    kv = AsyncPSKVStore()
    assert kv._local.device == torch.device("cpu")
    rng = np.random.RandomState(3)
    ws = [rng.randn(4, 3).astype(np.float32) for _ in range(4)]
    gs = [rng.randn(4, 3).astype(np.float32) for _ in range(4)]
    for i, w in enumerate(ws):
        kv.init(i, nd.array(w))
    kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.5, momentum=0.9))
    with kv._local._lock:  # the dispatcher stops on the first push
        kv.push(0, nd.array(gs[0]))
        deadline = time.monotonic() + 30
        while kv._queue.qsize() and time.monotonic() < deadline:
            time.sleep(0.01)
        for i in (1, 2, 3):
            kv.push(i, nd.array(gs[i]))
    kv.wait_all()
    assert calls == [1, 3]
    for i in range(4):
        out = nd.zeros((4, 3))
        kv.pull(i, out=out)
        np.testing.assert_array_equal(
            out.asnumpy(), (torch.from_numpy(ws[i]) -
                            0.5 * torch.from_numpy(gs[i])).numpy())
        assert kv._local._store[str(i)]._data.device.type == "cpu"
    kv.close()


def test_tcp_two_workers_concurrent(ps_secret, uri):
    srv = serve_forever(uri, PSServer())
    try:
        w0 = AsyncPSKVStore(root_uri=uri, rank=0, num_workers=2)
        w1 = AsyncPSKVStore(root_uri=uri, rank=1, num_workers=2)
        w0.init("k", nd.zeros((64,)))
        w1.init("k", nd.zeros((64,)))  # a second init is a no-op
        w0.set_optimizer(tmx.optimizer.SGD(learning_rate=-1.0))

        def hammer(kv, n):
            with tmx.cpu():
                for _ in range(n):
                    kv.push("k", nd.ones((64,)))
            kv.wait_all()

        ts = [threading.Thread(target=hammer, args=(w, n))
              for w, n in ((w0, 20), (w1, 30))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
            assert not t.is_alive()
        out = nd.zeros((64,))
        w0.pull("k", out=out)
        _close(out.asnumpy(), np.full((64,), 50.0))
        assert (w1.rank, w1.num_workers) == (1, 2)
        w0.close()
        w1.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_tcp_server_side_optimizer_no_barrier(ps_secret, uri):
    srv = serve_forever(uri, PSServer())
    try:
        w0 = AsyncPSKVStore(root_uri=uri, rank=0, num_workers=2)
        w1 = AsyncPSKVStore(root_uri=uri, rank=1, num_workers=2)
        w0.init("w", nd.ones((8,)) * 10.0)
        w0.set_optimizer(tmx.optimizer.SGD(learning_rate=1.0))
        # worker 1 pushes alone: applied at once, no wait for worker 0
        w1.push("w", nd.ones((8,)))
        w1.wait_all()
        out = nd.zeros((8,))
        w1.pull("w", out=out)
        _close(out.asnumpy(), np.full((8,), 9.0))
        w0.close()
        w1.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_row_sparse_values_name_their_item(uri):
    """Row-sparse values, refused naming item 8e until slice 16, now
    cross the wire: a row_sparse_pull into a dense target writes only
    the requested rows, and the raw reply is the reference's
    ``("rows", values, ids)`` (``test_torch_fm.py`` holds the wire both
    ways against the reference)."""
    srv = serve_forever(uri, PSServer(), secret=None)
    try:
        kv = AsyncPSKVStore(root_uri=uri, secret=None)
        table = np.arange(20, dtype=np.float32).reshape(10, 2)
        kv.init("emb", nd.array(table))
        out = nd.zeros((10, 2))
        kv.row_sparse_pull("emb", out=out, row_ids=[1, 7])
        want = np.zeros((10, 2), np.float32)
        want[[1, 7]] = table[[1, 7]]
        np.testing.assert_array_equal(out.asnumpy(), want)
        kind, rows, ids = kv._rpc("row_sparse_pull", "emb", np.array([1]))
        assert kind == "rows" and ids.tolist() == [1]
        np.testing.assert_array_equal(np.asarray(rows), table[[1]])
        kv.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_error_surfaces_at_sync_point():
    kv = AsyncPSKVStore()
    kv.init("a", nd.ones((2,)))
    kv.push("a", nd.ones((2,)))
    kv._enqueue("push", "nope", ("dense", np.ones((2,))))  # uninitialized
    with pytest.raises(tmx.MXNetError, match="not initialized"):
        kv.wait_all()
    kv.close()


def _dense_step_weights(kvname, **kw):
    from mxnet_tpu_torch import autograd, gluon

    tmx.random.seed(7)
    net = gluon.nn.Dense(3, in_units=5)
    net.initialize(tmx.init.Xavier())
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9},
                            kvstore=kvname, **kw)
    x = nd.array(np.random.RandomState(0).randn(2, 5).astype(np.float32))
    for _ in range(3):
        with autograd.record():
            loss = (net(x) ** 2).mean()
        loss.backward()
        trainer.step(2)
    return net.weight.data().asnumpy(), trainer


def test_trainer_dist_async_matches_local():
    """One worker: dist_async (server-side SGD with momentum) gives the
    weights of local training."""
    want, _ = _dense_step_weights(None)
    got, trainer = _dense_step_weights("dist_async")
    assert trainer._update_on_kvstore
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    trainer._kvstore.close()


def test_trainer_dist_async_rejects_client_update():
    from mxnet_tpu_torch import gluon

    net = gluon.nn.Dense(2, in_units=4)
    net.initialize(tmx.init.Xavier())
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            kvstore="dist_async", update_on_kvstore=False)
    with pytest.raises(tmx.MXNetError, match="update_on_kvstore=True"):
        trainer._init_kvstore()


def test_trainer_fm_style_sparse_training():
    """An embedding-like weight trained by push/pull through the store
    (the reference's BASELINE config 4 shape)."""
    rs = np.random.RandomState(0)
    kv = tmx.kv.create("dist_async")
    kv.init("w", nd.array(rs.randn(6, 3).astype(np.float32)))
    kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1))
    before = None
    for _ in range(5):
        kv.push("w", nd.array(rs.randn(6, 3).astype(np.float32)))
        out = nd.zeros((6, 3))
        kv.pull("w", out=out)
        if before is not None:
            assert not np.allclose(before, out.asnumpy())
        before = out.asnumpy()
    kv.close()


# --- the wire's security contract -------------------------------------------

def test_tcp_unsigned_set_optimizer_refused(monkeypatch, uri):
    """Without MXT_PS_SECRET a remote set_optimizer (the one pickled
    payload) is refused; the data commands still run."""
    monkeypatch.delenv("MXT_PS_SECRET", raising=False)
    srv = serve_forever(uri, PSServer())
    try:
        kv = AsyncPSKVStore(root_uri=uri)
        kv.init("k", nd.ones((4,)))
        out = nd.zeros((4,))
        kv.pull("k", out=out)
        _close(out.asnumpy(), np.ones((4,)))
        with pytest.raises(tmx.MXNetError, match="MXT_PS_SECRET"):
            kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1))
        kv.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_tcp_signature_mismatch_rejected(uri):
    """A worker with the wrong secret fails the challenge and completes
    no round trip."""
    srv = serve_forever(uri, PSServer(), secret="server-secret")
    try:
        kv = AsyncPSKVStore(root_uri=uri, secret="worker-secret")
        with pytest.raises((ConnectionError, OSError, tmx.MXNetError)):
            kv.init("k", nd.ones((4,)))
        kv._sock.close()  # the server dropped it: no bye
        kv._local, kv._sock = PSServer(), None
        kv.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_tcp_hparam_resync(ps_secret, uri):
    """set_optimizer_hparams refreshes lr on the server and keeps its
    optimizer state."""
    srv = serve_forever(uri, PSServer())
    try:
        kv = AsyncPSKVStore(root_uri=uri)
        kv.init("w", nd.ones((4,)) * 10.0)
        kv.set_optimizer(tmx.optimizer.SGD(learning_rate=1.0))
        kv.push("w", nd.ones((4,)))          # 10 - 1*1 = 9
        kv.set_optimizer_hparams(lr=0.5)
        kv.push("w", nd.ones((4,)))          # 9 - 0.5*1 = 8.5
        out = nd.zeros((4,))
        kv.pull("w", out=out)
        _close(out.asnumpy(), np.full((4,), 8.5))
        kv.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_trainer_hparam_change_propagates_to_ps():
    """Trainer.set_learning_rate reaches the (embedded) server before the
    next update."""
    from mxnet_tpu_torch import autograd, gluon

    net = gluon.nn.Dense(1, use_bias=False, in_units=2)
    net.initialize(tmx.init.Constant(0.0))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.0}, kvstore="dist_async")
    x = nd.ones((2, 2))
    for lr in (None, 0.5):
        if lr is not None:
            trainer.set_learning_rate(lr)  # must reach the server
        with autograd.record():
            loss = net(x).sum()
        loss.backward()
        trainer.step(2)
        if lr is None:
            w0 = net.weight.data().asnumpy().copy()
            _close(w0, np.zeros_like(w0))  # lr=0 did nothing
    assert not np.allclose(net.weight.data().asnumpy(), w0)
    trainer._kvstore.close()


def test_tcp_secretless_client_rejected_at_connect(uri):
    srv = serve_forever(uri, PSServer(), secret="server-secret")
    try:
        with pytest.raises(tmx.MXNetError, match="MXT_PS_SECRET"):
            AsyncPSKVStore(root_uri=uri, secret=None)
    finally:
        srv.shutdown()
        srv.server_close()


def test_frame_signature_binds_nonce_and_sequence():
    secret, nonce = b"s3cret", b"n" * 16
    frame = tda._pack_frame(("push", "k"), secret, nonce, b"C", 5)
    payload = frame[8:]
    msg, signed = tda._unpack_frame(payload, secret, nonce, b"C", 5)
    assert signed and msg[0] == "push"
    for bad in [(secret, b"m" * 16, b"C", 5),   # another connection
                (secret, nonce, b"S", 5),        # reflected
                (secret, nonce, b"C", 6)]:       # replayed later
        with pytest.raises(tmx.MXNetError, match="signature mismatch"):
            tda._unpack_frame(payload, *bad)


def test_secret_worker_rejects_unauthenticated_server(uri):
    srv = serve_forever(uri, PSServer(), secret=None)
    try:
        with pytest.raises(tmx.MXNetError, match="UNAUTHENTICATED"):
            AsyncPSKVStore(root_uri=uri, secret="worker-secret")
    finally:
        srv.shutdown()
        srv.server_close()


# --- fault injection (the reference's two dist_async cases) -----------------

def test_dist_async_worker_killed_mid_push_server_survives(monkeypatch,
                                                           uri):
    """A worker dies mid-push and leaves a truncated frame: the server
    drops the partial frame and the connection, keeps every completed
    push and serves the other worker."""
    monkeypatch.setenv("MXT_PS_SECRET", "fault-test-secret")
    srv = serve_forever(uri, PSServer())
    try:
        w0 = AsyncPSKVStore(root_uri=uri, rank=0, num_workers=2)
        w1 = AsyncPSKVStore(root_uri=uri, rank=1, num_workers=2)
        w0.init("k", nd.zeros((16,)))
        w0.set_optimizer(tmx.optimizer.SGD(learning_rate=-1.0))
        for _ in range(5):
            w0.push("k", nd.ones((16,)))
        w0.wait_all()
        sock = w0._chan._sock
        sock.sendall(struct.pack("<Q", 1 << 20))
        sock.sendall(b"\x00" * 100)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))  # RST, no FIN
        sock.close()
        time.sleep(0.3)
        w1.push("k", nd.ones((16,)))
        w1.wait_all()
        out = nd.zeros((16,))
        w1.pull("k", out=out)
        _close(out.asnumpy(), np.full((16,), 6.0))
        w1.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_dist_async_server_survives_garbage_frames(monkeypatch, uri):
    """Raw connections feeding junk (random bytes, huge length prefixes,
    plausible lengths with garbage bodies) are each dropped; the server
    stays up and an authenticated worker is unaffected."""
    monkeypatch.setenv("MXT_PS_SECRET", "fuzz-test-secret")
    srv = serve_forever(uri, PSServer())
    host, port = uri.rsplit(":", 1)
    try:
        w = AsyncPSKVStore(root_uri=uri, rank=0, num_workers=1)
        w.init("k", nd.zeros((8,)))
        rng = np.random.RandomState(0)
        for i in range(12):
            s = socket.socket()
            s.settimeout(5)
            s.connect((host, int(port)))
            try:
                if i % 3 == 0:
                    s.sendall(rng.bytes(64))
                elif i % 3 == 1:
                    s.sendall(struct.pack("<Q", 1 << 40))
                else:
                    s.sendall(struct.pack("<Q", 128) + rng.bytes(128))
            except OSError:
                pass  # the server may reset mid-send
            s.close()
        time.sleep(0.3)
        out = nd.zeros((8,))
        w.pull("k", out=out)
        _close(out.asnumpy(), np.zeros(8))
        w.push("k", nd.ones((8,)))
        w.pull("k", out=out)
        _close(out.asnumpy(), np.ones(8))
        w.close()
    finally:
        srv.shutdown()
        srv.server_close()


# --- the wire across the two packages ---------------------------------------

def _values(dtype):
    rs = np.random.RandomState(3)
    return [rs.randn(5, 7).astype(np.float32) for _ in range(3)], dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_worker_talks_to_the_reference_server(monkeypatch, uri, dtype):
    """init, pushes and pulls of a port worker through the JAX package's
    server, signed with the secret: the stored values come back exact."""
    monkeypatch.setenv("MXT_PS_SECRET", "cross-package-secret")
    srv = jda.serve_forever(uri, jda.PSServer())
    try:
        kv = AsyncPSKVStore(root_uri=uri)
        vals, _ = _values(dtype)
        tvals = [torch.from_numpy(v).to(getattr(torch, dtype))
                 for v in vals]
        kv.init("w", nd.array(tvals[0]))
        out = nd.zeros((5, 7), dtype=dtype)
        kv.pull("w", out=out)
        assert torch.equal(out._data, tvals[0])
        for t in tvals[1:]:
            kv.push("w", nd.array(t))  # no updater: replaces
        kv.pull("w", out=out)
        assert out.dtype == getattr(torch, dtype)
        assert torch.equal(out._data, tvals[-1])
        stored = srv.ps._store["w"].asnumpy()
        assert str(stored.dtype) == dtype
        np.testing.assert_array_equal(stored.astype(np.float32),
                                      tvals[-1].float().numpy())
        kv.close()
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_worker_talks_to_the_port_server(monkeypatch, uri,
                                                   dtype):
    """The JAX package's worker through the port's server, signed: its
    pushes land in the port's table (tensors of the same dtype on the
    server's device, the CPU here) and its pulls return them exact."""
    monkeypatch.setenv("MXT_PS_SECRET", "cross-package-secret")
    srv = serve_forever(uri, PSServer())
    try:
        kv = jda.AsyncPSKVStore(root_uri=uri)
        vals, _ = _values(dtype)
        jvals = [jmx.nd.array(v).astype(dtype) for v in vals]
        kv.init("w", jvals[0])
        for v in jvals[1:]:
            kv.push("w", v)
        kv.wait_all()
        stored = srv.ps._store["w"]._data
        assert stored.dtype == getattr(torch, dtype)
        assert stored.device.type == "cpu"
        want = jvals[-1].asnumpy().astype(np.float32)
        np.testing.assert_array_equal(stored.float().numpy(), want)
        out = jmx.nd.zeros((5, 7)).astype(dtype)
        kv.pull("w", out=out)
        np.testing.assert_array_equal(out.asnumpy().astype(np.float32),
                                      want)
        kv.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_frames_are_byte_for_byte_the_reference_s():
    """The same message packs to the same bytes in both packages, f32 and
    bf16 arrays included, signed and unsigned; each unpacks the other's."""
    import ml_dtypes

    a32 = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    a16 = a32.astype(ml_dtypes.bfloat16)
    t16 = torch.from_numpy(a32).bfloat16()
    for secret in (None, b"k"):
        ref = jda._pack_frame(("push", "k", ("dense", a32), ("x", a16)),
                              secret, b"n" * 16, b"C", 3)
        got = tda._pack_frame(("push", "k", ("dense", torch.from_numpy(
            a32)), ("x", t16)), secret, b"n" * 16, b"C", 3)
        assert got == ref
        msg, _ = tda._unpack_frame(ref[8:], secret, b"n" * 16, b"C", 3)
        assert torch.equal(msg[3][1], t16)
        back, _ = jda._unpack_frame(got[8:], secret, b"n" * 16, b"C", 3)
        np.testing.assert_array_equal(back[3][1], a16)

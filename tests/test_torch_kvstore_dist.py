"""Gradient compression, the synchronous store and SyncBatchNorm of the
port against the JAX package.

Compression runs here in one process against the reference's
``GradientCompression`` (the decompressed values exact, the residuals
within 1e-6, the same wire size), as the reference's
``tests/test_gradient_compression.py`` does.  The distributed cases run
on one gloo group of two ranks (``mxnet_tpu_torch.launch.run``), each
rank with its own half of a global batch:

  * ``SyncBatchNorm`` forward and backward, on plain per-rank batches and
    over a ``{'dp': 2}`` mesh, against ``BatchNorm`` on the global batch
    and the reference's block on it;
  * the store's eager surface (``init``/``broadcast`` take rank 0's
    value, ``push`` sums the ranks');
  * a classic data-parallel ``Trainer(kvstore='dist_sync')`` step (each
    rank its own batch) against one device on the global batch, with and
    without compression.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import spawn  # noqa: E402

C = 3
XB = np.random.RandomState(0).randn(8, C, 4, 4).astype(np.float32)
DY = np.random.RandomState(1).randn(8, C, 4, 4).astype(np.float32)
GAMMA = np.array([1.5, 0.5, -1.0], np.float32)
BETA = np.array([0.1, -0.2, 0.3], np.float32)
XL = np.random.RandomState(2).randn(16, 4).astype(np.float32)
WL = np.array([[0.8, -0.6, 0.5, 0.7]], np.float32)


def _pair():
    from mxnet_tpu.kvstore import gradient_compression as jgc
    from mxnet_tpu_torch.kvstore import gradient_compression as tgc

    return jgc, tgc


def _nd(pkg, a):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    return jmx.nd.array(a) if pkg == "j" else tmx.nd.array(a,
                                                           ctx=tmx.cpu())


def test_compress_decompress_values():
    jgc, tgc = _pair()
    g = np.array([0.6, -0.7, 0.1, 0.0, -0.2, 1.5], np.float32)
    res = []
    for tag, gc in (("j", jgc), ("t", tgc)):
        comp = gc.GradientCompression(threshold=0.5)
        packed, r = comp.compress(_nd(tag, g))
        out = comp.decompress(packed, (6,)).asnumpy()
        res.append((packed.asnumpy().astype(np.uint32), out, r.asnumpy()))
    np.testing.assert_array_equal(res[1][0], res[0][0])  # the same words
    np.testing.assert_array_equal(res[1][1], res[0][1])
    np.testing.assert_allclose(res[1][1], [0.5, -0.5, 0, 0, 0, 0.5])
    np.testing.assert_allclose(res[1][2], res[0][2], atol=1e-6)


def test_error_feedback_accumulates():
    jgc, tgc = _pair()
    outs = []
    for tag, gc in (("j", jgc), ("t", tgc)):
        comp = gc.GradientCompression(threshold=0.5)
        g = _nd(tag, np.array([0.3, -0.45, 0.2], np.float32))
        o1, r = comp.roundtrip(g)
        o2, r = comp.roundtrip(g, r)
        o3, r = comp.roundtrip(g, r)
        outs.append([o1.asnumpy(), o2.asnumpy(), o3.asnumpy(),
                     r.asnumpy()])
    for a, b in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(outs[1][3], outs[0][3], atol=1e-6)
    assert outs[1][1][0] == 0.5  # the residual pushed it over


@pytest.mark.parametrize("n", [1024, 1000, 17])
def test_wire_size_16x(n):
    jgc, tgc = _pair()
    g = np.random.RandomState(n).uniform(-1, 1, n).astype(np.float32)
    jp, _ = jgc.GradientCompression().compress(_nd("j", g))
    tp, _ = tgc.GradientCompression().compress(_nd("t", g))
    assert tp.shape == jp.shape == ((n + 15) // 16,)
    assert tgc.GradientCompression().compressed_size(n) == (n + 15) // 16
    np.testing.assert_array_equal(tp.asnumpy().astype(np.uint32),
                                  jp.asnumpy())


def test_kvstore_compressed_push():
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    got = []
    for tag, mx in (("j", jmx), ("t", tmx)):
        kv = mx.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(3, _nd(tag, np.zeros(4, np.float32)))
        out = _nd(tag, np.zeros(4, np.float32))
        kv.push(3, _nd(tag, np.array([1.0, -1.0, 0.2, 0.0], np.float32)))
        kv.pull(3, out=out)
        first = out.asnumpy()
        kv.push(3, _nd(tag, np.array([0.0, 0.0, 0.2, 0.0], np.float32)))
        kv.pull(3, out=out)
        got.append((first, out.asnumpy()))
    for a, b in zip(*got):
        np.testing.assert_array_equal(b, a)


def test_trainer_with_compression_converges():
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import autograd

    net = tmx.gluon.nn.Dense(1, in_units=4)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    trainer = tmx.gluon.Trainer(
        net.collect_params(), "sgd", {"learning_rate": 0.2},
        compression_params={"type": "2bit", "threshold": 0.1})
    x = tmx.nd.array(np.random.RandomState(3).uniform(-1, 1, (64, 4))
                     .astype(np.float32), ctx=tmx.cpu())
    y = tmx.nd.dot(x, tmx.nd.array(WL, ctx=tmx.cpu()).T)
    first, best = None, float("inf")
    for _ in range(100):
        with autograd.record():
            loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        trainer.step(1)
        cur = float(loss.asscalar())
        first = cur if first is None else first
        best = min(best, cur)
    assert best < first * 0.1


def test_bad_params_rejected():
    import mxnet_tpu_torch as tmx

    _, tgc = _pair()
    for params in ({"type": "1bit"}, {"type": "2bit", "bogus": 1},
                   {"threshold": 0.5}):
        with pytest.raises(tmx.MXNetError):
            tgc.create(params)
    with pytest.raises(tmx.MXNetError):
        tgc.GradientCompression(threshold=-1)
    assert tgc.create({}) is None


# --------------------------------------------------------------------------
# two ranks
# --------------------------------------------------------------------------

def _worker(tmp):
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import autograd, gluon, nd, parallel

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)
    r = parallel.rank()
    out = {}
    rows = slice(4 * r, 4 * (r + 1))

    def bn_block():
        bn = gluon.nn.SyncBatchNorm(in_channels=C, momentum=0.8)
        bn.initialize(ctx=cpu)
        bn.gamma.set_data(GAMMA)
        bn.beta.set_data(BETA)
        return bn

    # SyncBatchNorm on each rank's own half (plain tensors)
    bn = bn_block()
    x = nd.array(XB[rows], ctx=cpu)
    x.attach_grad()
    with autograd.record():
        y = bn(x)
    y.backward(nd.array(DY[rows], ctx=cpu))
    out["plain.y"], out["plain.dx"] = y.asnumpy(), x.grad.asnumpy()
    out["plain.dgamma"] = bn.gamma.grad().asnumpy()
    out["plain.dbeta"] = bn.beta.grad().asnumpy()
    out["plain.mean"] = bn.running_mean.data().asnumpy()
    out["plain.var"] = bn.running_var.data().asnumpy()

    # over a {'dp': 2} mesh: one global batch, dp-sharded
    mesh = parallel.make_mesh({"dp": 2})
    bn = bn_block()
    parallel.replicate_block_params(bn, mesh)
    x = parallel.shard_batch(nd.array(XB, ctx=cpu), mesh)
    x.attach_grad()
    with autograd.record():
        y = bn(x)
    y.backward(parallel.shard_batch(nd.array(DY, ctx=cpu), mesh))
    out["mesh.y"], out["mesh.dx"] = y.asnumpy(), x.grad.asnumpy()
    out["mesh.dgamma"] = bn.gamma.grad().asnumpy()
    out["mesh.dbeta"] = bn.beta.grad().asnumpy()
    out["mesh.mean"] = bn.running_mean.data().asnumpy()

    # the store's eager surface
    kv = tmx.kv.create("dist_tpu_sync")
    mine = nd.array(np.full(3, 10.0 * (r + 1), np.float32), ctx=cpu)
    got = nd.zeros((3,), ctx=cpu)
    kv.broadcast("w", mine, out=got)
    out["kv.broadcast"] = got.asnumpy()
    kv.push("w", mine)
    kv.pull("w", out=got)
    out["kv.push_sum"] = got.asnumpy()
    out["kv.workers"] = kv.num_workers
    out["kv.rank"] = kv.rank

    # classic data parallelism: each rank its own rows, summed in the store
    for mode, comp in (("dp", None), ("dp_2bit", {"type": "2bit",
                                                   "threshold": 0.05})):
        net = gluon.nn.Dense(1, in_units=4)
        net.initialize(ctx=cpu)
        net.weight.set_data(np.array([[0.1, 0.2, -0.1, 0.3]], np.float32))
        net.bias.set_data(np.zeros(1, np.float32))
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore="dist_sync",
                           compression_params=comp)
        xs = nd.array(XL[8 * r:8 * (r + 1)], ctx=cpu)
        ys = nd.dot(xs, nd.array(WL, ctx=cpu).T)
        for _ in range(3):
            with autograd.record():
                loss = ((net(xs) - ys) ** 2).sum()
            loss.backward()
            tr.step(16)
        out[mode + ".w"] = net.weight.data().asnumpy()
        out[mode + ".b"] = net.bias.data().asnumpy()
    parallel.set_mesh(None)
    np.savez(tmp / f"rank{r}.npz", **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(2, tmp_path_factory.mktemp("kvdist"), __file__,
                 background=True)


@pytest.fixture(scope="module")
def bn_ref():
    """BatchNorm on the global batch: the port's (one process) and the
    reference's ``SyncBatchNorm`` block (one process: plain BatchNorm
    statistics over the whole batch)."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    res = {}
    for tag, mx, cls in (("t", tmx, "BatchNorm"), ("j", jmx,
                                                   "SyncBatchNorm")):
        kw = {"ctx": mx.cpu()} if tag == "t" else {}
        bn = getattr(mx.gluon.nn, cls)(in_channels=C, momentum=0.8)
        bn.initialize(**kw)
        bn.gamma.set_data(mx.nd.array(GAMMA, **kw))
        bn.beta.set_data(mx.nd.array(BETA, **kw))
        x = mx.nd.array(XB, **kw)
        x.attach_grad()
        with mx.autograd.record():
            y = bn(x)
        y.backward(mx.nd.array(DY, **kw))
        res[tag] = {"y": y.asnumpy(), "dx": x.grad.asnumpy(),
                    "dgamma": bn.gamma.grad().asnumpy(),
                    "dbeta": bn.beta.grad().asnumpy(),
                    "mean": bn.running_mean.data().asnumpy(),
                    "var": bn.running_var.data().asnumpy()}
    return res


@pytest.mark.parametrize("route", ["plain", "mesh"])
def test_sync_batch_norm_matches_batch_norm_on_the_global_batch(
        ranks, bn_ref, route):
    outs = ranks.result()
    for want in (bn_ref["t"], bn_ref["j"]):
        if route == "plain":  # each rank holds its half
            y = np.concatenate([o["plain.y"] for o in outs])
            dx = np.concatenate([o["plain.dx"] for o in outs])
            dgamma = sum(o["plain.dgamma"] for o in outs)
            dbeta = sum(o["plain.dbeta"] for o in outs)
        else:  # every rank sees the global arrays
            y, dx = outs[0]["mesh.y"], outs[0]["mesh.dx"]
            dgamma, dbeta = outs[0]["mesh.dgamma"], outs[0]["mesh.dbeta"]
        np.testing.assert_allclose(y, want["y"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dx, want["dx"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(dgamma, want["dgamma"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(dbeta, want["dbeta"], rtol=1e-4,
                                   atol=1e-4)
        for o in outs:
            np.testing.assert_allclose(o[route + ".mean"], want["mean"],
                                       rtol=1e-5, atol=1e-6)
    for o in outs:
        np.testing.assert_allclose(o["plain.var"], bn_ref["t"]["var"],
                                   rtol=1e-5, atol=1e-6)


def test_store_init_broadcasts_rank0_and_push_sums(ranks):
    for r, o in enumerate(ranks.result()):
        np.testing.assert_array_equal(o["kv.broadcast"], [10.0] * 3)
        np.testing.assert_array_equal(o["kv.push_sum"], [30.0] * 3)
        assert int(o["kv.workers"]) == 2 and int(o["kv.rank"]) == r


@pytest.mark.parametrize("mode", ["dp", "dp_2bit"])
def test_classic_data_parallel_step_matches_one_device(ranks, mode):
    """Three steps of each rank on its own rows, the store summing their
    gradients: one device on the global batch (its own gradient
    compressed by the same rule when compression is on)."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.kvstore import gradient_compression as tgc

    cpu = tmx.cpu()
    w = np.array([[0.1, 0.2, -0.1, 0.3]], np.float32)
    b = np.zeros(1, np.float32)
    comp = tgc.GradientCompression(threshold=0.05) if mode != "dp" else None
    res = [{}, {}]
    for _ in range(3):
        grads = []
        for r in range(2):
            net = gluon.nn.Dense(1, in_units=4)
            net.initialize(ctx=cpu)
            net.weight.set_data(w)
            net.bias.set_data(b)
            xs = nd.array(XL[8 * r:8 * (r + 1)], ctx=cpu)
            ys = nd.dot(xs, nd.array(WL, ctx=cpu).T)
            with autograd.record():
                loss = ((net(xs) - ys) ** 2).sum()
            loss.backward()
            gs = [net.weight.grad(), net.bias.grad()]
            if comp is not None:
                for i, g in enumerate(gs):
                    gs[i], res[r][i] = comp.roundtrip(g, res[r].get(i))
            grads.append([g.asnumpy() for g in gs])
        w = w - 0.1 / 16 * (grads[0][0] + grads[1][0])
        b = b - 0.1 / 16 * (grads[0][1] + grads[1][1])
    for o in ranks.result():
        np.testing.assert_allclose(o[mode + ".w"], w, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o[mode + ".b"], b, rtol=1e-5, atol=1e-6)


if __name__ == "__main__":
    _worker(sys.argv[1])

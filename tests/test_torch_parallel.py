"""The port's distributed layer on two ranks (gloo on the CPU) against the
JAX package on its 8-device virtual mesh (``tests/conftest.py``).

One group of two ranks runs every check of this file in one launch
(``mxnet_tpu_torch.launch.run``: a free port, a timeout on the
group's collectives and on the ranks, peers killed when one fails); each
rank writes its results to an ``.npz`` that the tests below read.  The
ranks import no JAX: the reference side runs here, in the pytest
process.  The cases follow the reference's ``tests/test_parallel.py``:
mesh shapes, ``shard_batch``, ``split_and_load``, data-parallel gradients
and training against single-device, the ``dist_tpu_sync``/``dist_sync``
Trainer step and ``update_on_kvstore=True``.
"""
import os
import sys
import warnings

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
X = np.random.RandomState(0).rand(16, 8).astype(np.float32)
Y_CLS = np.random.RandomState(1).randint(0, 4, (16,)).astype(np.float32)
Y_REG = (X @ np.random.RandomState(3).rand(8, 4)).astype(np.float32)


def spawn(n, tmp, worker_file, timeout=150, background=False):
    """Run ``worker_file`` as ranks 0..n-1 of one gloo group and return
    each rank's ``.npz`` results; a failing rank fails the test with the
    ranks' stderr.  ``background=True`` returns at once with a future of
    the results (the reference side can run meanwhile)."""
    from mxnet_tpu_torch import launch

    if background:
        import concurrent.futures

        pool = concurrent.futures.ThreadPoolExecutor(1)
        fut = pool.submit(spawn, n, tmp, worker_file, timeout)
        pool.shutdown(wait=False)
        return fut

    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONFAULTHANDLER="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    codes = launch.run(n, [sys.executable, os.path.abspath(__file__),
                           "--rank-of", worker_file, str(tmp)],
                       timeout=timeout, group_timeout=60, env=env,
                       stderr=str(tmp / "err{rank}.txt"),
                       stdout=str(tmp / "out{rank}.txt"), cwd=ROOT)
    if any(codes):
        logs = "\n".join(
            f"--- rank {r} (exit {c}) ---\n" +
            (tmp / f"err{r}.txt").read_text()[-3000:]
            for r, c in enumerate(codes))
        raise AssertionError(f"ranks failed: {codes}\n{logs}")
    return [dict(np.load(tmp / f"rank{r}.npz", allow_pickle=True))
            for r in range(n)]


# --------------------------------------------------------------------------
# the ranks (no JAX)
# --------------------------------------------------------------------------

def _port_mlp(tmx, weights):
    from mxnet_tpu_torch.convert import load_numpy_params

    nn = tmx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8),
            nn.Dense(4, in_units=16))
    load_numpy_params(net, weights, ctx=tmx.cpu())
    return net


def _worker(tmp):
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import autograd, gluon, nd, parallel
    from mxnet_tpu_torch.parallel.local import local

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    w = dict(np.load(tmp / "weights.npz"))
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)
    r = parallel.rank()
    out = {"world": parallel.world_size(), "initialized":
           parallel.is_initialized()}

    # mesh shapes and layouts
    mesh = parallel.make_mesh({"dp": 2})
    out["mesh_axes"] = str(parallel.mesh_axes(mesh))
    out["default_axes"] = str(parallel.mesh_axes(parallel.make_mesh()))
    out["mesh_2d"] = str(parallel.mesh_axes(
        parallel.make_mesh({"dp": 1, "tp": 2})))
    try:
        parallel.make_mesh({"dp": 4})
        out["too_big"] = "no error"
    except tmx.MXNetError as e:
        out["too_big"] = str(e)
    parallel.set_mesh(mesh)
    xs = parallel.shard_batch(nd.array(X, ctx=cpu))
    out["shard_shape"] = np.array(xs.shape)
    out["shard_local"] = np.array(xs._data.to_local().shape)
    out["shard_rows"] = xs._data.to_local().numpy()
    out["with_sharding"] = str(parallel.with_sharding(
        torch.from_numpy(X), ("dp", None), mesh).placements)
    out["replicate"] = str(parallel.replicate(
        nd.array(X, ctx=cpu), mesh)._data.placements)
    out["global_devices"] = tmx.context.global_num_devices()
    out["hostvec_sum"] = parallel.process_sum_hostvec(
        np.array([1.0, r + 1.0]))
    out["hostvec_gather"] = parallel.process_gather_hostvec(
        np.array([r, 10.0 * r]))
    parts = gluon.utils.split_and_load(nd.array(X, ctx=cpu), [cpu, cpu])
    out["split_n"] = len(parts)
    out["split_shape"] = np.array(parts[0].shape)

    # data-parallel gradients == single-device gradients
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    net = _port_mlp(tmx, w)
    parallel.replicate_block_params(net)
    ys = parallel.shard_batch(nd.array(Y_CLS, ctx=cpu))
    with autograd.record():
        loss = loss_fn(net(xs), ys).sum()
    loss.backward()
    out["dp_loss"] = loss.asnumpy()
    for k, p in net._collect_params_with_prefix().items():
        out["dp_grad." + k] = p.grad().asnumpy()

    # the dist_tpu_sync Trainer step (12 steps)
    net = _port_mlp(tmx, w)
    parallel.replicate_block_params(net)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore="dist_tpu_sync")
    losses = []
    for _ in range(12):
        with autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        tr.step(16)
        losses.append(float(loss.mean().asscalar()))
    out["sync_losses"] = np.array(losses)
    out["sync_type"] = tr._kvstore.type
    out["sync_devices"] = tr._kvstore.num_devices
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        kv = tmx.kv.create("dist_sync")
    out["alias_warned"] = any(issubclass(x.category, UserWarning)
                              for x in rec)
    out["alias_type"] = kv.type

    # clip_global_norm on the backward's partial sums sees the summed
    # gradients
    net = _port_mlp(tmx, w)
    parallel.replicate_block_params(net)
    with autograd.record():
        loss = loss_fn(net(xs), ys).sum()
    loss.backward()
    grads = [p.grad() for p in net.collect_params().values()]
    out["partial"] = str(grads[0]._data.placements)
    out["clip_norm"] = gluon.utils.clip_global_norm(grads, 1.0)
    out["clip_after"] = float(np.sqrt(sum(
        (g.asnumpy().astype(np.float64) ** 2).sum() for g in grads)))

    # replicated parameters start bitwise equal: rank 0's values
    wr = {k: v * (r + 1) for k, v in w.items()}
    net = _port_mlp(tmx, wr)
    gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                  mesh=mesh)
    for k, p in net._collect_params_with_prefix().items():
        out["placed." + k] = p.data()._data.to_local().detach().numpy()

    # graphs over a mesh refuse, naming their list
    net = _port_mlp(tmx, w)
    net.hybridize()
    parallel.replicate_block_params(net)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore="dist_sync")
    def recorded():
        with autograd.record():
            return net(xs)

    for what, fn in (
            ("hybridize", lambda: net(xs)),
            ("hybridize_recorded", recorded),
            ("fused", lambda: gluon.FusedTrainStep(
                net, tr, lambda x, y: loss_fn(net(x), y)))):
        try:
            fn()
            out["refused." + what] = ""
        except tmx.MXNetError as e:
            out["refused." + what] = str(e)
    net.hybridize(False)

    # the data plane over the mesh: each rank copies its own rows
    from mxnet_tpu_torch import data as tdata, recordio

    pf = tdata.DevicePrefetcher(iter([X[:8], X[8:]]), mesh=mesh, ctx=cpu)
    got = [pf.get(timeout=30) for _ in range(2)]
    pf.close()
    out["pf.shape"] = np.array(got[0].shape)
    out["pf.local"] = np.stack([g._data.to_local().numpy() for g in got])
    shards = tmp / f"shards{r}"
    shards.mkdir()
    for sh in range(2):
        rec = recordio.MXIndexedRecordIO(str(shards / f"part{sh}.idx"),
                                         str(shards / f"part{sh}.rec"), "w")
        for i in range(16):
            rec.write_idx(i, np.full(5, sh * 16 + i, np.float32).tobytes())
        rec.close()

    def decode(b):
        return np.frombuffer(b, dtype=np.float32)

    for key, kw in (("sl.mesh", dict(mesh=mesh)),
                    ("sl.rank", dict(world_size=2, rank=r))):
        with tdata.StreamingLoader(
                tdata.ShardedRecordReader(str(shards), 8, seed=3),
                transform=decode, num_workers=0, num_steps=2, ctx=cpu,
                **kw) as loader:
            batches = list(loader)
        out[key + ".shape"] = np.array(batches[0].shape)
        out[key] = np.stack([local(b._data).numpy() for b in batches])

    # dp training tracks single-device training (10 steps, L2), through
    # the store, with no store, and with the update in the store
    l2 = gluon.loss.L2Loss()
    yr = parallel.shard_batch(nd.array(Y_REG, ctx=cpu))
    for mode in ("dist_tpu_sync", "no_store", "update_on_kvstore"):
        net = _port_mlp(tmx, w)
        parallel.replicate_block_params(net)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.05},
                           kvstore=None if mode == "no_store" else
                           "dist_sync",
                           update_on_kvstore=mode == "update_on_kvstore")
        for _ in range(10):
            with autograd.record():
                loss = l2(net(xs), yr)
            loss.backward()
            tr.step(16)
        for k, p in net._collect_params_with_prefix().items():
            out[f"{mode}.{k}"] = p.data().asnumpy()
    parallel.set_mesh(None)
    np.savez(tmp / f"rank{r}.npz", **out)


# --------------------------------------------------------------------------
# the tests (the reference side runs here)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The reference's runs of the same cases: single device, and on its
    8-device mesh."""
    import mxnet_tpu as jmx
    from mxnet_tpu import autograd as jag, gluon as jg, nd as jnd
    from mxnet_tpu import parallel as jpar

    jmx.random.seed(11)
    net = jg.nn.HybridSequential()
    with net.name_scope():
        net.add(jg.nn.Dense(16, activation="relu", in_units=8),
                jg.nn.Dense(4, in_units=16))
    net.initialize(jmx.init.Xavier())
    weights = {k: p.data().asnumpy()
               for k, p in net._collect_params_with_prefix().items()}

    def build():
        n = jg.nn.HybridSequential()
        with n.name_scope():
            n.add(jg.nn.Dense(16, activation="relu", in_units=8),
                  jg.nn.Dense(4, in_units=16))
        n.initialize()
        for k, p in n._collect_params_with_prefix().items():
            p.set_data(jnd.array(weights[k]))
        return n

    out = {"weights": weights}
    loss_fn = jg.loss.SoftmaxCrossEntropyLoss()
    single = build()
    with jag.record():
        loss = loss_fn(single(jnd.array(X)), jnd.array(Y_CLS)).sum()
    loss.backward()
    out["loss"] = float(loss.asscalar())
    out["grads"] = {k: p.grad().asnumpy() for k, p in
                    single._collect_params_with_prefix().items()}
    mesh = jpar.make_mesh({"dp": 8})
    with jpar.mesh_scope(mesh):
        mnet = build()
        jpar.replicate_block_params(mnet)
        xs, ys = jpar.shard_batch(jnd.array(X)), jpar.shard_batch(
            jnd.array(Y_CLS))
        with jag.record():
            loss = loss_fn(mnet(xs), ys).sum()
        loss.backward()
        out["mesh_grads"] = {k: p.grad().asnumpy() for k, p in
                             mnet._collect_params_with_prefix().items()}
        mnet = build()
        jpar.replicate_block_params(mnet)
        tr = jg.Trainer(mnet.collect_params(), "sgd",
                        {"learning_rate": 0.1}, kvstore="dist_tpu_sync")
        losses = []
        for _ in range(12):
            with jag.record():
                loss = loss_fn(mnet(xs), ys)
            loss.backward()
            tr.step(16)
            losses.append(float(loss.mean().asscalar()))
        out["sync_losses"] = np.array(losses)
    l2 = jg.loss.L2Loss()
    for mode in ("single", "update_on_kvstore"):
        n = build()
        tr = jg.Trainer(n.collect_params(), "sgd", {"learning_rate": 0.05},
                        kvstore="device" if mode == "update_on_kvstore"
                        else None,
                        update_on_kvstore=mode == "update_on_kvstore")
        for _ in range(10):
            with jag.record():
                loss = l2(n(jnd.array(X)), jnd.array(Y_REG))
            loss.backward()
            tr.step(16)
        out[mode] = {k: p.data().asnumpy() for k, p in
                     n._collect_params_with_prefix().items()}
    return out


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    np.savez(tmp / "weights.npz", **ref["weights"])
    return spawn(RANKS, tmp, __file__)


def test_make_mesh_shapes(ranks):
    for out in ranks:
        assert out["mesh_axes"] == "{'dp': 2}"
        assert out["default_axes"] == "{'dp': 2}"
        assert out["mesh_2d"] == "{'dp': 1, 'tp': 2}"
        assert "needs 4 devices" in str(out["too_big"])
        assert int(out["world"]) == RANKS and bool(out["initialized"])


def test_placements_and_host_collectives(ranks):
    for out in ranks:
        assert str(out["with_sharding"]) == "(Shard(dim=0),)"
        assert str(out["replicate"]) == "(Replicate(),)"
        assert int(out["global_devices"]) == RANKS
        np.testing.assert_array_equal(out["hostvec_sum"], [2.0, 3.0])
        np.testing.assert_array_equal(out["hostvec_gather"],
                                      [[0.0, 0.0], [1.0, 10.0]])


def test_shard_batch_layout(ranks):
    for r, out in enumerate(ranks):
        assert out["shard_shape"].tolist() == [16, 8]
        assert out["shard_local"].tolist() == [8, 8]
        np.testing.assert_array_equal(out["shard_rows"],
                                      X[8 * r:8 * (r + 1)])


def test_split_and_load_returns_single_sharded(ranks):
    for out in ranks:
        assert int(out["split_n"]) == 1
        assert out["split_shape"].tolist() == [16, 8]


def test_dp_grads_match_single_device(ranks, ref):
    for out in ranks:
        np.testing.assert_allclose(out["dp_loss"], ref["loss"], atol=1e-4)
        for k, g in ref["grads"].items():
            np.testing.assert_allclose(out["dp_grad." + k], g, atol=1e-4,
                                       err_msg=k)
            np.testing.assert_allclose(out["dp_grad." + k],
                                       ref["mesh_grads"][k], atol=1e-4,
                                       err_msg=k)


def test_dist_tpu_sync_trainer_step(ranks, ref):
    for out in ranks:
        losses = out["sync_losses"]
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, ref["sync_losses"], atol=1e-4)
        assert str(out["sync_type"]) == "dist_tpu_sync"
        assert int(out["sync_devices"]) == RANKS


def test_dist_sync_alias_warns(ranks):
    for out in ranks:
        assert bool(out["alias_warned"])
        assert str(out["alias_type"]) == "dist_tpu_sync"


@pytest.mark.parametrize("mode", ["dist_tpu_sync", "no_store",
                                  "update_on_kvstore"])
def test_dp_training_converges_same_as_single(ranks, ref, mode):
    """10 steps each way; the weights track the reference's single-device
    run (and, with the update in the store, the reference's own
    ``update_on_kvstore=True`` run).  With no store the Trainer itself
    sums the partial gradients before the update."""
    want = ref["update_on_kvstore" if mode == "update_on_kvstore"
               else "single"]
    for out in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(out[f"{mode}.{k}"], v, atol=1e-3,
                                       err_msg=k)
            np.testing.assert_allclose(out[f"{mode}.{k}"],
                                       ref["single"][k], atol=1e-3,
                                       err_msg=k)


def test_clip_global_norm_sees_the_summed_gradients(ranks, ref):
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in ref["grads"].values())))
    for out in ranks:
        assert "Partial" in str(out["partial"])
        np.testing.assert_allclose(float(out["clip_norm"]), norm,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(out["clip_after"]),
                                   min(norm, 1.0), rtol=1e-4)


def test_placed_parameters_start_from_rank0_values(ranks, ref):
    """Each rank built its net with other weights (rank + 1 times the
    reference's); the Trainer's placement leaves rank 0's on every
    rank, bitwise."""
    for out in ranks:
        for k, v in ref["weights"].items():
            np.testing.assert_array_equal(out["placed." + k], v)


def test_prefetcher_and_loader_copy_each_ranks_rows(ranks):
    """Under a {'dp': 2} mesh the prefetcher hands out the global batch
    sharded, each rank holding its own rows; the streaming loader's
    rows on each rank are those of the plain loader at world 2 for that
    rank."""
    for r, out in enumerate(ranks):
        assert out["pf.shape"].tolist() == [8, 8]
        np.testing.assert_array_equal(
            out["pf.local"], np.stack([X[4 * r:4 * r + 4],
                                       X[8 + 4 * r:8 + 4 * r + 4]]))
        assert out["sl.mesh.shape"].tolist() == [8, 5]
        assert out["sl.rank.shape"].tolist() == [4, 5]
        np.testing.assert_array_equal(out["sl.mesh"], out["sl.rank"])


def test_graphs_over_a_mesh_raise_naming_their_list(ranks):
    """Ported in slice 12: ``hybridize()`` and ``FusedTrainStep`` over a
    mesh and a ``dist_sync`` store run (no error); their numbers are
    ``tests/test_torch_graph_mesh.py``'s."""
    for out in ranks:
        for what in ("hybridize", "hybridize_recorded", "fused"):
            assert str(out["refused." + what]) == ""


def test_launcher_kills_peers_and_times_out(tmp_path):
    """A rank that fails takes its peers down at once; ranks that hang
    are killed at the wall clock with 124; each rank sees the env."""
    import time

    from mxnet_tpu_torch import launch

    code = ("import os, sys, time; r = int(os.environ['MXT_PROCESS_ID']); "
            "open(sys.argv[1] + '/env%d' % r, 'w').write(' '.join(os.environ"
            "[k] for k in ('MXT_COORDINATOR', 'MXT_NUM_PROCESSES', "
            "'MXT_INIT_TIMEOUT'))); time.sleep(0.5); "
            "sys.exit(3) if r == 1 and sys.argv[2] == 'fail' "
            "else time.sleep(120)")
    for mode, want in (("fail", 3), ("hang", 124)):
        t = time.monotonic()
        codes = launch.run(3, [sys.executable, "-c", code, str(tmp_path),
                               mode], timeout=10, group_timeout=7)
        assert time.monotonic() - t < 30
        assert want in codes and 0 not in codes, codes
    envs = [(tmp_path / f"env{r}").read_text().split() for r in range(3)]
    assert len({e[0] for e in envs}) == 1 and envs[0][0].startswith(
        "127.0.0.1:")
    assert all(e[1:] == ["3", "7"] for e in envs)


def test_multihost_initialize_noop():
    import mxnet_tpu_torch as tmx

    for var in ("MXT_COORDINATOR", "MXT_NUM_PROCESSES", "MXT_PROCESS_ID"):
        assert var not in os.environ
    tmx.parallel.initialize()  # one process: nothing to join
    assert not tmx.parallel.is_initialized()
    assert tmx.parallel.world_size() == 1 and tmx.parallel.rank() == 0


def _run_rank(worker_file, tmp):
    """One rank of ``spawn``: ``worker_file``'s ``_worker``, then a
    barrier and the group's teardown, so that no rank leaves while a peer
    still works and none leaves its group to the interpreter's exit (a
    gloo rank torn down there can abort)."""
    import importlib.util

    import torch

    from mxnet_tpu_torch import parallel

    spec = importlib.util.spec_from_file_location("_spawned_worker",
                                                  worker_file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._worker(tmp)
    if torch.distributed.is_initialized():
        parallel.barrier()
    parallel.shutdown()


if __name__ == "__main__":
    if sys.argv[1] == "--rank-of":
        _run_rank(sys.argv[2], sys.argv[3])
    else:
        _worker(sys.argv[1])

"""The streaming data plane of the PyTorch/CUDA port against the JAX
package: ``ShardedRecordReader`` tables and per-rank draws, the elastic
2→1→2 replay, ``SequencePacker``, ``StreamingLoader`` in sample and
packed modes with resume, and ``DevicePrefetcher`` on the CPU (order,
errors, ``close()``, ``stats()``).  Follows ``tests/test_data_plane.py``.
"""
import os
import threading

import numpy as np
import pytest
import torch

from mxnet_tpu import data as jdata
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import data as tdata
from mxnet_tpu_torch import elastic as telastic
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn

CPU = tmx.cpu()


def _write_shards(d, n_shards=2, per_shard=16, feat=5):
    """Float32 feature shards written by the JAX package (sample i is the
    all-i vector)."""
    for s in range(n_shards):
        rec = jrec.MXIndexedRecordIO(os.path.join(d, f"part{s}.idx"),
                                     os.path.join(d, f"part{s}.rec"), "w")
        for i in range(per_shard):
            rec.write_idx(i, np.full(feat, s * per_shard + i,
                                     np.float32).tobytes())
        rec.close()
    return d


def _decode(b):
    return np.frombuffer(b, dtype=np.float32)


def _docs_shards(d, n=40, seed=0):
    """Token documents of 3..50 tokens, one a record."""
    rng = np.random.RandomState(seed)
    rec = jrec.MXIndexedRecordIO(os.path.join(d, "docs.idx"),
                                 os.path.join(d, "docs.rec"), "w")
    for i in range(n):
        rec.write_idx(i, rng.randint(1, 1000, rng.randint(3, 51))
                      .astype(np.int32).tobytes())
    rec.close()
    return os.path.join(d, "docs.rec")


def _tok(b):
    return np.frombuffer(b, dtype=np.int32)


# --- reader -----------------------------------------------------------------

def test_reader_table_and_draws_match(tmp_path):
    d = _write_shards(str(tmp_path))
    t = tdata.ShardedRecordReader(d, batch_size=8, seed=3)
    j = jdata.ShardedRecordReader(d, batch_size=8, seed=3)
    assert len(t) == len(j) == 32 and t.num_shards == 2
    assert t._table == j._table
    for i in (0, 15, 16, 31):
        assert t.read(i) == j.read(i)
    for step in (0, 1, 9):
        full = t.global_indices_for_step(step)
        np.testing.assert_array_equal(full, j.global_indices_for_step(step))
        for world in (1, 2, 4):
            parts = [t.batch_indices_for_step(step, world, rk)
                     for rk in range(world)]
            for rk in range(world):
                np.testing.assert_array_equal(
                    parts[rk], j.batch_indices_for_step(step, world, rk))
            np.testing.assert_array_equal(np.concatenate(parts), full)
    t.close()
    assert t.read(5) == j.read(5)  # a read after close reopens
    t.close()


def test_reader_errors_name_the_file(tmp_path):
    rec = os.path.join(str(tmp_path), "x.rec")
    open(rec, "wb").close()
    with pytest.raises(MXNetError, match="idx"):
        tdata.ShardedRecordReader(rec, batch_size=4)
    with pytest.raises(MXNetError, match="no .rec shards"):
        tdata.ShardedRecordReader(str(tmp_path / "none*.rec"), batch_size=4)


def test_reader_handles_are_per_thread(tmp_path):
    d = _write_shards(str(tmp_path), n_shards=1, per_shard=64)
    r = tdata.ShardedRecordReader(d, batch_size=4)
    errors = []

    def hammer(offset):
        try:
            for k in range(200):
                i = (offset + 7 * k) % 64
                assert _decode(r.read(i))[0] == i
        except AssertionError as e:
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(o,)) for o in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors and not any(th.is_alive() for th in threads)
    r.close()


# --- packing ----------------------------------------------------------------

def test_packer_matches_exactly():
    rng = np.random.RandomState(7)
    docs = [rng.randint(1, 500, rng.randint(1, 90)) for _ in range(60)]
    for b, t in ((4, 64), (8, 32), (2, 128)):
        tb, ts = tdata.pack_documents(docs, b, t)
        jb, js = jdata.pack_documents(docs, b, t)
        for f in ("tokens", "segment_ids", "labels", "loss_mask"):
            got, ref = getattr(tb, f), getattr(jb, f)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
        assert ts.as_dict() == js.as_dict()
    batch, stats = tdata.pack_documents(
        [np.arange(1, 6), np.arange(1, 10), np.arange(1, 4)], 2, 8)
    np.testing.assert_array_equal(batch.labels[0], [2, 3, 4, 5, 0, 2, 3, 0])
    np.testing.assert_array_equal(batch.loss_mask[0],
                                  [1, 1, 1, 1, 0, 1, 1, 0])
    assert stats.tokens_dropped == 1
    rows = [batch.rows(telastic.shard_rows(2, 2, rk)) for rk in (0, 1)]
    np.testing.assert_array_equal(
        np.concatenate([r.tokens for r in rows]), batch.tokens)


def test_packer_efficiency_on_a_mixed_corpus():
    rng = np.random.RandomState(0)
    docs = [rng.randint(1, 1000, n) for n in rng.randint(8, 200, 400)]
    p = tdata.SequencePacker(8, 256)
    for i in range(0, len(docs), 64):
        p.pack(docs[i:i + 64])
    assert p.stats.efficiency() >= 0.85, p.stats.as_dict()


# --- streaming loader --------------------------------------------------------

def _ref_batches(loader):
    return [b.asnumpy() for b in loader]


@pytest.mark.parametrize("workers", [0, 2])
def test_streaming_loader_sample_mode_matches(tmp_path, workers):
    d = _write_shards(str(tmp_path))
    with jdata.StreamingLoader(jdata.ShardedRecordReader(d, 8, seed=3),
                               transform=_decode, num_workers=0,
                               num_steps=4, world_size=2, rank=1) as jl:
        ref = _ref_batches(jl)
    with tdata.StreamingLoader(tdata.ShardedRecordReader(d, 8, seed=3),
                               transform=_decode, num_workers=workers,
                               num_steps=4, world_size=2, rank=1,
                               ctx=CPU) as tl:
        got = list(tl)
        stats = tl.stats()
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.context == CPU and g.shape == (4, 5)
        np.testing.assert_array_equal(g.asnumpy(), r)
    assert stats["batches"] == 5  # four batches and the end


def test_streaming_loader_resume_is_start_step(tmp_path):
    d = _write_shards(str(tmp_path))

    def run(start, n):
        with tdata.StreamingLoader(tdata.ShardedRecordReader(d, 8, seed=3),
                                   transform=_decode, num_workers=2,
                                   start_step=start, num_steps=n,
                                   world_size=1, rank=0, ctx=CPU) as ld:
            return [b.asnumpy() for b in ld]

    full, tail = run(0, 5), run(2, 3)
    for e, g in zip(full[2:], tail):
        np.testing.assert_array_equal(e, g)


def test_streaming_loader_packed_mode_matches(tmp_path):
    path = _docs_shards(str(tmp_path))

    def run(mod, world, rank, **kw):
        packer = mod.SequencePacker(batch_size=4, seq_len=64)
        with mod.StreamingLoader(mod.ShardedRecordReader(path, 12, seed=5),
                                 packer=packer, tokenize=_tok,
                                 num_steps=3, world_size=world, rank=rank,
                                 **kw) as ld:
            out = [{f: getattr(b, f).asnumpy() for f in
                    ("tokens", "segment_ids", "labels", "loss_mask")}
                   for b in ld]
        return out, packer.stats.as_dict()

    ref, ref_stats = run(jdata, 1, 0, num_workers=0)
    got, stats = run(tdata, 1, 0, num_workers=2, ctx=CPU)
    assert stats == ref_stats and stats["batches"] == 3
    for g, r in zip(got, ref):
        for f in r:
            np.testing.assert_array_equal(g[f], r[f])
    halves = [run(tdata, 2, rk, num_workers=0, ctx=CPU)[0] for rk in (0, 1)]
    for s in range(3):
        np.testing.assert_array_equal(
            np.concatenate([halves[0][s]["tokens"], halves[1][s]["tokens"]]),
            ref[s]["tokens"])


def test_streaming_loader_requires_a_mode_and_refuses_a_mesh(tmp_path):
    d = _write_shards(str(tmp_path))
    r = tdata.ShardedRecordReader(d, 8)
    with pytest.raises(MXNetError, match="transform"):
        tdata.StreamingLoader(r, ctx=CPU)
    with pytest.raises(MXNetError, match="tokenize"):
        tdata.StreamingLoader(r, packer=tdata.SequencePacker(2, 8), ctx=CPU)
    with pytest.raises(MXNetError, match="DeviceMesh"):
        tdata.StreamingLoader(r, transform=_decode, mesh=object(), ctx=CPU)


def test_elastic_resize_2_1_2_replays_the_training(tmp_path):
    """A linear model trained 2 steps at world 2, 2 at world 1, 2 at world
    2 (each segment a new loader at its start step; the ranks' gradients
    summed as an all-reduce would) ends where the world-1 run ends."""
    d = _write_shards(str(tmp_path), n_shards=2, per_shard=32)

    def make_net():
        net = nn.Dense(1, in_units=5, use_bias=False)
        net.initialize(tmx.init.Constant(0.01), ctx=CPU)
        net.weight.grad_req = "add"
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1e-4})
        return net, tr

    def train(net, tr, world, start, n):
        loaders = [tdata.StreamingLoader(
            tdata.ShardedRecordReader(d, 8, seed=11), transform=_decode,
            num_workers=1, start_step=start, num_steps=n, world_size=world,
            rank=rk, ctx=CPU) for rk in range(world)]
        losses = []
        for _ in range(n):
            net.weight.zero_grad()
            total = 0.0
            for ld in loaders:
                x = ld.get(timeout=60)
                with tautograd.record():
                    loss = (net(x) ** 2).sum()
                loss.backward()
                total += float(loss.asscalar())
            tr.step(8)
            losses.append(total)
        for ld in loaders:
            ld.close()
        return losses

    net1, tr1 = make_net()
    oracle = train(net1, tr1, 1, 0, 6)
    net, tr = make_net()
    resized = train(net, tr, 2, 0, 2) + train(net, tr, 1, 2, 2) + \
        train(net, tr, 2, 4, 2)
    np.testing.assert_allclose(resized, oracle, rtol=1e-5)
    np.testing.assert_allclose(net.weight.data().asnumpy(),
                               net1.weight.data().asnumpy(), rtol=1e-5)


# --- prefetcher --------------------------------------------------------------

def test_prefetcher_orders_batches_and_keeps_stats():
    batches = [np.full((4, 3), i, np.float32) for i in range(5)]
    with tdata.DevicePrefetcher(iter(batches), depth=2, ctx=CPU) as p:
        got = [p.get(timeout=30) for _ in range(5)]
        with pytest.raises(StopIteration):
            p.get(timeout=30)
    for i, g in enumerate(got):
        assert isinstance(g, tmx.NDArray) and g.context == CPU
        np.testing.assert_array_equal(g.asnumpy(), batches[i])
    st = p.stats()
    assert st["batches"] == 6 and len(st["depth_samples"]) == 6
    assert 0.0 <= st["wait_ms_p50"] <= st["wait_ms_p99"]
    with pytest.raises(MXNetError, match="closed"):
        p.get()


def test_prefetcher_carries_pytrees_and_packed_batches():
    pb, _ = tdata.pack_documents([np.arange(1, 9)], 2, 8)
    src = [{"x": np.ones(3, np.float32), "y": (np.zeros(2), [np.arange(4)])},
           pb]
    with tdata.DevicePrefetcher(src, ctx=CPU) as p:
        a, b = p.get(timeout=30), p.get(timeout=30)
    assert a["x"].shape == (3,) and a["y"][1][0].asnumpy().tolist() == \
        [0, 1, 2, 3]
    assert isinstance(b, tdata.PackedBatch)
    np.testing.assert_array_equal(b.segment_ids.asnumpy(), pb.segment_ids)


def test_prefetcher_propagates_source_errors():
    def bad_source():
        yield np.zeros((2, 2), np.float32)
        raise RuntimeError("decode exploded")

    with tdata.DevicePrefetcher(bad_source(), depth=2, ctx=CPU) as p:
        p.get(timeout=30)
        with pytest.raises(RuntimeError, match="decode exploded"):
            p.get(timeout=30)


def test_prefetcher_close_stops_an_endless_source():
    def endless():
        i = 0
        while True:
            yield np.full(2, i, np.float32)
            i += 1

    p = tdata.DevicePrefetcher(endless(), depth=2, ctx=CPU)
    assert p.get(timeout=30).asnumpy().tolist() == [0.0, 0.0]
    p.close()
    assert not p._thread.is_alive()


def test_prefetcher_refuses_a_mesh():
    with pytest.raises(MXNetError, match="DeviceMesh"):
        tdata.DevicePrefetcher([], mesh=object(), ctx=CPU)
    with pytest.raises(MXNetError, match="depth"):
        tdata.DevicePrefetcher([], depth=0, ctx=CPU)


def test_trainer_samples_the_attached_prefetcher():
    net = nn.Dense(2, in_units=3)
    net.initialize(ctx=CPU)
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    src = [np.ones((4, 3), np.float32) for _ in range(3)]
    p = tdata.DevicePrefetcher(src, depth=2, ctx=CPU)
    tr.attach_data_prefetcher(p)
    for _ in range(3):
        x = p.get(timeout=30)
        with tautograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(4)
    st = tr.stats()
    assert st["data_prefetch_depth_samples"] == 3
    assert 0.0 <= st["data_prefetch_depth_mean"] <= 2.0
    p.close()


def test_fused_train_step_replays_each_calls_batch():
    """A captured step replays on static inputs: each call copies its own
    batch there first (before this was fixed, every later call replayed
    the first call's batch).  The graph is a stand-in recording what it
    reads; no card is needed."""
    net = nn.Dense(1, in_units=3)
    net.initialize(ctx=CPU)
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    step = tmx.gluon.FusedTrainStep(net, tr, lambda n, x: n(x) ** 2,
                                    steps_per_execution=2)
    statics = [torch.zeros(4, 3)]
    seen = []

    class Graph:
        outputs = [torch.zeros(())]

        def replay(self):
            seen.append(statics[0].clone())

    class Plan:
        def write(self, items, optzr):
            pass

    step._graphs["sig"] = {"graph": Graph(), "plan": Plan(),
                           "scalars": None, "inputs": statics, "items": [],
                           "ptrs": step._addresses()}
    for v in (1.0, 2.0):
        batch = tmx.nd.array(np.full((4, 3), v, np.float32), ctx=CPU)
        step._run_graph("sig", [batch], (False,), [0.1], [0.0], [1],
                        torch.device("cpu"))
        assert len(seen) == 2 and all(torch.equal(s, batch._data)
                                      for s in seen)
        seen.clear()

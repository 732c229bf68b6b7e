"""Sharded checkpoints and the drain consensus of the port on four ranks
(gloo on the CPU), against the JAX package.

``llama_tiny`` (f32, four kv heads) is built in the reference with
Xavier weights, which cross to the port as numpy arrays by structural
name.  One gloo group of
four ranks takes one SGD step with the weights placed by ``LLAMA_RULES``
over ``{'dp': 2, 'tp': 2}`` (the ``dist_sync`` store), saves
``save_checkpoint(sharded=True)``, and resumes it into fresh nets placed
on ``{'tp': 4}``, on ``{'dp': 4}`` and on no mesh: the restored weights
equal the saved ones bit for bit, and each resumed net's next step
matches the reference's second step on its own dp2×tp2 mesh (losses rtol
1e-5, weights rtol 1e-5 and atol 1e-6).  A net of another structure
raises, and ``drain_consensus`` agrees on every rank when one of the
four asked to drain.  The reference runs in the pytest process while the
ranks run.
"""
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import spawn  # noqa: E402

B, T, V = 4, 16, 256
IDS = np.random.RandomState(0).randint(0, V, (B, T)).astype(np.int32)
LAB = np.random.RandomState(1).randint(0, V, (B, T)).astype(np.float32)
LR = 0.5
CFG = dict(num_kv_heads=4)  # four kv heads, so that tp=4 divides them
MESHES = {"tp4": {"tp": 4}, "dp4": {"dp": 4}, "none": None}


def _step(mx, net, trainer, ids, lab):
    with mx.autograd.record():
        loss = mx.nd.softmax_cross_entropy(
            net(ids).reshape((-1, V)), lab.reshape((-1,))) / (B * T)
    loss.backward()
    trainer.step(1)
    return float(loss.asscalar())


def _worker(tmp):
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import checkpoint, gluon, nd, parallel
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.gluon import trainer as trainer_mod
    from mxnet_tpu_torch.models import llama

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    w = dict(np.load(tmp / "weights.npz"))
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)
    r = parallel.rank()
    out = {}

    def net_on(shape, **kw):
        net = llama.llama_tiny(**{**CFG, **kw})
        load_numpy_params(net, w, ctx=cpu)
        if shape is None:
            return net, gluon.Trainer(net.collect_params(), "sgd",
                                      {"learning_rate": LR}), None
        mesh = parallel.make_mesh(shape)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": LR}, kvstore="dist_sync",
                           partition_rules=parallel.LLAMA_RULES, mesh=mesh)
        return net, tr, mesh

    def batch(mesh):
        ids = nd.array(IDS, ctx=cpu, dtype="int32")
        lab = nd.array(LAB, ctx=cpu)
        if mesh is None or "dp" not in parallel.mesh_axes(mesh):
            return ids, lab
        return parallel.shard_batch(ids, mesh), parallel.shard_batch(lab,
                                                                     mesh)

    def weights_of(net):
        return {k: p.data().asnumpy()
                for k, p in net._collect_params_with_prefix().items()}

    ckpt = str(tmp / "ckpt")
    net, tr, mesh = net_on({"dp": 2, "tp": 2})
    out["step1.loss"] = _step(tmx, net, tr, *batch(mesh))
    saved = weights_of(net)
    path = checkpoint.save_checkpoint(ckpt, 1, net, tr, sharded=True,
                                      extra={"epoch": 3})
    out["path"] = path
    for name, shape in MESHES.items():
        net, tr, mesh = net_on(shape)
        step, extra = checkpoint.resume(ckpt, net, tr)
        out[name + ".step"] = step
        out[name + ".extra"] = json.dumps(extra)
        got = weights_of(net)
        out[name + ".exact"] = all(np.array_equal(got[k], saved[k])
                                   for k in saved)
        out[name + ".loss"] = _step(tmx, net, tr, *batch(mesh))
        for k, v in weights_of(net).items():
            out[f"{name}.{k}"] = v
    net = llama.llama_tiny(num_layers=1, **CFG)
    net.initialize(ctx=cpu)
    try:
        checkpoint.resume(ckpt, net)
        out["mismatch"] = ""
    except tmx.MXNetError as e:
        out["mismatch"] = str(e)
    out["drain.before"] = trainer_mod.drain_consensus()
    if r == 2:
        trainer_mod.request_drain()
    out["drain.after"] = trainer_mod.drain_consensus()
    out["drain.local"] = trainer_mod.drain_requested()
    parallel.set_mesh(None)
    np.savez(tmp / f"rank{r}.npz", **out)


@pytest.fixture(scope="module")
def weights():
    import mxnet_tpu as jmx
    from mxnet_tpu.models import llama as jllama

    net = jllama.llama_tiny(**CFG)
    net.initialize(jmx.init.Xavier())
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("checkpoint_sharded")
    np.savez(tmp / "weights.npz", **weights)
    return spawn(4, tmp, __file__, timeout=240, background=True), tmp


@pytest.fixture(scope="module")
def ref(weights, ranks):
    """Two SGD steps of the reference on its dp2×tp2 virtual mesh."""
    import mxnet_tpu as jmx
    from mxnet_tpu import nd as jnd, parallel as jpar
    from mxnet_tpu.models import llama as jllama

    mesh = jpar.make_mesh({"dp": 2, "tp": 2})
    try:
        net = jllama.llama_tiny(**CFG)
        net.initialize()
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(jnd.array(weights[k]))
        tr = jmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": LR},
                               partition_rules=jpar.LLAMA_RULES, mesh=mesh)
        ids = jpar.shard_batch(jnd.array(IDS, dtype="int32"), mesh)
        lab = jpar.shard_batch(jnd.array(LAB), mesh)
        losses = [_step(jmx, net, tr, ids, lab) for _ in range(2)]
        return {"losses": losses,
                "weights": {k: p.data().asnumpy() for k, p in
                            net._collect_params_with_prefix().items()}}
    finally:
        jpar.set_mesh(None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_checkpoint_restores_onto_another_mesh(ranks, ref, mesh):
    for out in ranks[0].result():
        np.testing.assert_allclose(out["step1.loss"], ref["losses"][0],
                                   rtol=1e-5)
        assert int(out[mesh + ".step"]) == 1
        assert json.loads(str(out[mesh + ".extra"])) == {"epoch": 3}
        assert bool(out[mesh + ".exact"])
        np.testing.assert_allclose(out[mesh + ".loss"], ref["losses"][1],
                                   rtol=1e-5)
        for k, v in ref["weights"].items():
            np.testing.assert_allclose(out[f"{mesh}.{k}"], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_sharded_layout_writes_each_piece_once(ranks):
    results = ranks[0].result()
    path = str(results[0]["path"])
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["sharded"] and manifest["world_size"] == 4
    q = manifest["params"]["model.layers.0.self_attn.q_proj.weight"]
    assert q["mesh"] == {"dp": 2, "tp": 2}
    assert [p[0] for p in q["pieces"]] == [0, 1]     # tp halves, dp once
    assert [p[1] for p in q["pieces"]] == [[0, 0], [q["shape"][0] // 2, 0]]
    norm = manifest["params"]["model.norm.weight"]
    assert [p[0] for p in norm["pieces"]] == [0]     # replicated: once
    assert sorted(os.listdir(os.path.join(path, "shards"))) == [
        "rank0.pt", "rank1.pt", "rank2.pt", "rank3.pt"]
    assert os.path.exists(os.path.join(path, "trainer.states"))
    assert not any(n.startswith(".tmp-")
                   for n in os.listdir(os.path.dirname(path)))


def test_mismatched_structure_raises(ranks):
    for out in ranks[0].result():
        assert "does not match this model's parameter structure" in \
            str(out["mismatch"])


def test_drain_consensus_agrees_when_one_rank_drains(ranks):
    results = ranks[0].result()
    for r, out in enumerate(results):
        assert not bool(out["drain.before"])
        assert bool(out["drain.after"])
        assert bool(out["drain.local"]) == (r == 2)


def test_a_reference_orbax_checkpoint_raises_saying_why(tmp_path):
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.models import llama

    path = tmp_path / "ckpt-5"
    (path / "model.orbax").mkdir(parents=True)
    (path / "manifest.json").write_text(json.dumps(
        {"step": 5, "has_trainer": False, "sharded": True, "extra": {}}))
    net = llama.llama_tiny(num_layers=1)
    net.initialize(ctx=tmx.cpu())
    with pytest.raises(tmx.MXNetError, match="orbax"):
        checkpoint.resume(str(tmp_path), net)


def test_sharded_checkpoint_in_one_process_round_trips(tmp_path):
    """One process, no mesh: ``save_checkpoint(sharded=True)`` and the
    asynchronous writer, each resumed bit for bit."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.models import llama

    def net_of(seed):
        tmx.random.seed(seed)
        net = llama.llama_tiny(num_layers=1)
        net.initialize(ctx=tmx.cpu())
        return net

    src = net_of(0)
    want = {k: p.data().asnumpy()
            for k, p in src._collect_params_with_prefix().items()}
    checkpoint.save_checkpoint(str(tmp_path / "a"), 2, src, sharded=True)
    checkpoint.save_checkpoint_async(str(tmp_path / "b"), 3, src,
                                     sharded=True).result(60)
    for sub, step in (("a", 2), ("b", 3)):
        dst = net_of(1)
        assert checkpoint.resume(str(tmp_path / sub), dst)[0] == step
        for k, p in dst._collect_params_with_prefix().items():
            np.testing.assert_array_equal(p.data().asnumpy(), want[k])


if __name__ == "__main__":
    _worker(sys.argv[1])

"""``FusedTrainStep`` and ``hybridize()`` of the port over a dp2×tp2 mesh
(four gloo ranks on the CPU) against ``Trainer.step``, the eager forward
and the JAX package.

``llama_tiny`` (f32) is built in the reference with Xavier weights, which
cross to the port as numpy arrays by structural name.  Each rank runs,
with the weights placed by ``LLAMA_RULES`` over ``{'dp': 2, 'tp': 2}``:

  * two ``Trainer.step`` calls through the ``dist_sync`` store;
  * ``FusedTrainStep`` (K=2) through the ``dist_sync`` store, and through
    the mesh alone (the Trainer's local store): the step's collectives
    (the store's all-reduce, the ``Partial`` sums) run inside each step;
  * a hybridized forward of the placed net against its eager forward.

gloo collectives cannot be captured, so on the CPU these run eagerly, as
every CPU call does; the captured route is the card's
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` 19b).  The
reference runs ``FusedTrainStep`` over its own dp2×tp2 virtual mesh
meanwhile.  Losses and outputs within rtol 1e-5, weights rtol 1e-5 and
atol 1e-6, as ``test_torch_llama_parallel.py``.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import spawn  # noqa: E402

B, T, V, K = 4, 16, 256, 2
IDS = np.random.RandomState(0).randint(0, V, (B, T)).astype(np.int32)
LAB = np.random.RandomState(1).randint(0, V, (B, T)).astype(np.float32)
LR = 0.5


def _loss(mx, net, ids, lab):
    return mx.nd.softmax_cross_entropy(net(ids).reshape((-1, V)),
                                       lab.reshape((-1,))) / (B * T)


def _worker(tmp):
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import autograd, gluon, nd, parallel
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.models import llama

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    w = dict(np.load(tmp / "weights.npz"))
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)
    mesh = parallel.make_mesh({"dp": 2, "tp": 2})

    def placed(kvstore):
        net = llama.llama_tiny()
        load_numpy_params(net, w, ctx=cpu)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": LR}, kvstore=kvstore,
                           partition_rules=parallel.LLAMA_RULES, mesh=mesh)
        return net, tr

    ids = parallel.shard_batch(nd.array(IDS, ctx=cpu, dtype="int32"), mesh)
    lab = parallel.shard_batch(nd.array(LAB, ctx=cpu), mesh)
    out = {}
    net, tr = placed("dist_sync")
    losses = []
    for _ in range(K):
        with autograd.record():
            loss = _loss(tmx, net, ids, lab)
        loss.backward()
        tr.step(1)
        losses.append(float(loss.asscalar()))
    out["eager.losses"] = np.array(losses)
    for k, p in net._collect_params_with_prefix().items():
        out["eager." + k] = p.data().asnumpy()
    for route, kv in (("fused", "dist_sync"), ("fused_mesh", "device")):
        net, tr = placed(kv)
        step = gluon.FusedTrainStep(
            net, tr, lambda n, x, y: _loss(tmx, n, x, y),
            steps_per_execution=K, batch_size=1)
        out[route + ".losses"] = step(ids, lab).asnumpy()
        for k, p in net._collect_params_with_prefix().items():
            out[f"{route}.{k}"] = p.data().asnumpy()
    net, _ = placed("device")
    out["eager.logits"] = net(ids).asnumpy()
    net.hybridize()
    out["hybrid.logits"] = net(ids).asnumpy()
    out["hybrid.stats"] = str(net.cache_stats())
    parallel.set_mesh(None)
    np.savez(tmp / f"rank{parallel.rank()}.npz", **out)


@pytest.fixture(scope="module")
def weights():
    import mxnet_tpu as jmx
    from mxnet_tpu.models import llama as jllama

    net = jllama.llama_tiny()
    net.initialize(jmx.init.Xavier())
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("graph_mesh")
    np.savez(tmp / "weights.npz", **weights)
    return spawn(4, tmp, __file__, timeout=240, background=True)


@pytest.fixture(scope="module")
def ref(weights, ranks):
    """The reference's ``FusedTrainStep`` (K=2) over its dp2×tp2 virtual
    mesh and its forward there, from the same weights."""
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jg, nd as jnd, parallel as jpar
    from mxnet_tpu.models import llama as jllama

    mesh = jpar.make_mesh({"dp": 2, "tp": 2})
    try:
        net = jllama.llama_tiny()
        net.initialize()
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(jnd.array(weights[k]))
        tr = jg.Trainer(net.collect_params(), "sgd", {"learning_rate": LR},
                        partition_rules=jpar.LLAMA_RULES, mesh=mesh)
        ids = jpar.shard_batch(jnd.array(IDS, dtype="int32"), mesh)
        lab = jpar.shard_batch(jnd.array(LAB), mesh)
        logits = net(ids).asnumpy()
        step = jg.FusedTrainStep(net, tr,
                                 lambda n, x, y: _loss(jmx, n, x, y),
                                 steps_per_execution=K, batch_size=1)
        losses = step(ids, lab).asnumpy()
        return {"logits": logits, "losses": losses,
                "weights": {k: p.data().asnumpy() for k, p in
                            net._collect_params_with_prefix().items()}}
    finally:
        jpar.set_mesh(None)


@pytest.mark.parametrize("route", ["fused", "fused_mesh"])
def test_fused_step_over_a_mesh_matches_trainer_step_and_reference(
        ranks, ref, route):
    for out in ranks.result():
        np.testing.assert_allclose(out[route + ".losses"],
                                   out["eager.losses"], rtol=1e-5)
        np.testing.assert_allclose(out[route + ".losses"], ref["losses"],
                                   rtol=1e-5)
        for k, v in ref["weights"].items():
            np.testing.assert_allclose(out[f"{route}.{k}"],
                                       out["eager." + k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(out[f"{route}.{k}"], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_hybridized_forward_over_a_mesh_matches_eager_and_reference(
        ranks, ref):
    for out in ranks.result():
        np.testing.assert_allclose(out["hybrid.logits"], out["eager.logits"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["hybrid.logits"], ref["logits"],
                                   rtol=1e-5, atol=1e-5)
        assert "'misses': 1" in str(out["hybrid.stats"])


if __name__ == "__main__":
    _worker(sys.argv[1])

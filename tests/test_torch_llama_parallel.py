"""Tensor- and sequence-parallel Llama of the port on four ranks (gloo on
the CPU) against the JAX package.

``llama_tiny`` (f32) is built in the reference with Xavier weights, which
cross to the port as numpy arrays by structural name
(``convert.load_numpy_params``).  One gloo group of four ranks
(``mxnet_tpu_torch.launch.run``) then runs:

  * one SGD step on one device, and one at dp2×tp2 through
    ``Trainer(partition_rules=LLAMA_RULES, mesh={'dp': 2, 'tp': 2},
    kvstore='dist_sync')``, both held to the reference's dp×tp step on
    its virtual mesh and to its single-device step (losses and updated
    weights, rtol 1e-5);
  * the forward with ``attn_mode="ring"`` and ``"ulysses"`` over an
    ``{'sp': 4}`` mesh (the sequence sharded), held to the flash route.

The reference side runs in the pytest process while the ranks run.
"""
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


def _step(mx, net, trainer, ids, lab):
    with mx.autograd.record():
        logits = net(ids)
        loss = mx.nd.softmax_cross_entropy(logits.reshape((-1, V)),
                                           lab.reshape((-1,))) / (B * T)
    loss.backward()
    trainer.step(1)
    return float(loss.asscalar())


def _worker(tmp):
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import nd, parallel
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.models import llama

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    w = dict(np.load(tmp / "weights.npz"))
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)

    def net_of(**kw):
        net = llama.llama_tiny(**kw)
        load_numpy_params(net, w, ctx=cpu)
        return net

    out = {}
    ids, lab = nd.array(IDS, ctx=cpu, dtype="int32"), nd.array(LAB, ctx=cpu)
    net = net_of()
    out["flash.logits"] = net(ids).asnumpy()
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": LR})
    out["single.loss"] = _step(tmx, net, tr, ids, lab)
    for k, p in net._collect_params_with_prefix().items():
        out["single." + k] = p.data().asnumpy()

    mesh = parallel.make_mesh({"dp": 2, "tp": 2})
    net = net_of()
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": LR}, kvstore="dist_sync",
                           partition_rules=parallel.LLAMA_RULES, mesh=mesh)
    out["tp.sharded"] = tr.placement.summary()["sharded_params"]
    out["tp.loss"] = _step(tmx, net, tr, parallel.shard_batch(ids, mesh),
                           parallel.shard_batch(lab, mesh))
    for k, p in net._collect_params_with_prefix().items():
        out["tp." + k] = p.data().asnumpy()
    parallel.set_mesh(None)

    sp = parallel.make_mesh({"sp": 4})
    for mode in ("ring", "ulysses"):
        net = net_of(attn_mode=mode)
        llama.shard_llama(net, sp)
        x = parallel.shard_batch(ids, sp, axis=1, axis_name="sp")
        out[mode + ".logits"] = net(x).asnumpy()
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
    tmp = tmp_path_factory.mktemp("llama_parallel")
    np.savez(tmp / "weights.npz", **weights)
    return spawn(4, tmp, __file__, timeout=240, background=True)


@pytest.fixture(scope="module")
def ref(weights, ranks):
    """The reference's flash forward, single-device step and dp×tp step
    on its virtual mesh, from the same weights."""
    import mxnet_tpu as jmx
    from mxnet_tpu import nd as jnd, parallel as jpar
    from mxnet_tpu.models import llama as jllama

    def net_of():
        net = jllama.llama_tiny()
        net.initialize()
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(jnd.array(weights[k]))
        return net

    out = {}
    ids, lab = jnd.array(IDS, dtype="int32"), jnd.array(LAB)
    net = net_of()
    out["flash.logits"] = net(ids).asnumpy()
    tr = jmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": LR})
    out["single.loss"] = _step(jmx, net, tr, ids, lab)
    out["single"] = {k: p.data().asnumpy() for k, p in
                     net._collect_params_with_prefix().items()}
    mesh = jpar.make_mesh({"dp": 2, "tp": 2})
    try:
        net = net_of()
        tr = jmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": LR},
                               partition_rules=jpar.LLAMA_RULES, mesh=mesh)
        out["tp.loss"] = _step(jmx, net, tr, jpar.shard_batch(ids, mesh),
                               jpar.shard_batch(lab, mesh))
        out["tp"] = {k: p.data().asnumpy() for k, p in
                     net._collect_params_with_prefix().items()}
    finally:
        jpar.set_mesh(None)
    return out


def test_dp_tp_training_step_matches_the_reference(ranks, ref):
    for out in ranks.result():
        assert int(out["tp.sharded"]) > 0
        for route in ("single", "tp"):
            for want in (ref["tp.loss"], ref["single.loss"]):
                np.testing.assert_allclose(out[route + ".loss"], want,
                                           rtol=1e-5)
            for k, v in ref["single"].items():
                np.testing.assert_allclose(out[f"{route}.{k}"], v,
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{route} {k}")
                np.testing.assert_allclose(out[f"{route}.{k}"],
                                           ref["tp"][k], rtol=1e-5,
                                           atol=1e-6, err_msg=f"{route} {k}")


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sequence_parallel_forward_matches_flash(ranks, ref, mode):
    for out in ranks.result():
        np.testing.assert_allclose(out[mode + ".logits"],
                                   out["flash.logits"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out[mode + ".logits"],
                                   ref["flash.logits"], rtol=1e-5,
                                   atol=1e-5)


if __name__ == "__main__":
    _worker(sys.argv[1])

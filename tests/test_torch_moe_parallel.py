"""Expert-parallel Mixtral of the port on four ranks (gloo on the CPU)
against the JAX package on its virtual mesh.

``mixtral_tiny`` (f32, 4 experts) is built in the reference with Xavier
weights, which cross to the port as numpy arrays by structural name.
One gloo group of four ranks (``mxnet_tpu_torch.launch.run``) runs, on
``{'dp': 2, 'ep': 2}`` (the batch split over dp, two experts a rank) and
on ``{'ep': 2, 'tp': 2}`` (each expert's columns split over tp too; the
expert_choice router, the reference's ``test_llama.py`` mesh case
without ``scan_layers``); the first with the topk router:

  * three SGD-momentum steps of cross entropy + 0.01·Σaux through
    ``Trainer(partition_rules=MIXTRAL_RULES, mesh=, kvstore='dist_sync')``:
    the first step's logits, aux losses and the gradients of every
    parameter, the losses, and the weights after;
  * two greedy tokens of the oracle ``generate`` over ``shard_llama``;

each held to the reference's run on the same virtual mesh (the tokens to
its unsharded run's, which GSPMD's equal).  Tolerances (f32, other
summation orders): logits and aux within 1e-5 of the largest value,
gradients within 1e-4 of the largest gradient of the same tensor, losses
rtol 1e-5, weights rtol 1e-5 and atol 1e-6; tokens exactly equal.  The
momentum state of a sharded weight is laid out as the weight (a fault
repaired with this file).  The reference runs in the pytest process
while the ranks run.
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
MESHES = {"dp2ep2": {"dp": 2, "ep": 2}, "ep2tp2": {"ep": 2, "tp": 2}}
ROUTERS = {"dp2ep2": "topk", "ep2tp2": "expert_choice"}


def _split(mx, parallel, a, mesh, shape, **kw):
    """A fresh NDArray of ``a``: split over dp where the mesh has it,
    replicated over a mesh without dp, as it is without a mesh."""
    x = mx.nd.array(a, dtype=a.dtype.name, **kw)
    if shape is None:
        return x
    if "dp" in shape:
        return parallel.shard_batch(x, mesh)
    return parallel.replicate(x, mesh)


def _train(mx, ag, moe, net, trainer, ids, lab):
    """Three steps of cross entropy + 0.01·Σaux → (the first step's
    logits, aux losses and gradients, the losses, the weights after)."""
    losses = []
    for step in range(3):
        with moe.collect_aux() as aux:
            with ag.record():
                logits = net(ids)
                loss = mx.nd.softmax_cross_entropy(
                    logits.reshape((-1, V)), lab.reshape((-1,))) \
                    / (B * T) + 0.01 * sum(aux)
        loss.backward()
        if step == 0:
            first = (logits.asnumpy(), [float(a.asscalar()) for a in aux],
                     {k: p.grad().asnumpy() for k, p in
                      net._collect_params_with_prefix().items()})
        trainer.step(1)
        losses.append(float(loss.asscalar()))
    return first + (losses, {k: p.data().asnumpy() for k, p in
                             net._collect_params_with_prefix().items()})


def _worker(tmp):
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import autograd, nd, parallel
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.models import llama, moe

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    w = dict(np.load(tmp / "weights.npz"))
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)

    def net_of(router):
        net = llama.mixtral_tiny(moe_router=router)
        load_numpy_params(net, w, ctx=cpu)
        return net

    out = {}
    for name, shape in MESHES.items():
        mesh = parallel.make_mesh(shape)
        net = net_of(ROUTERS[name])
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               kvstore="dist_sync",
                               partition_rules=parallel.MIXTRAL_RULES,
                               mesh=mesh)
        out[name + ".sharded"] = tr.placement.summary()["sharded_params"]
        out[name + ".bank_placements"] = str(
            net.model.layers[0].mlp.gate_weight.data()._data.placements)
        got = _train(tmx, autograd, moe, net, tr,
                     _split(tmx, parallel, IDS, mesh, shape, ctx=cpu),
                     _split(tmx, parallel, LAB, mesh, shape, ctx=cpu))
        out[name + ".logits"], out[name + ".aux"] = got[0], np.array(got[1])
        for k, g in got[2].items():
            out[f"{name}.grad.{k}"] = g
        out[name + ".losses"] = np.array(got[3])
        for k, v in got[4].items():
            out[f"{name}.w.{k}"] = v
        parallel.set_mesh(None)

        net = net_of(ROUTERS[name])
        llama.shard_llama(net, mesh)
        ids = _split(tmx, parallel, IDS[:, :6], mesh, shape, ctx=cpu)
        out[name + ".gen"] = net.generate(ids, max_new_tokens=2).asnumpy()
        parallel.set_mesh(None)
    np.savez(tmp / f"rank{parallel.rank()}.npz", **out)


@pytest.fixture(scope="module")
def weights():
    import mxnet_tpu as jmx
    from mxnet_tpu.models import llama as jllama

    jmx.random.seed(5)
    net = jllama.mixtral_tiny()
    net.initialize(jmx.init.Xavier())
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_parallel")
    np.savez(tmp / "weights.npz", **weights)
    return spawn(4, tmp, __file__, timeout=300, background=True)


@pytest.fixture(scope="module")
def ref(weights, ranks):
    """The reference's runs on each virtual mesh, and its unsharded
    greedy tokens."""
    import mxnet_tpu as jmx
    from mxnet_tpu import autograd as jag, nd as jnd, parallel as jpar
    from mxnet_tpu.models import llama as jllama, moe as jmoe

    def net_of(router):
        net = jllama.mixtral_tiny(moe_router=router)
        net.initialize()
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(jnd.array(weights[k]))
        return net

    out = {}
    for name, shape in MESHES.items():
        mesh = jpar.make_mesh(shape)
        try:
            net = net_of(ROUTERS[name])
            tr = jmx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9},
                                   partition_rules=jpar.MIXTRAL_RULES,
                                   mesh=mesh)
            out[name] = _train(jmx, jag, jmoe, net, tr,
                               _split(jmx, jpar, IDS, mesh, shape),
                               _split(jmx, jpar, LAB, mesh, shape))
        finally:
            jpar.set_mesh(None)
    # the reference's mesh generate is its unsharded one (GSPMD); the
    # unsharded tokens stand for both
    for router in sorted(set(ROUTERS.values())):
        out["gen." + router] = net_of(router).generate(
            jnd.array(IDS[:, :6], dtype="int32"), max_new_tokens=2) \
            .asnumpy()
    return out


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    assert np.abs(got - want).max() <= tol * scale, what


@pytest.mark.parametrize("name", sorted(MESHES))
def test_expert_parallel_forward_and_gradients_match(ranks, ref, name):
    for out in ranks.result():
        assert "Shard(dim=0)" in str(out[name + ".bank_placements"])
        want = ref[name]
        _close(out[name + ".logits"], want[0], 1e-5, "logits")
        np.testing.assert_allclose(out[name + ".aux"], want[1],
                                   rtol=1e-5, atol=1e-7)
        assert len(want[2]) == 23
        for k, g in want[2].items():
            _close(out[f"{name}.grad.{k}"], g, 1e-4, k)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_expert_parallel_trainer_steps_match(ranks, ref, name):
    for out in ranks.result():
        assert int(out[name + ".sharded"]) > 0
        want = ref[name]
        np.testing.assert_allclose(out[name + ".losses"], want[3],
                                   rtol=1e-5)
        for k, v in want[4].items():
            np.testing.assert_allclose(out[f"{name}.w.{k}"], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_expert_parallel_oracle_generate_matches(ranks, ref, name):
    for out in ranks.result():
        np.testing.assert_array_equal(out[name + ".gen"],
                                      ref["gen." + ROUTERS[name]])


if __name__ == "__main__":
    _worker(sys.argv[1])
